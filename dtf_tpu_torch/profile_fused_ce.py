"""Where the fused CE's time goes on the GPU: B5, B6 and B7 built with
one part of their work taken out at a time, and timed.

    python -m dtf_tpu_torch.profile_fused_ce

Copies ``ops/csrc/fused_ce.cu`` and ``hopper.cuh`` into
``build/dtf_tpu_torch/ablate/``, wraps the statements of each part in
``#ifndef`` guards (each guard's text must be found exactly once, or the
script stops: it follows the source, it does not guess), builds one
library per variant with ``nvcc`` (all at once), and times B5 (its parts,
without the merge), B6 (dX) and B7 (dW) of each at the training shape (N
8192, D 768, V 50304, f32; CUDA events around 3 launches after one
warm-up, inputs as ``chip_smoke.py`` makes them). A variant's results are
wrong by design; only its time is read. The difference to ``base`` is
what the removed part costs where it does not overlap the rest. B5:

- ``fwd_no_products``: the wgmma of the logits;
- ``fwd_no_softmax``: the online logsumexp and the target pick (one
  logit is kept, or ptxas drops the products whose results nothing
  reads);
- ``fwd_no_split``: the owned x's split into tf32 hi/lo A fragments (its
  shared-memory reads stay);
- ``fwd_bs128`` / ``fwd_bs256``: B5 whole, with 128 or 256 vocab rows a
  block (4 or 2 ring slots) instead of 192 (3 slots); at 256 the
  registers spill;
- ``fwd_flush1`` / ``fwd_flush4`` / ``fwd_no_flush``: B5 whole, its
  tensor-core partial sums added into the logits in IEEE f32 every 1 or 4
  chunks of D, or never, instead of every 2.

For every variant it also prints B5's registers and spill bytes (ptxas)
and its largest lse and tgt error (with the merge) against
``fused_ce_fwd_reference`` at larger logits (W std 0.2): what the
accumulation choices cost in accuracy.

B6 and B7:

- ``no_sync``: the cluster barrier of the partial-logits exchange;
- ``no_loads``: the exchange's reads of the other CTAs' partials (DSMEM);
- ``no_exchange``: both;
- ``no_exp``: the exponential of the dlogits;
- ``no_recompute`` / ``no_accumulate``: the wgmma of the logits
  recompute / of the accumulate product;
- ``no_products``: both products (what is left is the data flow: TMA
  tiles, barriers, exchange, dlogits);
- ``products_only``: neither the exchange nor the exponential nor the
  owned rows' split into A fragments.

Prints one line per variant and one JSON line with the card's name and
power limit. Needs a GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

#: (guard macro, the text of fused_ce.cu it takes out)
GUARDS = (
    ("NO_FWD_PRODUCTS",
     "        wgmma_tf32_rs(acc, gh, bh, kk != 0 || !fresh);\n"
     "        wgmma_tf32_rs(acc, gh, bl, 1);\n"
     "        wgmma_tf32_rs(acc, gl, bh, 1);\n"),
    ("NO_FWD_SPLIT",
     "          split_tf32(lds(at), gh[2 * half], gl[2 * half]);\n"
     "          split_tf32(lds(at + 8 * 128), gh[2 * half + 1], "
     "gl[2 * half + 1]);\n"),
    ("NO_RECOMPUTE",
     "      wgmma_tf32_rs(s, gh, bh, grp != 0);\n"
     "      wgmma_tf32_rs(s, gh, bl, 1);\n"
     "      wgmma_tf32_rs(s, gl, bh, 1);\n"),
    ("NO_SPLIT_A",
     "        split_tf32(lds(off), gh[2 * half], gl[2 * half]);\n"
     "        split_tf32(lds(off + 8 * 128), gh[2 * half + 1], "
     "gl[2 * half + 1]);\n"),
    ("NO_SYNC", "    cluster_sync();\n"),
    ("NO_LOADS",
     "#pragma unroll\n        for (int r = 1; r < C; ++r) {\n"
     "          const float4 u = ld_cluster_v4(mapa(mine + e4 * 2048, r));\n"
     "          v.x += u.x;\n          v.y += u.y;\n          v.z += u.z;\n"
     "          v.w += u.w;\n        }\n"),
    ("NO_EXP",
     "          const float p = live ? exp2f(fmaf(s[e], LOG2E, -l_ * LOG2E)) "
     ": 0.f;\n"),
    ("NO_ACCUMULATE",
     "        wgmma_tf32_rs(acc, dh[j], sw128_desc(th + 32 * kk), 1);\n"
     "        wgmma_tf32_rs(acc, dh[j], sw128_desc(tl + 32 * kk), 1);\n"
     "        wgmma_tf32_rs(acc, dlo[j], sw128_desc(th + 32 * kk), 1);\n"),
)

#: (guard macro, the first line it takes out, the text it stops before,
#: its stand-in): B5's online logsumexp and target pick, a span too long
#: to spell out
SPANS = (
    ("NO_FWD_SOFTMAX", "    const bool all_live = v0 + BS <= V;\n",
     "  }\n\n  // This part's (m, l, tgt) per token",
     "    l[0] += s[0];\n"),
)

#: what a guard leaves in place of its text (a no-op of the same type)
STANDINS = {
    "NO_FWD_SPLIT":
        "          gh[2 * half] = gl[2 * half] = __float_as_uint(lds(at));\n"
        "          gh[2 * half + 1] = gl[2 * half + 1] =\n"
        "              __float_as_uint(lds(at + 8 * 128));\n",
    "NO_SPLIT_A": "        gh[2 * half] = gl[2 * half] = off;\n"
                  "        gh[2 * half + 1] = gl[2 * half + 1] = off;\n",
    "NO_EXP": "          const float p = live ? s[e] - l_ : 0.f;\n",
}

VARIANTS = {
    "base": (),
    "fwd_no_products": ("NO_FWD_PRODUCTS",),
    "fwd_no_softmax": ("NO_FWD_SOFTMAX",),
    "fwd_no_split": ("NO_FWD_SPLIT",),
    "fwd_bs128": ("DTF_CE_FWD_BS=128",),
    "fwd_bs256": ("DTF_CE_FWD_BS=256",),
    "fwd_flush1": ("DTF_CE_FWD_FLUSH=1",),
    "fwd_flush4": ("DTF_CE_FWD_FLUSH=4",),
    "fwd_no_flush": ("DTF_CE_FWD_FLUSH=1000",),
    "no_sync": ("NO_SYNC",),
    "no_loads": ("NO_LOADS",),
    "no_exchange": ("NO_SYNC", "NO_LOADS"),
    "no_exp": ("NO_EXP",),
    "no_recompute": ("NO_RECOMPUTE",),
    "no_accumulate": ("NO_ACCUMULATE",),
    "no_products": ("NO_RECOMPUTE", "NO_ACCUMULATE"),
    "products_only": ("NO_SYNC", "NO_LOADS", "NO_EXP", "NO_SPLIT_A"),
}


def guarded_source(text: str) -> str:
    """fused_ce.cu with every part of GUARDS and SPANS behind its macro."""
    for macro, first, stop, stand_in in SPANS:
        if text.count(first) != 1 or text.count(stop) != 1:
            raise RuntimeError(f"{macro}: its span is not found exactly once "
                               "in fused_ce.cu; update SPANS")
        a, b = text.index(first), text.index(stop)
        text = (f"{text[:a]}#ifndef {macro}\n{text[a:b]}\n#else\n"
                f"{stand_in}#endif\n{text[b:]}")
    for macro, part in GUARDS:
        if text.count(part) != 1:
            raise RuntimeError(f"{macro}: its text is not found exactly once "
                               "in fused_ce.cu; update GUARDS")
        stand_in = STANDINS.get(macro, "")
        text = text.replace(part, f"#ifndef {macro}\n{part}#else\n"
                                  f"{stand_in}#endif\n")
    return text


def fwd_registers(log: str) -> dict:
    """B5's registers and spill bytes from one build's ``-Xptxas -v``."""
    lines = log.splitlines()
    at = next(i for i, ln in enumerate(lines)
              if "entry function" in ln and "fused_ce_fwd_kernel" in ln)
    out = {}
    for ln in lines[at + 1:]:
        if "entry function" in ln:
            break
        if "spill stores" in ln:
            out["spill_store_bytes"] = int(ln.split("bytes spill stores")[0]
                                           .split(",")[-1])
        if "Used" in ln and "registers" in ln:
            out["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def main() -> int:
    import torch

    from dtf_tpu_torch.ops import _build
    from dtf_tpu_torch.ops import fused_ce as fc
    from dtf_tpu_torch.profile_train import card_line

    if not torch.cuda.is_available():
        raise SystemExit("profile_fused_ce: no CUDA device")
    out_dir = os.path.join(_build.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "fused_ce.cu")) as f:
        src = guarded_source(f.read())
    with open(os.path.join(out_dir, "fused_ce.cu"), "w") as f:
        f.write(src)
    with open(os.path.join(_build.CSRC_DIR, "hopper.cuh")) as f, \
            open(os.path.join(out_dir, "hopper.cuh"), "w") as g:
        g.write(f.read())
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
         *(f"-D{m}" for m in macros), "-o",
         os.path.join(out_dir, f"{name}.so"),
         os.path.join(out_dir, "fused_ce.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macros in VARIANTS.items()}
    regs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs[name] = fwd_registers(log)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(21)
    n, d, v = 8192, 768, 50304
    x = torch.randn(n, d, generator=gen, device="cuda")
    w = torch.randn(v, d, generator=gen, device="cuda") * 0.05
    labels = torch.randint(0, 50257, (n,), generator=gen,
                           device="cuda").to(torch.int32)
    labels[::97] = -100
    valid = (labels != -100).float()
    dce = valid / valid.sum()
    split = fc.fused_ce_split_cuda(x, w)
    lse, _ = fc.fused_ce_fwd_cuda(x, w, labels, split)
    w_big = w * 4.0                               # W std 0.2
    split_big = fc.fused_ce_split_cuda(x, w_big, for_fwd=True,
                                       for_dx=False, for_dw=False)
    want_big = fc.fused_ce_fwd_reference(x, w_big, labels)
    res = {}
    real_load = _build.load
    try:
        for name in VARIANTS:
            lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
            fc._lib = None
            _build.load = lambda _name, lib=lib: lib
            fc._kernel_lib()
            row = {}
            for key, fn in (
                    ("fused_ce_fwd", lambda: fc.fused_ce_fwd_parts_cuda(
                        x, w, labels, split)),
                    ("fused_ce_dx", lambda: fc.fused_ce_dx_cuda(
                        x, w, labels, lse, dce, split)),
                    ("fused_ce_dw", lambda: fc.fused_ce_dw_cuda(
                        x, w, labels, lse, dce, split))):
                fn()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    fn()
                stop.record()
                torch.cuda.synchronize()
                row[key] = start.elapsed_time(stop) / 3
            got = fc.fused_ce_fwd_cuda(x, w_big, labels, split_big)
            row["fwd_err_w0.2"] = max((a - b).abs().max().item()
                                      for a, b in zip(got, want_big))
            row["fwd_ptxas"] = regs[name]
            res[name] = row
            print(name, row, flush=True)
    finally:
        _build.load = real_load
        fc._lib = None
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": card_line(), "n": n, "d": d, "v": v,
                      "ms": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
