"""Where the fused CE backward's time goes on the GPU: B6 and B7 built
with one part of their work taken out at a time, and timed.

    python -m dtf_tpu_torch.profile_fused_ce

Copies ``ops/csrc/fused_ce.cu`` and ``hopper.cuh`` into
``build/dtf_tpu_torch/ablate/``, wraps the statements of each part in
``#ifndef`` guards (each guard's text must be found exactly once, or the
script stops: it follows the source, it does not guess), builds one
library per variant with ``nvcc`` (all at once), and times B6 (dX) and B7
(dW) of each at the training shape (N 8192, D 768, V 50304, f32; CUDA
events around 3 launches after one warm-up, inputs as ``chip_smoke.py``
makes them). A variant's results are wrong by design; only its time is
read. The difference to ``base`` is what the removed part costs where it
does not overlap the rest:

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

#: what a guard leaves in place of its text (a no-op of the same type)
STANDINS = {
    "NO_SPLIT_A": "        gh[2 * half] = gl[2 * half] = off;\n"
                  "        gh[2 * half + 1] = gl[2 * half + 1] = off;\n",
    "NO_EXP": "          const float p = live ? s[e] - l_ : 0.f;\n",
}

VARIANTS = {
    "base": (),
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
    """fused_ce.cu with every part of GUARDS behind its macro."""
    for macro, part in GUARDS:
        if text.count(part) != 1:
            raise RuntimeError(f"{macro}: its text is not found exactly once "
                               "in fused_ce.cu; update GUARDS")
        stand_in = STANDINS.get(macro, "")
        text = text.replace(part, f"#ifndef {macro}\n{part}#else\n"
                                  f"{stand_in}#endif\n")
    return text


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
        [_build.nvcc_path(), *_build.NVCC_FLAGS,
         *(f"-D{m}" for m in macros), "-o",
         os.path.join(out_dir, f"{name}.so"),
         os.path.join(out_dir, "fused_ce.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macros in VARIANTS.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")

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
    lse, _ = fc.fused_ce_fwd_cuda(x, w, labels)
    split = fc.fused_ce_split_cuda(x, w)
    res = {}
    real_load = _build.load
    try:
        for name in VARIANTS:
            lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
            fc._lib = None
            _build.load = lambda _name, lib=lib: lib
            fc._kernel_lib()
            row = {}
            for key, fn in (("fused_ce_dx", fc.fused_ce_dx_cuda),
                            ("fused_ce_dw", fc.fused_ce_dw_cuda)):
                fn(x, w, labels, lse, dce, split)
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    fn(x, w, labels, lse, dce, split)
                stop.record()
                torch.cuda.synchronize()
                row[key] = start.elapsed_time(stop) / 3
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
