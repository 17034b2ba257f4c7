#!/usr/bin/env python3
"""Chip smoke test of the H100 port (``dtf_tpu_torch``): the quickest proof
that the port builds and runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device — a CUDA device must exist; prints the card's name and power
   limit as ``nvidia-smi`` gives them.
2. build — compiles every kernel of the port from ``dtf_tpu_torch/ops/csrc``
   with ``nvcc`` for sm_90a (one nvcc per source, all started together).
3. kernels — the flash-attention forward kernel (B1, and B4 through
   ``block_h``) against its plain PyTorch version on the card, bf16, at
   GPT-2 shapes; times the kernel, the plain version, PyTorch's
   ``scaled_dot_product_attention`` (a yardstick only — the port never
   calls it) and the bound.
4. generate — GPT-2 small at full width, seeded random weights, batch 4,
   prompt 1024, 64 new greedy tokens through ``models.gpt.generate``; the
   flash launch count must be exactly one per layer; prefill logits and
   greedy tokens are held against the same model on the dense path.
   Then the ``python -m dtf_tpu_torch.generate_gpt`` entry, in process.
5. generate-variants — GPT-2 small widths at 4 layers with GQA
   (kv_heads 4), a 256 window with every 2nd layer global, an int8 KV
   cache and ``flash_block_h=2`` (B4); one greedy run, one seeded sampled
   run (temperature 0.8, top_p 0.9) twice.

Then one JSON line listing every kernel (launches on its path, error
against the plain version, times, bound), the ``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when no GPU is present or when the port's package is not beside
this file.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and dense
#: bf16 tensor-core FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

#: kernel vs plain version, bf16 inputs. out: both cast p to bf16 before
#: P·V, but relative to a different max (the kernel's running max, the
#: plain version's row max), and round the output to bf16 — a few bf16
#: ulps (2^-8 relative) at |out| <= ~4. lse: f32 in both, only the
#: summation order and the online rescaling differ.
OUT_ATOL = 3e-2
LSE_ATOL = 1e-3
#: prefill logits, flash vs dense path of the same bf16 model: the
#: attention outputs differ by bf16 roundings (above), which 12 bf16
#: layers carry into the f32 head. Stated against the logits' scale.
LOGITS_REL_TOL = 2e-2

#: the slice's shapes: GPT-2 small, batch 4, prompt 1024, 64 new tokens
BATCH, PROMPT, N_NEW, HEADS, D_HEAD = 4, 1024, 64, 12, 64


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def phase_device(torch):
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit({"phase": "device", **dev, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return dev, smi


def phase_build():
    from dtf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(_build.KERNELS, ptxas_verbose=True)
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    for name in _build.KERNELS:
        _build.load(name)
    emit({"phase": "build", "seconds": secs, "sources": list(_build.KERNELS),
          "ptxas": ptxas})


def time_ms(torch, fn, iters):
    """Mean device milliseconds of one fn() call: iters calls captured in
    one CUDA graph, replayed 3 times between CUDA events — the Python
    around each launch is not in the measurement. Inputs stay in L2
    between calls."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * iters)


def attention_bound_ms(b, h, t_q, t_k, d, causal, window):
    """The least time the card could take: the larger of the bytes moved
    (q, k, v read once; out and lse written once) over the memory rate
    and the matmul FLOPs of the keys each query really sees over the
    bf16 peak."""
    nbytes = 2 * (b * h * t_q * d + 2 * b * h * t_k * d + b * h * t_q * d) \
        + 4 * b * h * t_q
    seen = 0
    for qp in range(t_q):
        hi = min(qp + 1, t_k) if causal else t_k
        lo = max(0, qp - window + 1) if (causal and window) else 0
        seen += max(0, hi - lo)
    flops = 4 * b * h * d * seen                 # QK^T and PV, 2 per MAC
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(torch):
    from dtf_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, h, t_q, t_k, d):
        return [torch.randn(b, h, t, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
                for t in (t_q, t_k, t_k)]

    def mask_bias(b, t_k):
        m = torch.ones(b, t_k, dtype=torch.bool, device="cuda")
        m[0, t_k - 100:] = False             # a masked tail
        m[b - 1, :] = False                  # every key of a row masked
        return fa._mask_bias(m, b, t_k)

    cases = [
        ("causal_T1024", (BATCH, HEADS, 1024, 1024, D_HEAD), True, 0, False, 1),
        ("causal_T1000_ragged", (BATCH, HEADS, 1000, 1000, D_HEAD), True, 0,
         False, 1),
        ("causal_window256", (BATCH, HEADS, 1024, 1024, D_HEAD), True, 256,
         False, 1),
        ("kv_mask_dead_row", (BATCH, HEADS, 1024, 1024, D_HEAD), False, 0,
         True, 1),
        ("tq512_tk1024", (BATCH, HEADS, 512, 1024, D_HEAD), False, 0, False,
         1),
        ("causal_tq1024_tk600", (BATCH, HEADS, 1024, 600, D_HEAD), True, 0,
         False, 1),
        ("block_h2_causal_T1024", (BATCH, HEADS, 1024, 1024, D_HEAD), True, 0,
         False, 2),
        ("d128_causal_T1024", (2, 8, 1024, 1024, 128), True, 0, False, 1),
        ("tiny_T5_causal", (1, 2, 5, 5, D_HEAD), True, 0, False, 1),
        ("T65_window1", (2, 3, 65, 65, D_HEAD), True, 1, False, 1),
        ("kv_mask_causal_window128", (BATCH, HEADS, 1024, 1024, D_HEAD),
         True, 128, True, 1),
        ("d128_block_h2_T300", (2, 4, 300, 300, 128), True, 0, False, 2),
    ]
    err = {"flash_fwd": 0.0, "flash_fwd_hfold": 0.0}
    rows = []
    fa.reset_launch_counts()
    for name, (b, h, t_q, t_k, d), causal, window, masked, block_h in cases:
        q, k, v = qkv(b, h, t_q, t_k, d)
        bias = mask_bias(b, t_k) if masked else None
        scale = d ** -0.5
        out, lse = fa.flash_attention_cuda(
            q, k, v, bias, sm_scale=scale, causal=causal, window=window,
            block_h=block_h)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(
            q, k, v, bias, sm_scale=scale, causal=causal, window=window)
        require(out.shape == ref_out.shape and out.dtype == torch.bfloat16,
                f"{name}: out {tuple(out.shape)} {out.dtype}")
        require(torch.isfinite(out).all().item(), f"{name}: non-finite out")
        d_out = (out.float() - ref_out.float()).abs().max().item()
        dead = torch.isneginf(ref_lse)
        require(torch.equal(torch.isneginf(lse), dead),
                f"{name}: -inf lse rows differ")
        d_lse = ((lse - ref_lse).abs()[~dead].max().item()
                 if (~dead).any() else 0.0)
        if masked:
            rows_dead = out.view(b, h, t_q, d)[b - 1]
            require(torch.count_nonzero(rows_dead).item() == 0,
                    f"{name}: fully masked row is not 0")
        if block_h > 1:
            base, base_lse = fa.flash_attention_cuda(
                q, k, v, bias, sm_scale=scale, causal=causal, window=window)
            require(torch.equal(out, base) and torch.equal(lse, base_lse),
                    f"{name}: block_h={block_h} differs from block_h=1")
        ok = d_out <= OUT_ATOL and d_lse <= LSE_ATOL
        kname = "flash_fwd" if block_h == 1 else "flash_fwd_hfold"
        err[kname] = max(err[kname], d_out)
        rows.append({"case": name, "max_abs_err_out": d_out,
                     "max_abs_err_lse": d_lse, "ok": ok})
        require(ok, f"{name}: kernel disagrees with the plain version "
                    f"(out {d_out} > {OUT_ATOL} or lse {d_lse} > {LSE_ATOL})")
    emit({"phase": "kernels", "out_atol": OUT_ATOL, "lse_atol": LSE_ATOL,
          "cases": rows})

    # times at the main path's shape: [4, 12, 1024, 64] bf16 causal
    q, k, v = qkv(BATCH, HEADS, PROMPT, PROMPT, D_HEAD)
    scale = D_HEAD ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound, bound_by = attention_bound_ms(BATCH, HEADS, PROMPT, PROMPT,
                                         D_HEAD, True, 0)
    timing = {}
    for kname, block_h in (("flash_fwd", 1), ("flash_fwd_hfold", 2)):
        timing[kname] = time_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, sm_scale=scale, causal=True, block_h=block_h), 20)
    plain = time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, sm_scale=scale, causal=True), 5)
    library = time_ms(torch, lambda: sdpa(q, k, v, is_causal=True), 20)
    emit({"phase": "kernel_times", "shape": [BATCH, HEADS, PROMPT, D_HEAD],
          "causal": True, "kernel_ms": timing["flash_fwd"],
          "kernel_hfold_ms": timing["flash_fwd_hfold"], "plain_ms": plain,
          "library_ms": library, "bound_us": bound * 1e3,
          "bound_by": bound_by})
    fa.reset_launch_counts()
    return err, timing, plain, library, bound, bound_by


def build_model(torch, cfg, seed=0):
    from dtf_tpu_torch.convert import init_params, params_from_flax
    from dtf_tpu_torch.models.gpt import GPT

    model = GPT(cfg, device="cuda")
    model.load_state_dict(params_from_flax(init_params(cfg, seed)))
    return model.eval()


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_flash_vs_dense(torch, cfg, flash_model, prompt, tag):
    """Prefill logits of the flash path against the dense path of the
    same weights; returns the dense model for further checks."""
    import dataclasses

    from dtf_tpu_torch.models.gpt import GPT

    dense = GPT(dataclasses.replace(cfg, attn_impl="dense"), device="cuda")
    dense.load_state_dict(flash_model.state_dict())
    dense.eval()
    with torch.no_grad():
        lf = flash_model(prompt, flash_model.init_cache(prompt.shape[0]))
        ld = dense(prompt, dense.init_cache(prompt.shape[0]))
    require(torch.isfinite(lf).all().item(), f"{tag}: non-finite logits")
    scale = ld.abs().max().item()
    diff = (lf - ld).abs().max().item()
    emit({"phase": f"{tag}_prefill_logits", "max_abs_diff": diff,
          "max_abs_logit": scale, "rel_tol": LOGITS_REL_TOL})
    require(diff <= LOGITS_REL_TOL * scale,
            f"{tag}: flash vs dense prefill logits differ by {diff} "
            f"(> {LOGITS_REL_TOL} x {scale})")
    return dense


def phase_generate(torch):
    import dataclasses

    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_small(),
                              decode_len=PROMPT + N_NEW)
    model = build_model(torch, cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, 50257, (BATCH, PROMPT), generator=gen,
                           device="cuda")
    gpt.generate(model, prompt[:, :128], 2)            # warm-up, not read

    fa.reset_launch_counts()
    out, total_s = timed(torch, lambda: gpt.generate(model, prompt, N_NEW))
    launches = dict(fa.launch_counts)
    require(launches == {"flash_fwd": cfg.layers, "flash_fwd_hfold": 0},
            f"flash launches per generate call {launches} != "
            f"{cfg.layers} (one per layer)")
    require(tuple(out.shape) == (BATCH, PROMPT + N_NEW), f"shape {out.shape}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            "token out of range")
    require(torch.equal(out[:, :PROMPT], prompt), "prompt not echoed")
    _, prefill_s = timed(torch, lambda: gpt.generate(model, prompt, 1))
    decode_s = (total_s - prefill_s) / (N_NEW - 1)

    # the dense path of the same model: logits, then greedy tokens up to
    # the first step whose top-2 margin is inside the logits tolerance
    dense = check_flash_vs_dense(torch, cfg, model, prompt, "generate")
    out_d = gpt.generate(dense, prompt, N_NEW)
    with torch.no_grad():
        logits = dense(out_d[:, :-1], dense.init_cache(BATCH))
    top2 = logits[:, PROMPT - 1:].topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]                       # [B, N_NEW]
    tol = LOGITS_REL_TOL * logits.abs().max().item()
    compared = 0
    for row in range(BATCH):
        close = (margin[row] < tol).nonzero()
        upto = int(close[0]) if len(close) else N_NEW
        require(torch.equal(out[row, PROMPT:PROMPT + upto],
                            out_d[row, PROMPT:PROMPT + upto]),
                f"row {row}: flash and dense greedy tokens differ before "
                f"step {upto} (the first top-2 margin under {tol})")
        compared += upto
    emit({"phase": "generate", "model": "gpt2-small", "batch": BATCH,
          "prompt": PROMPT, "n_new": N_NEW, "flash_launches": launches,
          "prefill_ms": prefill_s * 1e3,
          "prefill_tokens_per_s": BATCH * PROMPT / prefill_s,
          "decode_ms_per_token": decode_s * 1e3,
          "decode_tokens_per_s": BATCH / decode_s,
          "generate_ms": total_s * 1e3,
          "tokens_compared_with_dense": compared,
          "tokens_generated": BATCH * N_NEW})
    del dense, logits

    from dtf_tpu_torch import generate_gpt

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = generate_gpt.main(["--size=small", "--init_seed=0", "--batch=2",
                                "--prompt=464,2068,7586,21831", "--n_new=8"])
    rows = [r for r in buf.getvalue().splitlines() if r.strip()]
    require(rc == 0 and len(rows) == 2 and rows[0] == rows[1]
            and len(rows[0].split(",")) == 12,
            f"generate_gpt entry printed {rows}")
    emit({"phase": "generate_gpt_cli", "rows": rows})
    return launches


def phase_variants(torch):
    import dataclasses

    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(
        gpt.GPTConfig.gpt2_small(), layers=4, kv_heads=4, attn_window=256,
        attn_global_every=2, kv_cache_dtype="int8", flash_block_h=2,
        decode_len=PROMPT + 32)
    model = build_model(torch, cfg, seed=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, 50257, (BATCH, PROMPT), generator=gen,
                           device="cuda")
    check_flash_vs_dense(torch, cfg, model, prompt, "variants")

    fa.reset_launch_counts()
    greedy = gpt.generate(model, prompt, 32)
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    require(launches == {"flash_fwd": 0, "flash_fwd_hfold": cfg.layers},
            f"variant launches {launches}")

    def sampled(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return gpt.generate(model, prompt, 32, generator=g, temperature=0.8,
                            top_p=0.9)

    a, b = sampled(7), sampled(7)
    for name, toks in (("greedy", greedy), ("sampled", a)):
        require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                f"{name}: token out of range")
        require(tuple(toks.shape) == (BATCH, PROMPT + 32), f"{name} shape")
    require(torch.equal(a, b), "sampled run does not repeat for one seed")
    emit({"phase": "generate_variants", "layers": cfg.layers,
          "kv_heads": 4, "attn_window": 256, "attn_global_every": 2,
          "kv_cache_dtype": "int8", "flash_block_h": 2,
          "flash_launches": launches, "sampled_repeats": True,
          "sampled_differs_from_greedy": not torch.equal(a, greedy)})
    return launches


def main():
    if not os.path.isdir(os.path.join(ROOT, "dtf_tpu_torch")):
        print("chip_smoke: the dtf_tpu_torch package is not beside this "
              "file", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    # f32 references in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device, smi = phase_device(torch)
    phase_build()
    err, timing, plain, library, bound, bound_by = phase_kernels(torch)
    main_launches = phase_generate(torch)
    variant_launches = phase_variants(torch)
    common = {"route": "cuda", "source": "dtf_tpu_torch/ops/csrc/flash_fwd.cu",
              "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
              "library_ms": library}
    emit({"kernels": [
        {"name": "flash_fwd", **common,
         "replaces": "dtf_tpu/ops/flash_attention.py:164",
         "launches": main_launches["flash_fwd"],
         "max_abs_err": err["flash_fwd"], "ms": timing["flash_fwd"]},
        {"name": "flash_fwd_hfold", **common,
         "replaces": "dtf_tpu/ops/flash_attention.py:222",
         "launches": variant_launches["flash_fwd_hfold"],
         "max_abs_err": err["flash_fwd_hfold"],
         "ms": timing["flash_fwd_hfold"]},
    ], "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
