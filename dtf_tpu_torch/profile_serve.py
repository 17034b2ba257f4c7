"""Profile the serving engine's steps on the GPU with ``torch.profiler``.

    python -m dtf_tpu_torch.profile_serve [--n_slots 16] [--max_len 1024]
        [--prefill_chunk 128] [--prompt 512] [--steps 20]

GPT-2 small, seeded random weights (bf16). Fills every slot with a greedy
request of ``--prompt`` random tokens, then times ``--steps`` decode steps
(host wall clock around ``DecodeEngine.decode``, its readback included)
and profiles 5 more with CPU and CUDA activities. Prints one JSON line:
the card's name and power limit, the prefill ms a chunk, the decode ms a
step (wall and device-busy, and the device ms of the operators that take
the most), the kernel launches a step, the device's idle share over the
profiled steps and against the unprofiled wall, and the KV cache MiB. Needs a GPU;
:func:`measure_decode` is the measurement, which ``chip_smoke.py`` runs
on its own engines.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

PROFILED_STEPS = 5
#: operators listed by their device time
TOP_OPS = 10


def measure_decode(engine, *, prompt_len: int, steps: int = 20,
                   seed: int = 0) -> dict:
    """Admit one greedy request of ``prompt_len`` seeded random tokens into
    every slot of ``engine`` (a CUDA engine), then time ``steps`` decode
    steps and profile ``PROFILED_STEPS`` more. Every slot stays active
    throughout: the request budget is the whole ``max_len``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    need = prompt_len + steps + PROFILED_STEPS + 2
    if need > engine.max_len:
        raise ValueError(f"prompt {prompt_len} + {steps + PROFILED_STEPS} "
                         f"steps exceed max_len={engine.max_len}")
    rng = np.random.default_rng(seed)
    vocab = engine.cfg.vocab_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for slot in range(engine.n_slots):
        engine.prefill(slot, rng.integers(0, vocab, prompt_len).tolist())
    torch.cuda.synchronize()
    chunks = engine.n_slots * engine.n_chunks(prompt_len)
    prefill_ms = (time.perf_counter() - t0) * 1e3 / chunks
    engine.decode()                                           # warm-up
    walls = []
    for _ in range(steps):
        t = time.perf_counter()
        engine.decode()                  # ends in the readback: synced
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            engine.decode()
        wall_s = time.perf_counter() - t
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    # device time by the operator that launched it, largest first
    by_op = sorted(((e.self_device_time_total, e.key) for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.self_device_time_total > 0), reverse=True)
    return {"n_slots": engine.n_slots, "max_len": engine.max_len,
            "prefill_chunk": engine.prefill_chunk, "prompt": prompt_len,
            "prefill_ms_per_chunk": prefill_ms,
            "decode_ms_per_step_median": statistics.median(walls),
            "decode_ms_per_step_min": min(walls),
            "profiled_wall_ms_per_step": wall_s * 1e3 / PROFILED_STEPS,
            "device_busy_ms_per_step": device_us / 1e3 / PROFILED_STEPS,
            "launches_per_step": launches / PROFILED_STEPS,
            "device_ms_per_step_by_op": {
                key: us / 1e3 / PROFILED_STEPS
                for us, key in by_op[:TOP_OPS]},
            "device_idle_share": max(0.0, 1 - device_us / 1e6 / wall_s),
            # the profiler slows the host, not the device: the same busy
            # time against the unprofiled steps' wall
            "device_idle_share_unprofiled": max(
                0.0, 1 - device_us / 1e3 / PROFILED_STEPS
                / statistics.median(walls)),
            "decode_tokens_per_s": engine.n_slots * 1e3
            / statistics.median(walls),
            "cache_mib": engine.cache_bytes() / 2 ** 20}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dtf_tpu_torch.profile_serve")
    p.add_argument("--n_slots", type=int, default=16)
    p.add_argument("--max_len", type=int, default=1024)
    p.add_argument("--prefill_chunk", type=int, default=128)
    p.add_argument("--prompt", type=int, default=512)
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args(argv)

    import torch

    from dtf_tpu_torch.convert import init_params, params_from_flax
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.serve import DecodeEngine

    cfg = gpt.GPTConfig.gpt2_small()
    engine = DecodeEngine(cfg, params_from_flax(init_params(cfg, 0)),
                          n_slots=args.n_slots, max_len=args.max_len,
                          prefill_chunk=args.prefill_chunk)
    got = measure_decode(engine, prompt_len=args.prompt, steps=args.steps)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "model": "gpt2-small", **got,
                      "max_memory_allocated":
                      torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
