"""Profile the port's ``generate`` on the GPU with ``torch.profiler``.

    python -m dtf_tpu_torch.profile_generate [--n_new 8]

GPT-2 small, seeded random weights, batch 4, prompt 1024 (the slice's
shape). Runs one warm-up call, then profiles one ``generate`` call
with CPU and CUDA activities and prints, per operator, the self device
time and the host time, then one JSON line: the card's name and power
limit, the wall time, the summed kernel time, the kernel launches and
the device's idle share over the call. Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

BATCH, PROMPT = 4, 1024
ROWS = 15          # operators printed per table


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dtf_tpu_torch.profile_generate")
    p.add_argument("--n_new", type=int, default=8,
                   help="new tokens; 1 profiles the prefill alone")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dtf_tpu_torch.convert import init_params, params_from_flax
    from dtf_tpu_torch.models import gpt

    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_small(),
                              decode_len=PROMPT + args.n_new)
    model = gpt.GPT(cfg, device="cuda")
    model.load_state_dict(params_from_flax(init_params(cfg, 0)))
    model.eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, 50257, (BATCH, PROMPT), generator=gen,
                           device="cuda")
    gpt.generate(model, prompt, args.n_new)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gpt.generate(model, prompt, args.n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=ROWS))
    print(events.table(sort_by="cpu_time_total", row_limit=ROWS))
    # kernel events only (an aten op's device time is its kernels' time)
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "layers": cfg.layers,
        "batch": BATCH, "prompt": PROMPT, "n_new": args.n_new,
        "wall_ms": wall * 1e3, "device_busy_ms": device_us / 1e3,
        "kernel_launches": launches,
        "device_idle_share": max(0.0, 1 - device_us / 1e6 / wall)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
