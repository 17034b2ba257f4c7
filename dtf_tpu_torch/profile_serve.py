"""Profile the serving engine's steps on the GPU with ``torch.profiler``.

    python -m dtf_tpu_torch.profile_serve [--n_slots 16] [--max_len 1024]
        [--prefill_chunk 128] [--prompt 512] [--steps 20]
        [--spec_k 4 (--draft_layers 3 | --self_draft)] [--replicas 2]

GPT-2 small, seeded random weights (bf16). Fills every slot with a greedy
request of ``--prompt`` random tokens, then times ``--steps`` decode steps
(host wall clock around ``DecodeEngine.decode``, its readback included)
and profiles 5 more with CPU and CUDA activities. Prints one JSON line:
the card's name and power limit, the prefill ms a chunk, the decode ms a
step (wall and device-busy, and the device ms of the operators that take
the most), the kernel launches a step, the device's idle share over the
profiled steps and against the unprofiled wall, and the KV cache MiB.
With ``--spec_k`` a decode step is a speculative tick, and the draft step
and the verify step are also timed and profiled alone (wall, busy,
launches, idle share), beside the tokens a tick and the accept rate.
With ``--replicas`` N > 1 the step is a ROUTER tick over N replicas
sharing one set of weights (every slot of every replica decoding): its
wall time, launches, busy ms and idle share, and the control-plane
profile's split of the host time (``cp_pick``, ``cp_engine_tick``,
``cp_health_sweep``, ``cp_page_ops``, ``cp_bookkeeping``). Needs a GPU;
:func:`measure_decode` and :func:`measure_router_tick` are the
measurements, which ``chip_smoke.py`` runs on its own engines.
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


def _profiled(fn, steps: int, profiled: int) -> dict:
    """``fn()`` (ending in a device sync) ``steps`` times timed, then
    ``profiled`` times under ``torch.profiler``: wall ms (median, min),
    device-busy ms, launches and idle shares a call, device ms by
    operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()                                                      # warm-up
    walls = []
    for _ in range(steps):
        t = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(profiled):
            fn()
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
    median = statistics.median(walls)
    return {"ms_median": median, "ms_min": min(walls),
            "profiled_wall_ms": wall_s * 1e3 / profiled,
            "busy_ms": device_us / 1e3 / profiled,
            "launches": launches / profiled,
            "device_ms_by_op": {key: us / 1e3 / profiled
                                for us, key in by_op[:TOP_OPS]},
            "idle_share": max(0.0, 1 - device_us / 1e6 / wall_s),
            # the profiler slows the host, not the device: the same busy
            # time against the unprofiled wall
            "idle_share_unprofiled": max(
                0.0, 1 - device_us / 1e3 / profiled / median)}


def measure_decode(engine, *, prompt_len: int, steps: int = 20,
                   profiled: int = PROFILED_STEPS, seed: int = 0) -> dict:
    """Admit one greedy request of ``prompt_len`` seeded random tokens into
    every slot of ``engine`` (a CUDA engine), then time ``steps`` decode
    steps and profile ``profiled`` more. Every slot stays active
    throughout: the request budget is the whole ``max_len``. A speculative
    engine's draft and verify steps are then measured alone the same
    way."""
    import numpy as np
    import torch

    k = engine.spec_k
    calls = steps + profiled + 1
    need = prompt_len + (calls * (3 if k else 1) + 1) * (k + 1)
    if need > engine.max_len:
        raise ValueError(f"prompt {prompt_len} + {calls} steps of up to "
                         f"{k + 1} tokens exceed max_len={engine.max_len}")
    rng = np.random.default_rng(seed)
    vocab = engine.cfg.vocab_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for slot in range(engine.n_slots):
        engine.prefill(slot, rng.integers(0, vocab, prompt_len).tolist())
    torch.cuda.synchronize()
    chunks = engine.n_slots * engine.n_chunks(prompt_len)
    prefill_ms = (time.perf_counter() - t0) * 1e3 / chunks
    counters0 = dict(engine.counters)
    tick = _profiled(engine.decode, steps, profiled)
    out = {"n_slots": engine.n_slots, "max_len": engine.max_len,
           "prefill_chunk": engine.prefill_chunk, "prompt": prompt_len,
           "spec_k": k, "prefill_ms_per_chunk": prefill_ms,
           "decode_ms_per_step_median": tick["ms_median"],
           "decode_ms_per_step_min": tick["ms_min"],
           "profiled_wall_ms_per_step": tick["profiled_wall_ms"],
           "device_busy_ms_per_step": tick["busy_ms"],
           "launches_per_step": tick["launches"],
           "device_ms_per_step_by_op": tick["device_ms_by_op"],
           "device_idle_share": tick["idle_share"],
           "device_idle_share_unprofiled": tick["idle_share_unprofiled"],
           "cache_mib": engine.cache_bytes() / 2 ** 20}
    tokens_per_slot_tick = 1.0
    if k:
        proposed = engine.counters["spec_proposed"] - counters0[
            "spec_proposed"]
        accepted = engine.counters["spec_accepted"] - counters0[
            "spec_accepted"]
        tokens_per_slot_tick = 1 + k * accepted / proposed
        out["accept_rate"] = accepted / proposed

        def draft():
            engine.draft_propose()
            torch.cuda.synchronize()

        props = engine.draft_propose()

        def verify():
            engine.verify_all(props)
            torch.cuda.synchronize()

        out["draft_step"] = _profiled(draft, steps, profiled)
        out["verify_step"] = _profiled(verify, steps, profiled)
    out["tokens_per_slot_tick"] = tokens_per_slot_tick
    out["decode_tokens_per_s"] = (engine.n_slots * tokens_per_slot_tick
                                  * 1e3 / tick["ms_median"])
    return out


def measure_router_tick(router, *, prompt_len: int, steps: int = 20,
                        profiled: int = PROFILED_STEPS,
                        seed: int = 0) -> dict:
    """Fill every slot of every replica of ``router`` (CUDA engines) with
    a greedy request of ``prompt_len`` seeded random tokens through
    ``submit`` and ticks, then time ``steps`` router ticks and profile
    ``profiled`` more — every replica decoding all its slots each tick.
    Returns the tick's wall, busy ms, launches and idle share, and the
    control-plane profile's mean ms a tick by phase over those ticks."""
    import numpy as np
    import torch

    from dtf_tpu_torch.serve import Request
    from dtf_tpu_torch.serve.router import CP_PHASES

    scheds = router.schedulers
    engine = scheds[0].engine
    slots = sum(s.engine.n_slots for s in scheds)
    max_new = steps + profiled + 8 + engine.n_chunks(prompt_len) * slots
    if prompt_len + max_new > engine.max_len:
        raise ValueError(f"prompt {prompt_len} + {max_new} new exceed "
                         f"max_len={engine.max_len}")
    rng = np.random.default_rng(seed)
    for _ in range(slots):
        router.submit(Request(
            prompt=rng.integers(0, engine.cfg.vocab_size,
                                prompt_len).tolist(), max_new=max_new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while any(s.queue_depth for s in scheds):
        router.tick()
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    if not all(s.occupancy == 1.0 for s in scheds):
        raise RuntimeError("the fleet's slots did not all fill")
    before = {name: router._cp.total(name) for name in CP_PHASES}
    ticks0 = router._ticks

    def tick():
        router.tick()
        torch.cuda.synchronize()

    got = _profiled(tick, steps, profiled)
    n_ticks = router._ticks - ticks0
    return {"replicas": len(scheds), "n_slots": engine.n_slots,
            "max_len": engine.max_len, "prompt": prompt_len,
            "fill_s": fill_s, "tick_ms_median": got["ms_median"],
            "tick_ms_min": got["ms_min"],
            "profiled_wall_ms_per_tick": got["profiled_wall_ms"],
            "device_busy_ms_per_tick": got["busy_ms"],
            "launches_per_tick": got["launches"],
            "device_ms_per_tick_by_op": got["device_ms_by_op"],
            "device_idle_share": got["idle_share"],
            "device_idle_share_unprofiled": got["idle_share_unprofiled"],
            "cp_ms_per_tick": {
                name: (router._cp.total(name) - before[name]) * 1e3
                / n_ticks for name in CP_PHASES},
            "decode_tokens_per_s": slots * 1e3 / got["ms_median"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dtf_tpu_torch.profile_serve")
    p.add_argument("--n_slots", type=int, default=16)
    p.add_argument("--max_len", type=int, default=1024)
    p.add_argument("--prefill_chunk", type=int, default=128)
    p.add_argument("--prompt", type=int, default=512)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--spec_k", type=int, default=0,
                   help="speculative tick with this many proposals")
    p.add_argument("--draft_layers", type=int, default=0,
                   help="with --spec_k: an early-exit draft of N layers")
    p.add_argument("--self_draft", action="store_true",
                   help="with --spec_k: the model drafts for itself")
    p.add_argument("--replicas", type=int, default=1,
                   help="> 1: time a router tick over this many replicas "
                        "(one set of weights)")
    args = p.parse_args(argv)
    if args.replicas < 1:
        p.error(f"--replicas={args.replicas} must be >= 1")
    if bool(args.spec_k) != bool(args.draft_layers or args.self_draft) \
            or (args.draft_layers and args.self_draft):
        p.error("--spec_k takes exactly one of --draft_layers and "
                "--self_draft, and they take --spec_k")

    import torch

    from dtf_tpu_torch.convert import init_params, params_from_flax
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.serve import DecodeEngine, Router

    cfg = gpt.GPTConfig.gpt2_small()
    params = params_from_flax(init_params(cfg, 0))
    draft = {}
    if args.self_draft:
        draft = dict(draft_cfg=cfg, draft_params=params)
    elif args.draft_layers:
        dcfg, dparams = gpt.draft_truncate(cfg, params, args.draft_layers)
        draft = dict(draft_cfg=dcfg, draft_params=dparams)
    kw = dict(n_slots=args.n_slots, max_len=args.max_len,
              prefill_chunk=args.prefill_chunk, spec_k=args.spec_k, **draft)
    if args.replicas > 1:
        router = Router.build(cfg, params, n_replicas=args.replicas, **kw)
        got = measure_router_tick(router, prompt_len=args.prompt,
                                  steps=args.steps)
    else:
        got = measure_decode(DecodeEngine(cfg, params, **kw),
                             prompt_len=args.prompt, steps=args.steps)
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
