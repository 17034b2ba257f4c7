"""Profile the port's Wide&Deep train step on the GPU (the twin of
``profile_train`` for ``train_widedeep``).

    python -m dtf_tpu_torch.profile_widedeep [--steps 20]

Wide&Deep at the launcher's defaults (hash_buckets 100,000, embed_dim 16,
mlp 256/128/64, bf16), the trainer's init (seed 0), Adam 1e-3, batches of
``SyntheticData("widedeep")`` placed on the card ahead of the window.
After five warm-up steps it

0. times ``--steps`` train steps without the profiler (host clock around
   work that ends in a synchronise): the wall time per step;
1. times the step's parts with CUDA events, in the order the step runs
   them (the second of two passes): the forward and loss, the backward,
   the optimizer update;
2. profiles ``--steps`` train steps with ``torch.profiler`` and sums the
   device time by kernel family: the tables' gathers (``index_select``,
   and B8 if anything launched it), the tables' scatter-add backward
   (``index_add_`` / ``index_put_``), casts and copies (the deep table's
   f32 → bf16 cast and its gradient's bf16 → f32 cast), GEMMs (cuBLAS),
   the optimizer's multi-tensor kernels, and the rest (elementwise,
   reductions, the loss).

It prints the top kernels by device time, then one JSON line: the card's
name and power limit, the wall time per step (unprofiled and profiled),
the device busy time per step, the idle share (busy against the
unprofiled wall time), the launches per step, the families, the parts
and the peak device memory. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import time

from dtf_tpu_torch.profile_train import card_line, device_summary

#: ``train_widedeep``'s defaults
BATCH, HASH_BUCKETS = 512, 100_000

#: kernel families, first match wins (kernel names as the profiler
#: reports them)
FAMILIES = (
    ("embed_gather (B8)", re.compile(r"embed_gather_kernel")),
    # index_select's kernel (before the scatter family: its backward's
    # _scatter_gather_elementwise_kernel is a scatter)
    ("gather (index_select)", re.compile(
        r"vectorized_gather_kernel|index_select|indexSelect", re.I)),
    ("scatter-add (index_add / index_put)",
     re.compile(r"index_add|indexFunc|index_put|indexing_backward|scatter",
                re.I)),
    ("gemm", re.compile(r"gemm|nvjet|xmma|cutlass", re.I)),
    ("optimizer (multi-tensor)", re.compile(r"multi_tensor_apply|foreach",
                                            re.I)),
    ("cast / copy", re.compile(r"copy_kernel|direct_copy|to_copy", re.I)),
    ("fill (zeros)", re.compile(r"fill", re.I)),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dtf_tpu_torch.profile_widedeep")
    p.add_argument("--steps", type=int, default=20,
                   help="train steps timed without, then with the "
                        "profiler")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dtf_tpu_torch import optim
    from dtf_tpu_torch.convert import init_params_widedeep, params_from_flax
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.models import widedeep

    model = widedeep.WideDeep(hash_buckets=HASH_BUCKETS, device="cuda")
    model.load_state_dict(params_from_flax(init_params_widedeep(model, 0)))
    tx = optim.adam(1e-3)
    state = tr.create_train_state(model, tx, 0)
    loss_fn = widedeep.make_loss(model)
    step = tr.make_train_step(loss_fn, tx)
    data = SyntheticData("widedeep", BATCH, seed=0,
                         hash_buckets=HASH_BUCKETS)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.batch(i).items()} for i in range(5 + 2 * args.steps)]
    torch.cuda.reset_peak_memory_stats()
    for b in batches[:5]:
        state, m = step(state, b)
    float(m["loss"])
    torch.cuda.synchronize()

    # 0. whole steps, no profiler
    t0 = time.perf_counter()
    for b in batches[5:5 + args.steps]:
        state, m = step(state, b)
    float(m["loss"])
    torch.cuda.synchronize()
    wall_unprofiled = (time.perf_counter() - t0) / args.steps

    # 1. the parts of one step, CUDA events between them; two passes
    params = state.params
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = loss_fn(params, batches[0], 0)
        ev[1].record()
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        ev[2].record()
        updates, opt_state = tx.update(grads, state.opt_state, params)
        optim.apply_updates(params, updates)
        ev[3].record()
        torch.cuda.synchronize()
        parts = dict(zip(("forward_loss", "backward", "optimizer"),
                         (ev[i].elapsed_time(ev[i + 1]) for i in range(3))))
        state.opt_state = opt_state
        del loss, grads, updates

    # 2. whole steps under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[5 + args.steps:]:
            state, m = step(state, b)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    families, busy, launches = device_summary(prof, args.steps, FAMILIES)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": card_line(),
        "model": "widedeep", "hash_buckets": HASH_BUCKETS,
        "batch": BATCH,
        "n_params": sum(q.numel() for q in params.values()),
        "profiled_steps": args.steps,
        "wall_ms_per_step": wall_unprofiled * 1e3,
        "wall_ms_per_step_profiled": wall * 1e3,
        "examples_per_s": BATCH / wall_unprofiled,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1 - busy / (wall_unprofiled * 1e3)),
        "kernel_launches_per_step": launches,
        "families_ms_per_step": families, "parts_ms": parts,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
