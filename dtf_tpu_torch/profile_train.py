"""Profile the port's training step on the GPU (the twin of ``profile_generate``).

    python -m dtf_tpu_torch.profile_train [--steps 3] [--remat]
        [--loss_pallas | --loss_chunk_tokens N] [--nccl_world1]

GPT-2 small at full width with the trainer's init (seed 0), batch 8 ×
seq 1024 from ``SyntheticData("gpt")``, the launcher's AdamW recipe, the
monolithic LM loss or, with ``--loss_pallas`` / ``--loss_chunk_tokens``,
the fused or token-chunked one. After three warm-up steps it

0. times ``--steps`` train steps without the profiler (host clock around
   work that ends in a synchronise): the wall time per step;
1. times the step's parts with CUDA events, in the order the step runs
   them (the second of two passes, so first-use costs are not in it):
   the trunk forward (embedding → ``ln_f``), the f32 LM head + CE
   forward (on the chosen loss path), their backward, the trunk
   backward, the optimizer update;
2. times the head's three f32 GEMMs alone at their shapes (logits,
   dW, dX), so the CE's own share is the head + CE time less these, and
   the fused kernels B5, the merge of its parts, the split pass, B6 and
   B7 alone at the same shapes;
3. profiles ``--steps`` whole train steps (``make_train_step``) with
   ``torch.profiler`` and sums the device time by kernel family: the
   flash forward (B1), dQ (B2), dK/dV (B3), the fused CE forward (B5),
   the merge of its parts, the split pass, dX (B6) and dW (B7), GEMMs
   (cuBLAS), the optimizer's multi-tensor kernels, NCCL's, and the
   rest (elementwise, LayerNorm, softmax, reductions).

``--nccl_world1``: the whole steps (0 and 3) run the data-parallel step
inside a process group of ONE over NCCL, with ZeRO-1 on: every
collective and every pass the data-parallel step adds, at world size 1
(the parts of 1 and 2 are the plain step's).

It prints the top kernels by device time, then one JSON line: the card's
name and power limit, the wall time per step (unprofiled and profiled),
the device busy time per step, the idle share (busy against the
unprofiled wall time), the families and the parts. Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import time

BATCH, SEQ = 8, 1024
ROWS = 25          # kernels printed

#: kernel families, first match wins (kernel names as the profiler
#: reports them; cuBLAS's GEMMs on Hopper are nvjet / sm90 xmma / cutlass)
FAMILIES = (
    ("flash_fwd (B1)", re.compile(r"flash_fwd_kernel")),
    ("flash_dq (B2)", re.compile(r"flash_bwd_dq_kernel")),
    ("flash_dkv (B3)", re.compile(r"flash_bwd_dkv_kernel")),
    ("fused_ce_fwd (B5)", re.compile(r"fused_ce_fwd_kernel")),
    ("fused_ce_merge", re.compile(r"fused_ce_merge_kernel")),
    ("fused_ce_split", re.compile(r"fused_ce_split_kernel")),
    ("fused_ce_dx (B6)", re.compile(r"fused_ce_dx_kernel")),
    ("fused_ce_dw (B7)", re.compile(r"fused_ce_dw_kernel")),
    ("gemm", re.compile(r"gemm|nvjet|xmma|cutlass", re.I)),
    ("optimizer (multi-tensor)", re.compile(r"multi_tensor_apply|foreach",
                                            re.I)),
    ("nccl", re.compile(r"nccl", re.I)),
)


def _family(name: str, families=FAMILIES) -> str:
    for fam, pat in families:
        if pat.search(name):
            return fam
    return "other"


def device_summary(prof, steps: int, families=FAMILIES):
    """Print the top kernels of a ``torch.profiler`` run over ``steps``
    steps, and return (device ms per step by family, device-busy ms per
    step, kernel launches per step)."""
    import torch

    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:ROWS]:
        print(f"{e.self_device_time_total / 1e3 / steps:10.4f} ms "
              f"{e.count // steps:6d}x  {_family(e.key, families):36s} "
              f"{e.key[:100]}")
    by_family: dict = {}
    for e in kernels:
        fam = _family(e.key, families)
        by_family[fam] = by_family.get(fam, 0.0) + \
            e.self_device_time_total / 1e3 / steps
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx"))
    return by_family, sum(by_family.values()), launches / steps


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dtf_tpu_torch.profile_train")
    p.add_argument("--steps", type=int, default=3,
                   help="train steps timed without, then with the "
                        "profiler")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward")
    loss = p.add_mutually_exclusive_group()
    loss.add_argument("--loss_pallas", action="store_true",
                      help="the fused head + CE kernels (B5-B7)")
    loss.add_argument("--loss_chunk_tokens", type=int, default=0,
                      help="the token-chunked loss, this many tokens a "
                           "chunk")
    p.add_argument("--nccl_world1", action="store_true",
                   help="whole steps inside a process group of one over "
                        "NCCL, ZeRO-1 on")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from dtf_tpu_torch import optim
    from dtf_tpu_torch.convert import init_params_flax, params_from_flax
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.models import gpt
    from dtf_tpu_torch.ops import fused_ce as fc
    from dtf_tpu_torch.ops.losses import softmax_cross_entropy

    cfg = dataclasses.replace(gpt.GPTConfig.gpt2_small(), remat=args.remat)
    model = gpt.GPT(cfg, device="cuda")
    model.load_state_dict(params_from_flax(init_params_flax(cfg, 0)))
    tx = optim.adamw(optim.join_schedules(
        [optim.linear_schedule(0.0, 3e-4, 4),
         optim.cosine_decay_schedule(3e-4, 1000)], [4]), weight_decay=0.1)
    loss_opts = dict(loss_pallas=args.loss_pallas,
                     loss_chunk_tokens=args.loss_chunk_tokens)
    fused = gpt._fused_ce(0, args.loss_chunk_tokens, args.loss_pallas)
    mesh = layout = None
    if args.nccl_world1:
        import torch.distributed as dist

        from dtf_tpu_torch.core.dist import free_port
        from dtf_tpu_torch.core.mesh import MeshConfig, make_mesh
        from dtf_tpu_torch.core.sharding import make_layout

        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{free_port()}", world_size=1, rank=0)
        mesh = make_mesh(MeshConfig(data=1), torch.device("cuda", 0))
        layout = make_layout(dict(model.named_parameters()), mesh,
                             zero1=True)
    state = tr.create_train_state(model, tx, 0, mesh=mesh, layout=layout)
    step = tr.make_train_step(gpt.make_loss(model, **loss_opts, mesh=mesh),
                              tx, mesh=mesh)
    data = SyntheticData("gpt", BATCH, seed=0, seq_len=SEQ,
                         vocab_size=cfg.vocab_size)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.batch(i).items()} for i in range(3 + 2 * args.steps)]
    for b in batches[:3]:
        state, m = step(state, b)
    float(m["loss"])
    torch.cuda.synchronize()

    # 0. whole steps, no profiler
    t0 = time.perf_counter()
    for b in batches[3:3 + args.steps]:
        state, m = step(state, b)
    float(m["loss"])
    torch.cuda.synchronize()
    wall_unprofiled = (time.perf_counter() - t0) / args.steps

    # 1. the parts of one step, CUDA events between them; two passes
    b = batches[0]
    params = state.params
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        hidden = model(b["input_ids"], return_hidden=True)
        ev[1].record()
        h = hidden.detach().requires_grad_()
        if fused is not None:
            loss, _ = fused(h, model.lm_head.weight, b["labels"])
        else:
            loss, _ = softmax_cross_entropy(model.lm_head(h), b["labels"],
                                            ignore_index=-100)
        ev[2].record()
        loss.backward()
        ev[3].record()
        hidden.backward(h.grad)
        ev[4].record()
        grads = {n: q.grad for n, q in params.items()}
        updates, opt_state = tx.update(grads, state.opt_state, params)
        optim.apply_updates(params, updates)
        ev[5].record()
        torch.cuda.synchronize()
        parts = dict(zip(("trunk_fwd", "head_ce_fwd", "head_ce_bwd",
                          "trunk_bwd", "optimizer"),
                         (ev[i].elapsed_time(ev[i + 1]) for i in range(5))))
        state = dataclasses.replace(state, opt_state=opt_state)
        for q in params.values():
            q.grad = None
        del hidden, h, loss, grads, updates

    # 2. the head's f32 GEMMs alone: logits, dW, dX
    x = torch.randn(BATCH * SEQ, cfg.d_model, device="cuda")
    w = model.lm_head.weight.detach()
    dl = torch.randn(BATCH * SEQ, cfg.vocab_size, device="cuda")
    gemms = (lambda: x @ w.t(), lambda: dl.t() @ x, lambda: dl @ w)
    for g in gemms:
        g()
    g0, g1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    g0.record()
    for _ in range(3):
        for g in gemms:
            g()
    g1.record()
    torch.cuda.synchronize()
    head_gemm_ms = g0.elapsed_time(g1) / 3
    del dl

    # ... and the fused kernels B5, the merge, the split pass, B6, B7
    # alone at the same shapes
    labels = batches[0]["labels"].reshape(-1).to(torch.int32)
    valid = (labels != -100).float()
    dce = valid / valid.sum().clamp_min(1.0)
    split = fc.fused_ce_split_cuda(x, w)
    ws = fc.fused_ce_fwd_parts_cuda(x, w, labels, split)
    lse, _ = fc.fused_ce_merge_cuda(ws)
    kernels = {
        "fused_ce_fwd": lambda: fc.fused_ce_fwd_parts_cuda(x, w, labels,
                                                           split),
        "fused_ce_merge": lambda: fc.fused_ce_merge_cuda(ws),
        "fused_ce_split": lambda: fc.fused_ce_split_cuda(x, w),
        "fused_ce_dx": lambda: fc.fused_ce_dx_cuda(x, w, labels, lse, dce,
                                                   split),
        "fused_ce_dw": lambda: fc.fused_ce_dw_cuda(x, w, labels, lse, dce,
                                                   split)}
    fused_ms = {}
    for name, fn in kernels.items():
        fn()
        g0.record()
        for _ in range(3):
            fn()
        g1.record()
        torch.cuda.synchronize()
        fused_ms[name] = g0.elapsed_time(g1) / 3
    del x, lse, split, ws

    # 3. whole steps under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[3 + args.steps:]:
            state, m = step(state, b)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    families, busy, launches = device_summary(prof, args.steps)
    smi = card_line()
    head_ce = parts["head_ce_fwd"] + parts["head_ce_bwd"]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "model": "gpt2-small", "batch": BATCH, "seq": SEQ,
        "remat": args.remat, "nccl_world1": args.nccl_world1, "loss": (
            "loss_pallas" if args.loss_pallas else
            f"loss_chunk_tokens={args.loss_chunk_tokens}"
            if args.loss_chunk_tokens else "monolithic"),
        "profiled_steps": args.steps,
        "wall_ms_per_step": wall_unprofiled * 1e3,
        "wall_ms_per_step_profiled": wall * 1e3,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1 - busy / (wall_unprofiled * 1e3)),
        "kernel_launches_per_step": launches,
        "families_ms_per_step": families,
        "parts_ms": parts, "head_gemms_f32_ms": head_gemm_ms,
        "fused_ce_kernels_ms": fused_ms,
        "head_ce_ms": head_ce, "ce_without_head_gemms_ms":
            head_ce - head_gemm_ms}))
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
