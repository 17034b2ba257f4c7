"""Measure the port's ResNet-50 train step on the GPU (``bench.py``'s
recipe, BASELINE's headline metric: images/s a card).

    python -m dtf_tpu_torch.profile_resnet [--batch 128 256] [--steps 20]
        [--nccl_world1]

ResNet-50 v1.5 at full width (224×224×3, 1000 classes, bf16 compute,
f32 parameters and BatchNorm statistics), the trainer's init (seed 0),
SGD 0.1 with momentum 0.9, no loss-side L2 and no ``grad_norm`` metric,
as ``bench.py`` builds it; ONE fixed batch of random images held on the
card. For each ``--batch``:

0. 3 warm-up steps, then ``--steps`` timed steps, synchronised by
   reading the loss back (host clock): **step ms**, **images/s** and the
   **analytic MFU**, images/s × 3 × 4.09e9 FLOPs an image over 989e12
   (the H100's dense bf16 peak; ``dtf_tpu.telemetry.accounting``'s
   ResNet-50 constant), and the peak device memory;
1. the step's parts with CUDA events (second of two passes): forward and
   loss, backward, optimizer;
2. ``--steps`` steps under ``torch.profiler``: device busy ms a step,
   the idle share (busy against the unprofiled wall), launches a step and
   device ms by family — convolutions (cuDNN), cuBLAS's GEMMs (the 1×1
   convolutions cuDNN hands it, the head), BatchNorm's fused kernels,
   ReLU, residual adds and the other elementwise work, the max-pool, the
   optimizer, NCCL — and BatchNorm's own device ms, every kernel inside
   its forward and its backward (ranges annotated here).

``--plain_batchnorm``: BatchNorm runs the port's plain f32 ops on the
card too (``models.resnet._plain_forward``), not PyTorch's fused
kernels: the measurement that chose the fused ones.

``--nccl_world1``: the step runs inside a process group of ONE over
NCCL (``--mesh_data 1``, ZeRO-1 on): every collective of the
data-parallel step runs, and every BatchNorm all-reduces its sums
forward and their cotangents backward (two NCCL calls a layer, 106 a
step) — what synchronised BatchNorm costs at world 1.

Prints the top kernels, then one JSON line a batch with the card's name
and power limit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import time

from dtf_tpu_torch.profile_train import card_line, device_summary

#: ResNet-50 v1.5 at 224: 4.09e9 forward FLOPs an image, training 3×
#: (``dtf_tpu.telemetry.accounting.RESNET50_TRAIN_FLOPS_PER_IMG``)
TRAIN_FLOPS_PER_IMAGE = 3 * 4.09e9
#: the H100 SXM's dense bf16 tensor-core peak
H100_BF16_PEAK = 989e12
WARMUP = 3

#: kernel families, first match wins (kernel names as the profiler
#: reports them; cuDNN's convolutions on Hopper are sm90 xmma / cutlass
#: implicit GEMMs and their layout transforms)
FAMILIES = (
    ("nccl", re.compile(r"nccl", re.I)),
    ("max-pool", re.compile(r"max_pool", re.I)),
    ("batchnorm (fused kernels)", re.compile(r"batch_norm", re.I)),
    ("conv (cuDNN)", re.compile(
        r"xmma|fprop|dgrad|wgrad|implicit|convolve|conv2d|cudnn", re.I)),
    # cuBLAS's GEMMs: the head's, and the 1×1 convolutions cuDNN hands
    # to it
    ("gemm (cuBLAS: 1x1 convs, head)", re.compile(r"gemm|nvjet|cutlass",
                                                  re.I)),
    ("optimizer (multi-tensor)", re.compile(r"multi_tensor_apply|foreach",
                                            re.I)),
    ("relu", re.compile(r"threshold|clamp|relu", re.I)),
    ("reductions", re.compile(r"reduce_kernel|reduce", re.I)),
    ("cast / copy / pad", re.compile(
        r"copy_kernel|direct_copy|to_copy|constant_pad|cat", re.I)),
)
BN_RANGES = ("batchnorm_forward", "batchnorm_backward")


@contextlib.contextmanager
def _batchnorm_ranges(resnet):
    """BatchNorm's forward and backward inside profiler ranges while the
    block runs (this script's measurement only)."""
    from torch.profiler import record_function

    base = resnet._BatchNormTrain

    class Annotated(base):
        @staticmethod
        def forward(ctx, *args):
            with record_function(BN_RANGES[0]):
                return base.forward(ctx, *args)

        @staticmethod
        def backward(ctx, *grads):
            with record_function(BN_RANGES[1]):
                return base.backward(ctx, *grads)

    resnet._BatchNormTrain = Annotated
    try:
        yield
    finally:
        resnet._BatchNormTrain = base


def _range_ms(prof, steps):
    """Device ms a step of every kernel launched inside each BatchNorm
    range (the host-side range, whose device time sums its ops' kernels;
    the profiler's device-side copy of the range is its span)."""
    import torch

    out = {n: 0.0 for n in BN_RANGES}
    for e in prof.events():
        if e.name in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name] += e.device_time_total / 1e3 / steps
    return out


def measure(batch: int, steps: int, mesh) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dtf_tpu_torch import optim
    from dtf_tpu_torch.convert import (init_params_resnet, params_from_flax,
                                       stats_from_flax)
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.core.sharding import make_layout
    from dtf_tpu_torch.models import resnet

    model = resnet.resnet50(device="cuda", group=(
        mesh.data_group if mesh is not None else None))
    variables = init_params_resnet(model, 0)
    model.load_state_dict({**params_from_flax(variables["params"]),
                           **stats_from_flax(variables["batch_stats"])})
    layout = (make_layout(dict(model.named_parameters()), mesh, zero1=True)
              if mesh is not None else None)
    tx = optim.sgd(0.1, momentum=0.9)
    state = tr.create_train_state(model, tx, 0, mesh=mesh, layout=layout)
    loss_fn = resnet.make_loss(model)
    step = tr.make_train_step(loss_fn, tx, log_grad_norm=False, mesh=mesh,
                              model=model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {"image": torch.rand((batch, 224, 224, 3), device="cuda",
                                generator=gen),
            "label": torch.randint(0, 1000, (batch,), device="cuda",
                                   generator=gen, dtype=torch.int32)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(WARMUP):
        state, m = step(state, data)
    float(m["loss"])
    warmup_s = time.perf_counter() - t0

    # 0. the timed window: the step chain is sequential, so reading the
    # last loss back synchronises all of it
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, data)
    loss = float(m["loss"])
    wall = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated()

    # 1. the parts of one step, CUDA events between them; two passes
    params = state.params
    model.train()
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        lo, _ = loss_fn(params, data, 0)
        ev[1].record()
        grads = dict(zip(params, torch.autograd.grad(
            lo, list(params.values()))))
        ev[2].record()
        if mesh is None:
            updates, opt_state = tx.update(grads, state.opt_state, params)
            optim.apply_updates(params, updates)
            state.opt_state = opt_state
        ev[3].record()
        torch.cuda.synchronize()
        parts = dict(zip(("forward_loss", "backward", "optimizer"),
                         (ev[i].elapsed_time(ev[i + 1]) for i in range(3))))
        del lo, grads
    if mesh is not None:
        parts.pop("optimizer")          # the sharded update is the step's

    # 2. whole steps under the profiler
    with _batchnorm_ranges(resnet), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, data)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) / steps
    families, busy, launches = device_summary(prof, steps, FAMILIES)
    bn = _range_ms(prof, steps)
    images = batch / wall
    del model, state, data, params
    return {
        "model": "resnet50", "batch": batch, "image": [224, 224, 3],
        "timed_steps": steps, "warmup_steps": WARMUP, "warmup_s": warmup_s,
        "nccl_world1": mesh is not None, "loss_last": loss,
        "step_ms": wall * 1e3, "images_per_s": images,
        "mfu_analytic": images * TRAIN_FLOPS_PER_IMAGE / H100_BF16_PEAK,
        "max_memory_allocated": peak,
        "wall_ms_per_step_profiled": wall_prof * 1e3,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
        "kernel_launches_per_step": launches,
        "families_ms_per_step": families,
        "batchnorm_ms_per_step": bn, "parts_ms": parts}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dtf_tpu_torch.profile_resnet")
    p.add_argument("--batch", type=int, nargs="+", default=[128, 256],
                   help="the fixed batch sizes to measure, in turn")
    p.add_argument("--steps", type=int, default=20,
                   help="timed steps, then profiled steps")
    p.add_argument("--plain_batchnorm", action="store_true",
                   help="BatchNorm as plain f32 ops on the card (the "
                        "ablation of the fused kernels)")
    p.add_argument("--nccl_world1", action="store_true",
                   help="the step inside a process group of one over NCCL, "
                        "ZeRO-1 on, BatchNorm synchronised over it")
    args = p.parse_args(argv)

    import gc

    import torch

    from dtf_tpu_torch.models import resnet

    if args.plain_batchnorm:
        resnet._batchnorm_impl = lambda x: (resnet._plain_forward,
                                            resnet._plain_backward)
    mesh = None
    if args.nccl_world1:
        import torch.distributed as dist

        from dtf_tpu_torch.core.dist import free_port
        from dtf_tpu_torch.core.mesh import MeshConfig, make_mesh

        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{free_port()}", world_size=1, rank=0)
        mesh = make_mesh(MeshConfig(data=1), torch.device("cuda", 0))
    try:
        for batch in args.batch:
            out = measure(batch, args.steps, mesh)
            print(json.dumps({"device": torch.cuda.get_device_name(0),
                              "nvidia_smi": card_line(),
                              "plain_batchnorm": args.plain_batchnorm,
                              **out}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
