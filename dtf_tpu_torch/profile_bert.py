"""Measure the port's BERT-base MLM train step on the GPU (BASELINE config
4: grad-accum + ZeRO-1).

    python -m dtf_tpu_torch.profile_bert [--grad_accum 1 4] [--steps 20]
        [--mlm_gather 20] [--loss_chunk_vocab 8192] [--nccl_world1]

BERT-base at full width (vocab 30,522, hidden 768, 12 layers of 12 heads,
bf16 compute, f32 parameters), the trainer's init (seed 0), the
launcher's AdamW (lr 1e-4, weight decay 0.01), seq 128 and global batch
64 (``--batch``, ``--seq_len``), dropout 0.1; ONE fixed synthetic ``bert``
batch held on the card. For each ``--grad_accum``:

0. 3 warm-up steps, then ``--steps`` timed steps, synchronised by
   reading the loss back (host clock): **step ms**, **tokens/s**, the
   **analytic MFU** ((6·N + 12·L·d·s) · tokens over 989e12, the H100's
   dense bf16 peak; the JAX package's ``analytic_lm_flops_per_step``),
   the peak device memory, and the flash launches a step (B1, B2, B3:
   12 each a microbatch);
1. the MLM head alone (the f32 tied decode + CE, forward and backward,
   on hidden states of the microbatch's shape, the step's loss options),
   CUDA events over 5 calls, times ``grad_accum``: its ms a step and its
   share of the step;
2. ``--profile_steps`` steps (default ``--steps``) under
   ``torch.profiler``: device busy ms a step, the
   idle share (busy against the unprofiled wall), launches a step and
   device ms by family — B1, B2, B3, cuBLAS's f32 GEMMs (the tied head),
   its bf16 GEMMs (the trunk), the optimizer, NCCL, and the rest
   (LayerNorm, GELU, dropout, casts and reductions).

``--mlm_gather N`` / ``--loss_chunk_vocab N``: the loss path of
``train_bert``'s flags of those names. ``--nccl_world1``: the step in a
process group of ONE over NCCL (``--mesh_data 1``, ZeRO-1 on), so every
collective of the data-parallel step runs.

Prints the top kernels, then one JSON line a configuration with the
card's name and power limit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import time

from dtf_tpu_torch.profile_train import card_line, device_summary

#: the H100 SXM's dense bf16 tensor-core peak
H100_BF16_PEAK = 989e12
WARMUP = 3
#: calls of the head alone that the events time
HEAD_CALLS = 5

#: kernel families, first match wins. cuBLAS's IEEE-f32 GEMMs (TF32 off;
#: the only f32 products of the step are the tied head's) carry f32 /
#: sgemm in their names; the bf16 ones are the trunk's
FAMILIES = (
    ("flash_fwd (B1)", re.compile(r"flash_fwd_kernel")),
    ("flash_dq (B2)", re.compile(r"flash_bwd_dq_kernel")),
    ("flash_dkv (B3)", re.compile(r"flash_bwd_dkv_kernel")),
    ("nccl", re.compile(r"nccl", re.I)),
    ("gemm f32 (tied MLM head)", re.compile(
        r"sgemm|f32f32_f32f32|gemm.*_sss_|tf32", re.I)),
    ("gemm bf16 (trunk)", re.compile(r"gemm|nvjet|xmma|cutlass", re.I)),
    ("optimizer (multi-tensor)", re.compile(r"multi_tensor_apply|foreach",
                                            re.I)),
    ("layernorm", re.compile(r"layer_norm|LayerNorm|GammaBeta", re.I)),
)


def _head_ms(model, batch, grad_accum, loss_chunk, mlm_gather):
    """The MLM head (decode + CE) forward and backward on f32 hidden
    states of one microbatch's shape, ms a step (× grad_accum)."""
    import torch

    from dtf_tpu_torch.models import bert

    rows = batch["mlm_labels"].shape[0] // grad_accum
    labels = batch["mlm_labels"][:rows]
    gen = torch.Generator(device="cuda").manual_seed(1)
    h = torch.randn(labels.shape + (model.cfg.hidden,), device="cuda",
                    generator=gen).requires_grad_()
    wrt = (h, model.token_embed.weight, model.mlm_bias)
    key = bert.DropoutKey(3)

    def head():
        out = h
        if not (loss_chunk or mlm_gather):
            out = torch.matmul(h, model.token_embed.weight.t()) \
                + model.mlm_bias
        loss, _ = bert._mlm_ce(model, out, labels, loss_chunk, mlm_gather,
                               key)
        return torch.autograd.grad(loss, wrt)

    head()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(HEAD_CALLS):
        head()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / HEAD_CALLS * grad_accum


def measure(*, grad_accum: int, steps: int, batch: int = 64,
            seq_len: int = 128, loss_chunk: int = 0, mlm_gather: int = 0,
            mesh=None, profile_steps: int = 0) -> dict:
    """One configuration's numbers (module docstring); ``profile_steps``
    steps under the profiler (0: ``steps``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dtf_tpu_torch import optim
    from dtf_tpu_torch.convert import init_params_bert, params_from_flax
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.core.sharding import make_layout
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.metrics import analytic_lm_flops_per_step, param_count
    from dtf_tpu_torch.models import bert
    from dtf_tpu_torch.ops import flash_attention as fa

    cfg = bert.BertConfig.base()
    model = bert.BertMLM(cfg, device="cuda")
    model.load_state_dict(params_from_flax(init_params_bert(model, 0)))
    layout = (make_layout(dict(model.named_parameters()), mesh, zero1=True)
              if mesh is not None else None)
    tx = optim.adamw(1e-4, weight_decay=0.01)
    state = tr.create_train_state(model, tx, 0, mesh=mesh, layout=layout)
    step = tr.make_train_step(
        bert.make_loss(model, loss_chunk=loss_chunk, mlm_gather=mlm_gather,
                       mesh=mesh), tx, grad_accum=grad_accum, mesh=mesh)
    data = {k: torch.from_numpy(v).cuda() for k, v in SyntheticData(
        "bert", batch, seed=0, seq_len=seq_len,
        vocab_size=cfg.vocab_size).batch(0).items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(WARMUP):
        state, m = step(state, data)
    float(m["loss"])
    warmup_s = time.perf_counter() - t0

    # 0. the timed window: the step chain is sequential, so reading the
    # last loss back synchronises all of it
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, data)
    loss = float(m["loss"])
    wall = (time.perf_counter() - t0) / steps
    launches = {k: v / steps for k, v in fa.launch_counts.items()}
    peak = torch.cuda.max_memory_allocated()

    # 1. the head alone
    head = _head_ms(model, data, grad_accum, loss_chunk, mlm_gather)

    # 2. whole steps under the profiler
    profile_steps = profile_steps or steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(profile_steps):
            state, m = step(state, data)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) / profile_steps
    families, busy, kernel_launches = device_summary(prof, profile_steps,
                                                     FAMILIES)
    tokens = batch * seq_len
    flops = analytic_lm_flops_per_step(
        n_params=param_count(state.params), layers=cfg.layers,
        width=cfg.hidden, seq_len=seq_len, tokens_per_step=tokens)
    fa.reset_launch_counts()
    del model, state, data
    return {
        "model": "bert-base", "batch": batch, "seq_len": seq_len,
        "grad_accum": grad_accum, "loss_chunk_vocab": loss_chunk,
        "mlm_gather": mlm_gather, "zero1": mesh is not None,
        "nccl_world1": mesh is not None, "timed_steps": steps,
        "profiled_steps": profile_steps,
        "warmup_steps": WARMUP, "warmup_s": warmup_s, "loss_last": loss,
        "step_ms": wall * 1e3, "tokens_per_s": tokens / wall,
        "mfu_analytic": flops / wall / H100_BF16_PEAK,
        "model_flops_per_step": flops,
        "max_memory_allocated": peak,
        "flash_launches_per_step": launches,
        "head_ms_per_step": head, "head_share": head / (wall * 1e3),
        "wall_ms_per_step_profiled": wall_prof * 1e3,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
        "kernel_launches_per_step": kernel_launches,
        "families_ms_per_step": families}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dtf_tpu_torch.profile_bert")
    p.add_argument("--grad_accum", type=int, nargs="+", default=[1, 4],
                   help="the microbatch counts to measure, in turn")
    p.add_argument("--steps", type=int, default=20,
                   help="timed steps, then profiled steps")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="profiled steps (0: --steps)")
    p.add_argument("--batch", type=int, default=64, help="global batch")
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--mlm_gather", type=int, default=0,
                   help="score this many gathered masked positions a row")
    p.add_argument("--loss_chunk_vocab", type=int, default=0,
                   help="the vocab-chunked MLM loss, chunks of this width")
    p.add_argument("--nccl_world1", action="store_true",
                   help="the step inside a process group of one over NCCL, "
                        "ZeRO-1 on")
    args = p.parse_args(argv)

    import gc

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False     # the head in IEEE f32
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
        for accum in args.grad_accum:
            out = measure(grad_accum=accum, steps=args.steps,
                          batch=args.batch, seq_len=args.seq_len,
                          loss_chunk=args.loss_chunk_vocab,
                          mlm_gather=args.mlm_gather, mesh=mesh,
                          profile_steps=args.profile_steps)
            print(json.dumps({"device": torch.cuda.get_device_name(0),
                              "nvidia_smi": card_line(), **out}),
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
