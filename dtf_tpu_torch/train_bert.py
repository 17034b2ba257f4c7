"""BERT masked-LM pretraining (the port of ``scripts/train_bert.py``),
BASELINE config 4: BERT-base with gradient accumulation and ZeRO-1.

    python -m dtf_tpu_torch.train_bert --grad_accum=4          # on the GPU
    python -m dtf_tpu_torch.train_bert --device=cpu --size=tiny \\
        --batch_size=8 --seq_len=32 --train_steps=2

The JAX launcher's flags, defaults and flow: BERT-base (or ``--size
tiny``), seq 128, global batch 64, lr 1e-4 under a cosine schedule with
warmup → AdamW with weight decay 0.01 (or ``--optimizer``: lamb and
adafactor too) → the model with the JAX package's init, seeded
(``convert.init_params_bert``) → data (a token ``.bin`` in
``--data_dir`` with BERT's dynamic masking, else the synthetic ``bert``
stream) → the MLM loss (full logits; ``--loss_chunk_vocab`` the
vocab-chunked CE against the tied embedding; ``--mlm_gather`` that many
gathered positions a row) → hooks (logging, checkpoints, preemption, the
held-out eval every ``--eval_every`` steps or at the end) →
``Trainer.fit`` → ``done: step=N``. Attention runs the flash kernels
(B1 forward, B2/B3 backward, with the key-padding mask) on ``cuda``
(``--attn_impl=auto``). A relaunch into the same ``--logdir`` resumes
from its newest checkpoint.

Over processes (``--worker_hosts``, one per device) ``--mesh_data``
splits the global batch, ``--grad_accum`` cuts microbatches of the
global batch as the reference does (the ranks exchange rows first), and
ZeRO-1 (on by default) shards the optimizer state; ``--grad_shard``
resolves against the reference's blockers. ``--mesh_model`` > 1 (tensor
parallelism), ``--mesh_seq`` > 1 (ring attention), ``--telemetry`` and
``--profile_steps`` raise "not yet ported".
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

#: flags of the JAX launcher whose features the port does not have yet:
#: setting one away from its default raises
UNPORTED = {"profile_steps": 0, "telemetry": False}

log = logging.getLogger("dtf_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    from dtf_tpu_torch.cli import flags as dflags

    p = argparse.ArgumentParser(
        prog="python -m dtf_tpu_torch.train_bert",
        description="BERT MLM pretraining on the H100 port.")
    dflags.define_cluster_flags(p)
    dflags.define_mesh_flags(p)
    dflags.define_train_flags(p, batch_size=64, learning_rate=1e-4,
                              train_steps=200, lr_schedule="cosine")
    add_bool = dflags.add_bool
    p.add_argument("--seq_len", type=int, default=128)
    p.add_argument("--size", default="base", help="base | tiny")
    add_bool(p, "zero1", True, "shard optimizer state over the data axis "
             "(ZeRO-1)")
    p.add_argument("--attn_impl", default="auto",
                   help="auto (flash on cuda) | dense | flash")
    add_bool(p, "tp_overlap", False, "collective matmuls for the tensor-"
             "parallel projections (needs --mesh_model > 1: not yet "
             "ported)")
    p.add_argument("--eval_every", type=int, default=0,
                   help="held-out MLM eval every N steps; 0 = final only")
    p.add_argument("--loss_chunk_vocab", type=int, default=0,
                   help="the MLM loss fused with the tied-embedding decode "
                        "in vocab chunks of this width (0 = full logits)")
    p.add_argument("--mlm_gather", type=int, default=0,
                   help="score only this many gathered masked positions a "
                        "row (BERT's max_predictions_per_seq; 0 = all)")
    # the port's own
    p.add_argument("--device", default=None, help="cuda (default) | cpu")
    return p


def run(argv=None):
    """Parse, train, and return ``(state, writer)``; ``main`` prints the
    final step."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.size not in ("base", "tiny"):
        parser.error(f"--size={args.size!r}: base | tiny")
    # the reference's usage errors, before anything that is not ported
    if (args.loss_chunk_vocab or args.mlm_gather) and args.mesh_model > 1:
        parser.error("--loss_chunk_vocab/--mlm_gather cannot combine with "
                     "--mesh_model: the tied embedding is vocab-sharded "
                     "under TP, which the hidden-states loss paths would "
                     "fight")
    if args.mlm_gather and args.mesh_seq > 1:
        parser.error("--mlm_gather cannot combine with --mesh_seq: the "
                     "per-row gather indexes across the whole sequence")
    for name, default in UNPORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name}={getattr(args, name)!r}: not yet ported (the "
                f"port runs with its default {default!r})")
    if args.mesh_model > 1:
        raise NotImplementedError(
            f"--mesh_model={args.mesh_model}: BERT over a model axis "
            "(tensor parallelism, --tp_overlap) is not yet ported")
    if args.mesh_seq > 1:
        raise NotImplementedError(
            f"--mesh_seq={args.mesh_seq}: BERT over a sequence axis (ring "
            "attention) is not yet ported")
    if args.tp_overlap:
        log.warning("--tp_overlap has no effect without --mesh_model>1 (no "
                    "TP collectives to hide); proceeding on the plain path")

    from dtf_tpu_torch import optim
    from dtf_tpu_torch.checkpoint import Checkpointer, save_model_config
    from dtf_tpu_torch.cli import flags as dflags
    from dtf_tpu_torch.cli.launch import host_batches, lm_eval_hook, setup
    from dtf_tpu_torch.convert import init_params_bert, params_from_flax
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.core.sharding import make_layout
    from dtf_tpu_torch.data.formats import detect_token_data
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.hooks import (CheckpointHook, LoggingHook,
                                     PreemptionHook, StopAtStepHook)
    from dtf_tpu_torch.loop import Trainer
    from dtf_tpu_torch.metrics import (MetricWriter,
                                       analytic_lm_flops_per_step,
                                       param_count)
    from dtf_tpu_torch.models import bert

    device, info, mesh = setup(args)
    base = (bert.BertConfig.base() if args.size == "base"
            else bert.BertConfig.tiny())
    cfg = dataclasses.replace(base, attn_impl=args.attn_impl)
    eff_attn = bert.effective_attn_impl(cfg.attn_impl, device)
    sched = optim.make_lr_schedule(args)        # LoggingHook shows the LR
    tx = optim.make_optimizer(
        args, lambda s: optim.adamw(s, weight_decay=(
            args.weight_decay if args.weight_decay >= 0 else 0.01)),
        recipe_uses_wd=True)
    model = bert.BertMLM(cfg, device=device)
    model.load_state_dict(params_from_flax(init_params_bert(model,
                                                            args.seed)))
    layout = (make_layout(dict(model.named_parameters()), mesh,
                          zero1=args.zero1) if mesh is not None else None)
    state = tr.create_train_state(model, tx, args.seed, mesh=mesh,
                                  layout=layout)

    data = host_batches(mesh, lambda **host: detect_token_data(
        args.data_dir, args.batch_size, args.seq_len, mode="mlm",
        vocab_size=cfg.vocab_size, seed=args.seed, **host))
    if data is None:
        if args.data_dir:
            log.warning("no token .bin in %s; using synthetic data",
                        args.data_dir)
        data = host_batches(mesh, lambda **host: SyntheticData(
            "bert", args.batch_size, seed=args.seed, seq_len=args.seq_len,
            vocab_size=cfg.vocab_size, **host))
    # the reference's blockers: its flash runs in a shard_map that the
    # per-shard-group accumulation cannot nest
    blockers = []
    if eff_attn != "dense":
        blockers.append(f"attention impl {eff_attn!r} runs in shard_map "
                        "(use --attn_impl=dense)")
    if not args.zero1:
        blockers.append("--nozero1 (the sharded update needs ZeRO-1's "
                        "optimizer state)")
    grad_shard = dflags.resolve_grad_shard(
        args, data_axis=mesh.data_size if mesh is not None else 1,
        blockers=blockers)
    loss_opts = dict(loss_chunk=args.loss_chunk_vocab,
                     mlm_gather=args.mlm_gather)
    step = tr.make_train_step(bert.make_loss(model, mesh=mesh, **loss_opts),
                              tx, grad_accum=args.grad_accum, mesh=mesh,
                              grad_shard=grad_shard)

    tokens_per_step = args.batch_size * args.seq_len
    model_flops = analytic_lm_flops_per_step(
        n_params=param_count(state.params), layers=cfg.layers,
        width=cfg.hidden, seq_len=args.seq_len,
        tokens_per_step=tokens_per_step)
    writer = MetricWriter(echo=info.is_chief)
    ckpt = Checkpointer(os.path.join(args.logdir, "ckpt"),
                        save_interval_steps=args.checkpoint_every, mesh=mesh)
    if info.is_chief:
        save_model_config(ckpt.directory, {
            "model": "bert", "size": args.size,
            "vocab_size": cfg.vocab_size, "hidden": cfg.hidden,
            "layers": cfg.layers, "heads": cfg.heads,
            "intermediate": cfg.intermediate, "seq_len": args.seq_len})
    eval_hook = lm_eval_hook(args, device, bert.make_eval(model, **loss_opts),
                             writer, mesh, kind="bert", mode="mlm",
                             vocab_size=cfg.vocab_size)
    # mfu is a device metric against the H100's peak: on the card only
    hooks = [LoggingHook(writer, args.log_every, lr_schedule=sched,
                         tokens_per_step=tokens_per_step,
                         model_flops_per_step=(model_flops
                                               if device.type == "cuda"
                                               else None)),
             CheckpointHook(ckpt, args.checkpoint_every),
             PreemptionHook(ckpt, mesh=mesh),
             *([eval_hook] if eval_hook else []),
             StopAtStepHook(args.train_steps)]
    trainer = Trainer(step, device, hooks, checkpointer=ckpt,
                      prefetch=args.prefetch_depth)
    state = trainer.fit(state, data)
    writer.close()
    ckpt.close()
    return state, writer


def main(argv=None) -> int:
    from dtf_tpu_torch.cli.launch import own_process_group

    with own_process_group():
        state, _ = run(sys.argv[1:] if argv is None else list(argv))
    print(f"done: step={int(state.step)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
