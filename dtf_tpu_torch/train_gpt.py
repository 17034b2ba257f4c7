"""GPT causal-LM training (the port of ``scripts/train_gpt.py``).

    python -m dtf_tpu_torch.train_gpt --size=small --batch_size=8 --seq_len=1024
    python -m dtf_tpu_torch.train_gpt --device=cpu --size=tiny --train_steps=4

The JAX launcher's flags and flow: config → LR schedule and optimizer
(the recipe is AdamW, weight decay 0.1, cosine with warmup) → loss path
(``resolve_lm_loss``: monolithic logits when they fit the card's memory,
else the token-chunked loss; ``--loss_pallas`` runs the fused head + CE
kernels, ``--loss_chunk_tokens``/``--loss_chunk_vocab`` the chunked
losses) → state (the JAX package's init distributions,
seeded) → data (``--data_dir`` token ``.bin``, else the synthetic ``gpt``
stream) → ``model_config.json`` manifest → hooks → ``Trainer.fit`` →
``done: step=N``. Attention runs the flash kernels forward and backward
on ``cuda`` (``--attn_impl=auto``). A relaunch into the same ``--logdir``
resumes from its newest checkpoint, at the batch of the step it resumes.
``--publish_dir`` publishes the parameters every ``--publish_every``
steps and at the end as monotone versions (:mod:`dtf_tpu_torch.publish`)
for a serving fleet's rolling swap (``serve_gpt --swap_poll_ticks``).
``--event_log_dir`` writes the run's event log on the chief
(:mod:`dtf_tpu_torch.telemetry.events`: ``ckpt_save``,
``publish_version`` after each manifest commit, ``train_end``).
``DTF_FAULT_INJECT``'s training verbs (``crash@2``, ``sigterm@3``, …,
:mod:`dtf_tpu_torch.fault.inject`) fire at their seeded step.

More than one process (``--worker_hosts``, one process per device) is
data parallelism over ``--mesh_data``: each rank reads its rows of the
global ``--batch_size``, the gradient is the global batch's (one
all-reduce, or under ``--zero1``, on by default, a reduce-scatter, the
update on this rank's blocks of the optimizer state and an all-gather
of the parameters), and ``--loss_pallas`` runs the token-sharded fused
CE on each rank's tokens. The chief prints the metrics and writes the
checkpoint. ``--mesh_model`` > 1 is Megatron tensor parallelism over the
model axis (``models.gpt.GPT(mesh=)``: each rank its heads, MLP features
and vocab rows, the vocab-parallel CE; the ranks of one model group read
the same rows), the loss then always the monolithic one (a fused or
chunked loss is a usage error, as in the JAX launcher);
``--tp_overlap`` runs its projections as collective-matmul rings over a
token-sharded residual stream (Megatron-SP) and warns without a model
axis. Checkpoints and published versions hold whole tensors, so a run at
one ``--mesh_model`` resumes at another and ``serve_gpt`` loads its
versions unchanged. The other unported flags raise when set away from
their defaults (the ``UNPORTED`` table). ``--profile_on_demand`` is on
by default, as in the JAX launcher, and inert here: the profiler hooks
are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys

#: flags of the JAX launcher whose features the port does not have yet:
#: setting one away from its default raises
UNPORTED = {
    "moe_every": 0, "moe_top_k": 1, "matmul_precision": "",
    "pipe_microbatches": 0, "pipe_interleave": 1,
    "pipe_schedule": "gpipe", "stream_spec": "",
    "distill_draft": 0, "distill_from": "",
    "profile_steps": 0, "telemetry": False,
}

log = logging.getLogger("dtf_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    from dtf_tpu_torch.cli import flags as dflags

    p = argparse.ArgumentParser(
        prog="python -m dtf_tpu_torch.train_gpt",
        description="GPT causal-LM pretraining on the H100 port.")
    dflags.define_cluster_flags(p)
    dflags.define_mesh_flags(p)
    dflags.define_train_flags(p, batch_size=32, learning_rate=3e-4,
                              train_steps=200, lr_schedule="cosine")
    add_bool = dflags.add_bool
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--size", default="small",
                   help="small (gpt2-124M) | medium (gpt2-355M) | tiny")
    add_bool(p, "zero1", True, "shard optimizer state over the data axis "
             "(ZeRO-1)")
    p.add_argument("--moe_every", type=int, default=0)
    p.add_argument("--moe_top_k", type=int, default=1)
    add_bool(p, "remat", False, "recompute each block in the backward")
    p.add_argument("--kv_heads", type=int, default=0,
                   help="grouped-query attention K/V heads (0 = MHA)")
    p.add_argument("--attn_window", type=int, default=0,
                   help="sliding-window attention (0 = full causal)")
    p.add_argument("--attn_global_every", type=int, default=0,
                   help="with attn_window: every k-th layer is global")
    p.add_argument("--attn_impl", default="auto",
                   help="auto (flash on cuda) | dense | flash")
    add_bool(p, "tp_overlap", False)
    p.add_argument("--matmul_precision", default="",
                   choices=("", "auto", "bf16", "int8", "fp8"))
    p.add_argument("--pipe_microbatches", type=int, default=0)
    p.add_argument("--pipe_interleave", type=int, default=1)
    p.add_argument("--pipe_schedule", default="gpipe",
                   choices=("gpipe", "1f1b", "zb"))
    p.add_argument("--loss_chunk_vocab", type=int, default=0,
                   help="CE fused with the head in vocab chunks of this "
                        "width (0 = off)")
    p.add_argument("--loss_chunk_tokens", type=int, default=0,
                   help="CE fused with the head in token chunks of this "
                        "size (0 = off)")
    add_bool(p, "loss_pallas", False, "the fused head + CE kernels "
             "(B5-B7): no [B,T,V] logits in device memory")
    p.add_argument("--eval_every", type=int, default=0,
                   help="held-out eval every N steps; 0 = final only")
    p.add_argument("--publish_dir", default="")
    p.add_argument("--publish_every", type=int, default=100)
    p.add_argument("--event_log_dir", default="",
                   help="the run's event log (chief only): checkpoint saves "
                        "and fallbacks, weight publishes, the end of "
                        "training; read with "
                        "dtf_tpu_torch.telemetry.events.read_events")
    p.add_argument("--stream_spec", default="")
    p.add_argument("--distill_draft", type=int, default=0)
    p.add_argument("--distill_from", default="")
    # the port's own
    p.add_argument("--device", default=None, help="cuda (default) | cpu")
    return p


def run(argv=None):
    """Parse, train, and return ``(state, writer)``; ``main`` prints the
    final step."""
    parser = build_parser()
    args = parser.parse_args(argv)
    for name, default in UNPORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name}={getattr(args, name)!r}: not yet ported (the "
                f"port runs with its default {default!r})")
    if sum(map(bool, (args.loss_chunk_vocab, args.loss_chunk_tokens,
                      args.loss_pallas))) > 1:
        parser.error("--loss_chunk_vocab, --loss_chunk_tokens and "
                     "--loss_pallas are mutually exclusive — pick one "
                     "fused-loss strategy")
    from dtf_tpu_torch.models import gpt

    if args.mesh_model > 1 and (args.loss_chunk_vocab or
                                args.loss_chunk_tokens or args.loss_pallas):
        parser.error(gpt.TP_FUSED_LOSS_REFUSED)
    if args.tp_overlap and args.mesh_model <= 1:
        log.warning("--tp_overlap has no effect without --mesh_model>1 (no "
                    "TP collectives to hide); proceeding on the plain path")

    from dtf_tpu_torch import optim
    from dtf_tpu_torch.checkpoint import Checkpointer, save_model_config
    from dtf_tpu_torch.cli import flags as dflags
    from dtf_tpu_torch.cli.launch import host_batches, lm_eval_hook, setup
    from dtf_tpu_torch.convert import (init_params_flax, params_from_flax,
                                       shard_params)
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.core.sharding import make_layout
    from dtf_tpu_torch.data.formats import detect_token_data
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.fault import inject
    from dtf_tpu_torch.hooks import (CheckpointHook, LoggingHook,
                                     PreemptionHook, PublishHook,
                                     StopAtStepHook)
    from dtf_tpu_torch.loop import Trainer
    from dtf_tpu_torch.metrics import (MetricWriter,
                                       analytic_lm_flops_per_step,
                                       param_count)
    from dtf_tpu_torch.publish import ParamPublisher

    device, info, mesh = setup(args)
    tp = mesh is not None and mesh.model_size > 1
    try:
        base = gpt.GPTConfig.by_name(args.size)
    except KeyError as e:
        parser.error(f"--size: {e.args[0]}")
    cfg = dataclasses.replace(base, remat=args.remat,
                              attn_impl=args.attn_impl,
                              kv_heads=args.kv_heads or None,
                              attn_window=args.attn_window,
                              attn_global_every=args.attn_global_every,
                              tp_overlap=args.tp_overlap)
    sched = optim.make_lr_schedule(args)        # LoggingHook shows the LR
    tx = optim.make_optimizer(
        args, lambda s: optim.adamw(s, weight_decay=(
            args.weight_decay if args.weight_decay >= 0 else 0.1)),
        recipe_uses_wd=True)
    # auto loss path: monolithic logits when they fit the card's memory,
    # the token-chunked loss when they do not; explicit flags win
    lpath = dflags.resolve_lm_loss(
        args, batch=args.batch_size, seq_len=args.seq_len,
        vocab_size=cfg.vocab_size, device=device,
        model_axis=mesh.model_size if mesh is not None else 1)
    log.info("LM loss: %s (vocab chunk %d, token chunk %d, fused kernels "
             "%s)", lpath.source, lpath.chunk_vocab, lpath.chunk_tokens,
             lpath.pallas)
    model = gpt.GPT(cfg, device=device, mesh=mesh)
    layout = (make_layout(dict(model.named_parameters()), mesh,
                          gpt.tp_rules if tp else (), zero1=args.zero1)
              if mesh is not None else None)
    whole = params_from_flax(init_params_flax(cfg, args.seed))
    model.load_state_dict(shard_params(whole, layout, mesh) if tp else whole)
    n_params = param_count(whole)
    del whole
    loss_opts = dict(loss_chunk=lpath.chunk_vocab,
                     loss_chunk_tokens=lpath.chunk_tokens,
                     loss_pallas=lpath.pallas, mesh=mesh)
    loss_fn = gpt.make_loss(model, **loss_opts)
    eval_fn = gpt.make_eval(model, **loss_opts)
    state = tr.create_train_state(model, tx, args.seed, mesh=mesh,
                                  layout=layout)

    data = host_batches(mesh, lambda **host: detect_token_data(
        args.data_dir, args.batch_size, args.seq_len, mode="clm",
        vocab_size=cfg.vocab_size, seed=args.seed, **host))
    if data is None:
        if args.data_dir:
            log.warning("no token .bin in %s; using synthetic data",
                        args.data_dir)
        data = host_batches(mesh, lambda **host: SyntheticData(
            "gpt", args.batch_size, seed=args.seed, seq_len=args.seq_len,
            vocab_size=cfg.vocab_size, **host))
    grad_shard = dflags.resolve_grad_shard(
        args, data_axis=mesh.data_size if mesh is not None else 1,
        blockers=() if args.zero1 else ["--nozero1 (the sharded update "
                                        "needs ZeRO-1's optimizer state)"])
    step = tr.make_train_step(loss_fn, tx, grad_accum=args.grad_accum,
                              mesh=mesh, grad_shard=grad_shard)

    tokens_per_step = args.batch_size * args.seq_len
    model_flops = analytic_lm_flops_per_step(
        n_params=n_params, layers=cfg.layers,
        width=cfg.d_model, seq_len=args.seq_len,
        tokens_per_step=tokens_per_step)
    writer = MetricWriter(echo=info.is_chief)
    ckpt = Checkpointer(os.path.join(args.logdir, "ckpt"),
                        save_interval_steps=args.checkpoint_every, mesh=mesh)
    manifest_cfg = {
        "model": "gpt", "size": args.size,
        "kv_heads": args.kv_heads, "attn_window": args.attn_window,
        "attn_global_every": args.attn_global_every,
        "moe_every": args.moe_every, "vocab_size": cfg.vocab_size,
        "d_model": cfg.d_model, "layers": cfg.layers, "heads": cfg.heads,
        "d_ff": cfg.d_ff, "kv_cache_dtype": ""}
    publisher = events = None
    if info.is_chief:
        save_model_config(ckpt.directory, manifest_cfg)
        # the event log has one writer: the chief's
        if args.event_log_dir:
            from dtf_tpu_torch.telemetry.events import EventLog

            events = EventLog(args.event_log_dir)
            ckpt.attach_event_log(events)
        # only the process that saves publishes: two publishers over one
        # manifest would commit digests of each other's half-written
        # versions; the architecture manifest rides next to the publish
        # manifest, so a fleet serving only the publish dir resolves it
        if args.publish_dir:
            publisher = ParamPublisher(args.publish_dir)
            publisher.event_log = events
            save_model_config(args.publish_dir, manifest_cfg)

    def whole_params(st):
        return {n: layout.gather_param(n, p.detach(), mesh)
                for n, p in st.params.items()}

    eval_hook = lm_eval_hook(args, device, eval_fn, writer, mesh,
                             kind="gpt", mode="clm",
                             vocab_size=cfg.vocab_size)
    # mfu is a device metric against the H100's peak: on the card only
    hooks = [LoggingHook(writer, args.log_every, lr_schedule=sched,
                         tokens_per_step=tokens_per_step,
                         model_flops_per_step=(model_flops
                                               if device.type == "cuda"
                                               else None)),
             CheckpointHook(ckpt, args.checkpoint_every),
             # under TP every rank gathers the whole parameters for the
             # chief's publish
             *([PublishHook(publisher, args.publish_every,
                            params_of=whole_params if tp else None)]
               if publisher is not None or (tp and args.publish_dir)
               else []),
             PreemptionHook(ckpt, mesh=mesh),
             *([eval_hook] if eval_hook else []),
             StopAtStepHook(args.train_steps)]
    fault = inject.maybe_hook(host_index=info.process_id,
                              checkpointer=ckpt, publisher=publisher)
    if fault is not None:
        hooks.insert(0, fault)   # injected faults land before save hooks
    trainer = Trainer(step, device, hooks, checkpointer=ckpt,
                      prefetch=args.prefetch_depth)
    state = trainer.fit(state, data)
    writer.close()
    ckpt.close()
    if publisher is not None:
        publisher.close()
    if events is not None:
        events.emit("train_end", step=int(state.step))
        events.close()
    return state, writer


def main(argv=None) -> int:
    from dtf_tpu_torch.cli.launch import own_process_group

    with own_process_group():
        state, _ = run(sys.argv[1:] if argv is None else list(argv))
    print(f"done: step={int(state.step)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
