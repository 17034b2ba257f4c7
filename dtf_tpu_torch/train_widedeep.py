"""Wide&Deep CTR training (the port of ``scripts/train_widedeep.py``),
BASELINE config 5.

    python -m dtf_tpu_torch.train_widedeep                    # on the GPU
    python -m dtf_tpu_torch.train_widedeep --device=cpu --hash_buckets=500 \\
        --batch_size=64 --train_steps=2

The JAX launcher's flags and flow: model (``--hash_buckets`` rows per
categorical feature, ``--embed_dim``) → the JAX package's init
distributions, seeded → Adam at the launcher's defaults (batch 512, lr
1e-3, 300 steps; ``--optimizer`` and ``--clip_grad_norm`` as elsewhere)
→ data (a Criteo TSV/CSV in ``--data_dir``, else the synthetic
``widedeep`` stream) → hooks (logging with ``examples_per_sec``,
checkpoints, preemption, and — only when training is synthetic — a
held-out eval on a ``seed + 1`` stream every ``--eval_every`` steps, or
at the end) → ``Trainer.fit`` → ``done: step=N``. A relaunch into the
same ``--logdir`` resumes from its newest checkpoint.

On one process the tables are looked up whole (``RowShardedEmbed``,
``index_select``), as the reference's GSPMD path does on a mesh whose
``model`` axis is 1. Over processes (``--worker_hosts``, one per device)
``--mesh_model N`` row-shards both tables over N ranks (``widedeep.rules``:
each holds 1/N of the 2.6M rows) and looks them up with the masked
lookup and one all-reduce of [batch, dim], the B8 gather on every step;
the dense half stays replicated, and ``--mesh_data`` splits the batch as
for GPT. ``--telemetry`` and ``--profile_steps`` are not ported and raise.
"""

from __future__ import annotations

import argparse
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
        prog="python -m dtf_tpu_torch.train_widedeep",
        description="Wide&Deep CTR training on the H100 port.")
    dflags.define_cluster_flags(p)
    dflags.define_mesh_flags(p)
    dflags.define_train_flags(p, batch_size=512, learning_rate=1e-3,
                              train_steps=300)
    p.add_argument("--hash_buckets", type=int, default=100_000,
                   help="rows per categorical feature")
    p.add_argument("--embed_dim", type=int, default=16,
                   help="deep embedding width")
    p.add_argument("--eval_every", type=int, default=0,
                   help="held-out CTR eval every N steps (0 = final eval "
                        "only)")
    # the port's own
    p.add_argument("--device", default=None, help="cuda (default) | cpu")
    return p


def run(argv=None):
    """Parse, train, and return ``(state, writer)``; ``main`` prints the
    final step."""
    args = build_parser().parse_args(argv)
    for name, default in UNPORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name}={getattr(args, name)!r}: not yet ported (the "
                f"port runs with its default {default!r})")

    from dtf_tpu_torch import optim
    from dtf_tpu_torch.checkpoint import Checkpointer
    from dtf_tpu_torch.cli.launch import host_batches, setup
    from dtf_tpu_torch.convert import init_params_widedeep, params_from_flax
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.core.sharding import make_layout
    from dtf_tpu_torch.data.formats import detect_criteo_data
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.hooks import (CheckpointHook, EvalHook, LoggingHook,
                                     PreemptionHook, StopAtStepHook)
    from dtf_tpu_torch.loop import Trainer, place_batch
    from dtf_tpu_torch.metrics import MetricWriter
    from dtf_tpu_torch.models import widedeep

    device, info, mesh = setup(args)
    model = widedeep.WideDeep(hash_buckets=args.hash_buckets,
                              embed_dim=args.embed_dim, device=device,
                              mesh=mesh)
    # ZeRO-1 on, the JAX package's create_train_state default
    layout = (make_layout(dict(model.named_parameters()), mesh,
                          widedeep.rules, zero1=True)
              if mesh is not None else None)
    full = params_from_flax(init_params_widedeep(model, args.seed))
    model.load_state_dict(full if layout is None else {
        n: layout.shard_param(n, t, mesh) for n, t in full.items()})
    del full
    sched = optim.make_lr_schedule(args)        # LoggingHook shows the LR
    tx = optim.make_optimizer(args, optim.adam)
    state = tr.create_train_state(model, tx, args.seed, mesh=mesh,
                                  layout=layout)
    step = tr.make_train_step(widedeep.make_loss(model), tx,
                              grad_accum=args.grad_accum, mesh=mesh)

    data = host_batches(mesh, lambda **host: detect_criteo_data(
        args.data_dir, args.batch_size, hash_buckets=args.hash_buckets,
        seed=args.seed, **host))
    if data is None:
        if args.data_dir:
            log.warning("no criteo csv/tsv in %s; using synthetic data",
                        args.data_dir)
        data = host_batches(mesh, lambda **host: SyntheticData(
            "widedeep", args.batch_size, seed=args.seed,
            hash_buckets=args.hash_buckets, **host))

    writer = MetricWriter(echo=info.is_chief)
    ckpt = Checkpointer(os.path.join(args.logdir, "ckpt"),
                        save_interval_steps=args.checkpoint_every, mesh=mesh)
    # held-out CTR eval on a disjoint synthetic stream (seed + 1) only when
    # training itself is synthetic: real Criteo data with no holdout split
    # skips eval rather than score on unrelated rows
    eval_hook = None
    if isinstance(data, SyntheticData):
        held_out = host_batches(mesh, lambda **host: SyntheticData(
            "widedeep", args.batch_size, seed=args.seed + 1,
            hash_buckets=args.hash_buckets, **host))
        eval_hook = EvalHook(
            tr.make_eval_step(widedeep.make_eval(model), mesh),
            lambda: (held_out.batch(10_000_000 + i) for i in range(4)),
            writer, args.eval_every or args.train_steps,
            place_batch=lambda b: place_batch(b, device))
    else:
        log.warning("real Criteo training data with no holdout split; "
                    "skipping periodic eval")
    hooks = [LoggingHook(writer, args.log_every, lr_schedule=sched,
                         tokens_per_step=args.batch_size,
                         throughput_name="examples_per_sec"),
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
