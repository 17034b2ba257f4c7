"""MNIST softmax training — the reference repo's ``distributed.py`` (the port
of ``scripts/distributed.py``), BASELINE config 1.

Launch-compatible with the reference: the same command shape works, one
process per worker plus the ps, e.g. on the CPU over gloo

    python -m dtf_tpu_torch.distributed --backend=cpu \\
        --ps_hosts=localhost:2222 --worker_hosts=localhost:2223,localhost:2224 \\
        --job_name=worker --task_index=0 --issync=1

or one worker per GPU over NCCL (``--backend=gpu``, the default). The
ps/worker roles collapse: a ps process exits 0, the workers form one
process group (rendezvous at the first worker's address) and train
synchronously (``--issync=0`` warns and runs synchronously), each on its
rows of the global ``--batch_size``, the gradient the mean over ranks.
The reference's defaults: batch 64, lr 0.01, 200 steps, plain SGD,
``--model softmax`` (or ``mlp``). Data: the MNIST IDX files in
``--data_dir``, else the synthetic ``mnist`` stream. After training, a
held-out eval (the test split, or a held-out synthetic batch), reduced
over ranks; every worker prints ``done: step=N eval_accuracy=...``.
``DTF_FAULT_INJECT``'s training verbs fire at their seeded step
(:mod:`dtf_tpu_torch.fault.inject`).
"""

from __future__ import annotations

import argparse
import itertools
import logging
import os
import sys

log = logging.getLogger("dtf_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    from dtf_tpu_torch.cli import flags as dflags

    p = argparse.ArgumentParser(
        prog="python -m dtf_tpu_torch.distributed",
        description="MNIST softmax training, launch-compatible with the "
                    "reference's distributed.py.")
    dflags.define_cluster_flags(p)
    dflags.define_mesh_flags(p)
    dflags.define_train_flags(p, batch_size=64, learning_rate=0.01,
                              train_steps=200)
    p.add_argument("--model", default="softmax", choices=("softmax", "mlp"))
    # the port's own
    p.add_argument("--device", default=None, help="cuda (default) | cpu")
    return p


def run(argv=None):
    """Parse, train, evaluate; returns ``(state, writer, eval_metrics)``
    (``eval_metrics`` None when the test split is too small for one batch
    a rank)."""
    args = build_parser().parse_args(argv)
    if args.profile_steps or args.telemetry:
        raise NotImplementedError("--profile_steps / --telemetry: not yet "
                                  "ported")

    from dtf_tpu_torch import optim
    from dtf_tpu_torch.checkpoint import Checkpointer
    from dtf_tpu_torch.cli.launch import host_batches, setup
    from dtf_tpu_torch.convert import init_params_mnist, params_from_flax
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.core.sharding import make_layout
    from dtf_tpu_torch.data import mnist as mnist_data
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.fault import inject
    from dtf_tpu_torch.hooks import (CheckpointHook, LoggingHook,
                                     PreemptionHook, StopAtStepHook)
    from dtf_tpu_torch.loop import Trainer, place_batch
    from dtf_tpu_torch.metrics import MetricWriter
    from dtf_tpu_torch.models import mnist as mnist_model

    device, info, mesh = setup(args)
    if mesh is not None and mesh.model_size > 1:
        raise NotImplementedError("--mesh_model > 1 for MNIST (tensor "
                                  "parallelism): not yet ported")
    model = mnist_model.make_model(args.model, device=device)
    model.load_state_dict(params_from_flax(init_params_mnist(model,
                                                             args.seed)))
    # GradientDescentOptimizer's counterpart: the reference used plain SGD
    sched = optim.make_lr_schedule(args)        # LoggingHook shows the LR
    tx = optim.make_optimizer(args, optim.sgd)
    layout = (make_layout(dict(model.named_parameters()), mesh, zero1=True)
              if mesh is not None else None)
    state = tr.create_train_state(model, tx, args.seed, mesh=mesh,
                                  layout=layout)
    step = tr.make_train_step(mnist_model.make_loss(model), tx,
                              grad_accum=args.grad_accum, mesh=mesh)
    real = bool(args.data_dir) and mnist_data.available(args.data_dir)
    if args.data_dir and not real:
        log.warning("MNIST files not found in %s; using synthetic data",
                    args.data_dir)

    def loader(split, seed, **host):
        if real:
            return mnist_data.MnistData(args.data_dir, args.batch_size,
                                        split=split, seed=seed, **host)
        return SyntheticData("mnist", args.batch_size, seed=seed, **host)

    data = host_batches(mesh, lambda **host: loader("train", args.seed,
                                                    **host))
    writer = MetricWriter(echo=info.is_chief)
    ckpt = Checkpointer(os.path.join(args.logdir, "ckpt"),
                        save_interval_steps=args.checkpoint_every, mesh=mesh)
    hooks = [LoggingHook(writer, args.log_every, lr_schedule=sched,
                         tokens_per_step=args.batch_size,
                         throughput_name="examples_per_sec"),
             CheckpointHook(ckpt, args.checkpoint_every),
             PreemptionHook(ckpt, mesh=mesh),
             StopAtStepHook(args.train_steps)]
    fault = inject.maybe_hook(host_index=info.process_id, checkpointer=ckpt)
    if fault is not None:
        hooks.insert(0, fault)   # injected faults land before save hooks
    state = Trainer(step, device, hooks, checkpointer=ckpt,
                    prefetch=args.prefetch_depth).fit(state, data)

    # the reference printed the test accuracy at the end: the whole test
    # split (each rank its rows, the same number of batches on every rank,
    # or the reductions would not meet), or one held-out synthetic batch
    test = host_batches(mesh, lambda **host: loader("test", args.seed,
                                                    **host))
    batches = (itertools.islice(iter(test), test.batches_per_epoch_uniform())
               if real else [test.batch(10_000_019)])
    eval_step = tr.make_eval_step(mnist_model.make_eval(model), mesh)
    totals, n = {}, 0
    for b in batches:
        for k, v in eval_step(state, place_batch(b, device)).items():
            totals[k] = totals.get(k, 0.0) + float(v)
        n += 1
    metrics = {k: v / n for k, v in totals.items()} if n else None
    if metrics is not None:
        writer.write_scalars(int(state.step), metrics)
    writer.close()
    ckpt.close()
    return state, writer, metrics


def main(argv=None) -> int:
    """Every worker prints ``done:``, as the reference's did."""
    from dtf_tpu_torch.cli.launch import own_process_group

    logging.basicConfig(level=logging.WARNING)
    with own_process_group():
        state, _, metrics = run(sys.argv[1:] if argv is None
                                   else list(argv))
    summary = (f"eval_accuracy={metrics['eval_accuracy']:.4f}"
               if metrics is not None else "eval_accuracy=n/a")
    print(f"done: step={int(state.step)} {summary}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
