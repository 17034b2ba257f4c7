"""Launch glue (the port's copy of ``dtf_tpu.cli.launch``): flags → cluster
collapse → process group → mesh → this rank's device and loader."""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import sys

import torch

from dtf_tpu_torch.core import dist
from dtf_tpu_torch.core.device import resolve_device
from dtf_tpu_torch.core.mesh import AXES, HostView, MeshConfig, \
    make_mesh, mesh_summary, refuse_unported

log = logging.getLogger("dtf_tpu_torch")


def setup(args):
    """Resolve the cluster, the device and the mesh from parsed flags;
    returns ``(device, info, mesh)``, the mesh None for one process with
    no process group.

    A ps role exits the process with status 0; ``--issync=false`` warns
    and runs synchronously. More than one worker starts the process group
    (NCCL for ``--backend gpu``, gloo for ``cpu``; one process per
    device, rank = ``--task_index`` on ``cuda:{rank % device_count}``).
    A default group that exists already (one the caller made) is used as
    it is, whatever its backend. ``--mesh_seq/pipe/expert`` > 1 raise
    "not yet ported"; a mesh of more than one device without a group
    raises."""
    info = dist.collapse_cluster_flags(
        ps_hosts=[h for h in args.ps_hosts.split(",") if h],
        worker_hosts=[h for h in args.worker_hosts.split(",") if h],
        job_name=args.job_name, task_index=args.task_index)
    if info.should_exit:
        log.warning("ps role has no work in the port; exiting 0")
        sys.exit(0)
    if not args.issync:
        log.warning("--issync=0 (async PS SGD) is not reproduced: "
                    "proceeding with synchronous updates")
    if getattr(args, "devices_per_host", 0):
        raise NotImplementedError(
            "--devices_per_host (the fake-hosts harness's mesh size): not "
            "yet ported; the port runs one process per device")
    sizes = {a: getattr(args, f"mesh_{a}") for a in AXES}
    refuse_unported(MeshConfig(**sizes))
    kind = torch.device(getattr(args, "device", None) or
                        ("cpu" if args.backend == "cpu" else "cuda")).type
    dist.initialize(info, "nccl" if kind == "cuda" else "gloo")
    import torch.distributed as tdist

    if not tdist.is_initialized():
        big = {a: s for a, s in sizes.items() if s > 1}
        if big:
            raise ValueError(
                f"mesh {big} needs one process per device, and this launch "
                "is one process: give --worker_hosts (one per process) and "
                "--task_index")
        return resolve_device(kind), info, None
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if info.num_processes > 1 and (info.num_processes, info.process_id) \
            != (world, rank):
        raise ValueError(
            f"worker {info.process_id} of {info.num_processes} on the flags "
            f"but rank {rank} of {world} in the process group")
    info = dataclasses.replace(info, num_processes=world, process_id=rank,
                               is_chief=rank == 0)
    if tdist.get_backend() == "nccl":
        dist.check_nccl_devices("nccl", world)
    device = resolve_device(dist.rank_device(rank, kind))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = make_mesh(MeshConfig(**sizes), device)
    if info.is_chief:
        log.info("%s | %d process(es)", mesh_summary(mesh), world)
    return device, info, mesh


def host_batches(mesh, make_loader):
    """This rank's loader: ``make_loader(host_index=, host_count=)`` at
    the rank's DATA coordinate (every rank of one model group reads the
    same rows); the one global loader without a mesh."""
    view = mesh.host_view if mesh is not None else HostView(0, 1)
    return make_loader(host_index=view.host_index,
                       host_count=view.host_count)


@contextlib.contextmanager
def own_process_group():
    """On leaving, destroy the default process group if the body made it
    (one that existed before is its maker's)."""
    import torch.distributed as tdist

    existed = tdist.is_initialized()
    try:
        yield
    finally:
        if not existed and tdist.is_initialized():
            tdist.destroy_process_group()


def lm_eval_hook(args, device, eval_fn, writer, mesh, *, kind: str,
                 mode: str, vocab_size: int):
    """The held-out eval of the LM launchers (the one copy of its policy):
    ``<data_dir>/val.bin`` when present; a synthetic ``kind`` stream at
    seed+1 only when training itself is synthetic; none (with a warning)
    for real tokens without a val split. 4 batches a sweep, each rank its
    rows, the metrics reduced over the data group."""
    from dtf_tpu_torch.core import train as tr
    from dtf_tpu_torch.data.formats import TokenBinData, detect_token_data
    from dtf_tpu_torch.data.synthetic import SyntheticData
    from dtf_tpu_torch.hooks import EvalHook
    from dtf_tpu_torch.loop import place_batch

    eval_data = host_batches(mesh, lambda **host: detect_token_data(
        args.data_dir, args.batch_size, args.seq_len, mode=mode,
        vocab_size=vocab_size, seed=args.seed, split="val", **host))
    if eval_data is not None:
        def batches():
            return (eval_data.batch(i) for i in range(4))
    elif args.data_dir and TokenBinData.available(args.data_dir):
        log.warning("no val.bin in %s; skipping held-out eval rather than "
                    "scoring on synthetic data", args.data_dir)
        return None
    else:
        held_out = host_batches(mesh, lambda **host: SyntheticData(
            kind, args.batch_size, seed=args.seed + 1, seq_len=args.seq_len,
            vocab_size=vocab_size, **host))

        def batches():
            return (held_out.batch(10_000_000 + i) for i in range(4))
    return EvalHook(tr.make_eval_step(eval_fn, mesh), batches, writer,
                    args.eval_every or args.train_steps,
                    place_batch=lambda b: place_batch(b, device))
