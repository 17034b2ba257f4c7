"""Launch glue (the port's copy of ``dtf_tpu.cli.launch.setup``): flags →
cluster collapse → one device."""

from __future__ import annotations

import logging
import sys

import torch

from dtf_tpu_torch.core import dist
from dtf_tpu_torch.core.device import resolve_device

log = logging.getLogger("dtf_tpu_torch")

MESH_AXES = ("data", "seq", "model", "pipe", "expert")


def setup(args) -> tuple[torch.device, dist.ClusterInfo]:
    """Resolve the cluster and the device from parsed flags. A ps role
    exits the process with status 0; ``--issync=false`` warns and runs
    synchronously; any mesh axis > 1, or more than one worker, raises:
    multi-GPU training is not yet ported."""
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
    big = {a: getattr(args, f"mesh_{a}") for a in MESH_AXES
           if getattr(args, f"mesh_{a}") > 1}
    if big or info.num_processes > 1:
        raise NotImplementedError(
            f"not yet ported (multi-GPU): mesh {big or {}} / "
            f"{info.num_processes} worker(s); this slice trains on one "
            "device")
    device = resolve_device(getattr(args, "device", None) or
                            ("cpu" if args.backend == "cpu" else "cuda"))
    return device, info
