"""Cluster flags and the process group (the port's copy of ``dtf_tpu.core.dist``).

The reference's ``--ps_hosts/--worker_hosts/--job_name/--task_index``
flags are accepted and collapsed: there is no parameter-server role (a
ps process exits 0), every worker is one process on one device, and the
chief is task 0. Bootstrap is ``torch.distributed.init_process_group``
over the first worker's address (NCCL on GPUs, gloo on the CPU), where
the reference calls ``jax.distributed.initialize``. The JAX package's
fake-hosts harness has no counterpart: gloo runs real processes on the
CPU.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence

import torch

log = logging.getLogger("dtf_tpu_torch")


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    """Resolved cluster identity after collapsing ps/worker flags."""

    num_processes: int
    process_id: int
    is_chief: bool
    #: ``host:port`` of worker 0, where the process group rendezvouses;
    #: None for one worker
    coordinator_address: str | None = None
    #: True for --job_name=ps: the process has no role and exits 0
    should_exit: bool = False

    @property
    def host_count(self) -> int:
        """Processes feeding the input pipeline (== num_processes; spelled
        separately so call sites say which concept they mean)."""
        return self.num_processes

    @property
    def participates_in_save(self) -> bool:
        """Every process takes part in a save: the gathers of sharded
        state are collective, and the chief alone writes
        (:class:`dtf_tpu_torch.checkpoint.Checkpointer`)."""
        return True

    def local_host_ids(self) -> tuple[int, int]:
        """(host_index, host_count) of this process among all of them.
        The loaders read by the data coordinate instead
        (:meth:`dtf_tpu_torch.core.mesh.Mesh.host_view`), which is this
        when the mesh has no model axis."""
        return self.process_id, self.num_processes


def collapse_cluster_flags(ps_hosts: Sequence[str] = (),
                           worker_hosts: Sequence[str] = (),
                           job_name: str = "worker",
                           task_index: int = 0) -> ClusterInfo:
    """Workers → processes (world size = len(worker_hosts), min 1); ps
    hosts warned and dropped; ``job_name=ps`` → no role (exit 0); chief =
    task 0; the coordinator is worker 0's address."""
    worker_hosts = [h for h in worker_hosts if h]
    ps_hosts = [h for h in ps_hosts if h]
    if ps_hosts:
        log.warning("--ps_hosts=%s ignored: there are no parameter servers; "
                    "parameters live on the devices.", ",".join(ps_hosts))
    num = max(len(worker_hosts), 1)
    if job_name == "ps":
        n_ps = max(len(ps_hosts), 1)
        if not (0 <= task_index < n_ps):
            raise ValueError(
                f"--task_index={task_index} out of range for {n_ps} ps tasks")
        return ClusterInfo(num_processes=num, process_id=0, is_chief=False,
                           should_exit=True)
    if not (0 <= task_index < num):
        raise ValueError(
            f"--task_index={task_index} out of range for {num} workers")
    return ClusterInfo(
        num_processes=num, process_id=task_index, is_chief=(task_index == 0),
        coordinator_address=worker_hosts[0] if num > 1 else None)


def rank_device(rank: int, device_type: str) -> torch.device:
    """``cuda:{rank % device_count}`` on GPUs (one process per device),
    else the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_nccl_devices(backend: str, world_size: int) -> None:
    """NCCL needs a device of its own per rank: say so before NCCL
    fails less clearly (two ranks on one card run over gloo)."""
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise RuntimeError(
            f"{world_size} NCCL ranks on {torch.cuda.device_count()} GPU(s): "
            "NCCL needs one GPU per rank (run more ranks than GPUs over "
            "gloo, in a process group made before the launch)")


def initialize(info: ClusterInfo, backend: str) -> None:
    """Start the process group of a multi-worker launch:
    ``init_process_group(backend, tcp://<coordinator>, world size,
    rank=task index)``. Nothing to do for one worker or a ps, or when the
    default group exists already (a caller that made its own group, as
    ``jax.distributed.is_initialized()`` makes the reference skip)."""
    import torch.distributed as dist

    if info.num_processes <= 1 or info.should_exit or dist.is_initialized():
        return
    check_nccl_devices(backend, info.num_processes)
    dist.init_process_group(
        backend, init_method=f"tcp://{info.coordinator_address}",
        world_size=info.num_processes, rank=info.process_id)



def free_port() -> int:
    """A TCP port on localhost that is free now, for a rendezvous on one
    machine (``tcp://localhost:<port>``)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]
