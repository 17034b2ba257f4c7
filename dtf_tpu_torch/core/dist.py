"""Cluster-flag collapse (the port's copy of ``dtf_tpu.core.dist``).

The reference's ``--ps_hosts/--worker_hosts/--job_name/--task_index``
flags are accepted and collapsed: there is no parameter-server role (a
ps process exits 0), every worker is one process, and the chief is task
0. This slice runs one process on one device; more than one worker is
the multi-GPU slice's (``torch.distributed`` over NCCL).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence

log = logging.getLogger("dtf_tpu_torch")


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    """Resolved cluster identity after collapsing ps/worker flags."""

    num_processes: int
    process_id: int
    is_chief: bool
    #: True for --job_name=ps: the process has no role and exits 0
    should_exit: bool = False


def collapse_cluster_flags(ps_hosts: Sequence[str] = (),
                           worker_hosts: Sequence[str] = (),
                           job_name: str = "worker",
                           task_index: int = 0) -> ClusterInfo:
    """Workers → processes (world size = len(worker_hosts), min 1); ps
    hosts warned and dropped; ``job_name=ps`` → no role (exit 0); chief =
    task 0."""
    worker_hosts = [h for h in worker_hosts if h]
    ps_hosts = [h for h in ps_hosts if h]
    if ps_hosts:
        log.warning("--ps_hosts=%s ignored: there are no parameter servers; "
                    "parameters live on the device.", ",".join(ps_hosts))
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
    return ClusterInfo(num_processes=num, process_id=task_index,
                       is_chief=(task_index == 0))
