"""The device mesh over processes (counterpart of ``dtf_tpu.core.mesh``).

One process per device. ``MeshConfig.resolve`` splits the world size
over the axes ``(data, pipe, expert, seq, model)`` as the reference does,
``data`` the slowest: rank = data coordinate · (pipe · expert · seq ·
model) + … + model coordinate. :func:`make_mesh` builds one process group
per line of the ``data`` axis and one per line of the ``model`` axis:

- ``data``: batches split over it, gradients reduced over it
  (``SyncReplicasOptimizer``'s mean), ZeRO-1 shards optimizer state over
  it;
- ``model``: row-sharded embedding tables (Wide&Deep) and Megatron
  tensor parallelism (GPT: :mod:`dtf_tpu_torch.core.comms`' TP
  operators and rings over this group).

``seq``, ``pipe`` and ``expert`` > 1 raise "not yet ported".
"""

from __future__ import annotations

import dataclasses
import math

import torch

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"
#: canonical axis order, data the slowest-varying (the reference's)
AXES = (AXIS_DATA, AXIS_PIPE, AXIS_EXPERT, AXIS_SEQ, AXIS_MODEL)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``data=-1`` means "all remaining devices"."""

    data: int = -1
    seq: int = 1
    model: int = 1
    pipe: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int, int]:
        """(data, pipe, expert, seq, model) over ``n_devices``."""
        rest = (self.pipe, self.expert, self.seq, self.model)
        if any(s <= 0 for s in rest):
            raise ValueError("pipe/expert/seq/model axis sizes must be "
                             f"positive, got {self}")
        rest_prod = math.prod(rest)
        data = self.data
        if data == 0 or data < -1:
            raise ValueError(
                f"data axis size must be positive or -1 (infer), got {self}")
        if data == -1:
            if n_devices % rest_prod:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"pipe*expert*seq*model={rest_prod}")
            data = n_devices // rest_prod
        if data * rest_prod != n_devices:
            raise ValueError(
                f"mesh data={data} x {rest} != {n_devices} devices")
        return (data,) + rest


@dataclasses.dataclass(frozen=True)
class HostView:
    """Host ``k`` of ``N``: which rows of the global batch it produces."""

    host_index: int
    host_count: int

    def __post_init__(self):
        if self.host_count < 1:
            raise ValueError(f"host_count must be >= 1, got {self.host_count}")
        if not (0 <= self.host_index < self.host_count):
            raise ValueError(
                f"host_index {self.host_index} out of range for "
                f"{self.host_count} hosts")

    def batch_rows(self, global_rows: int) -> tuple[int, int]:
        """[start, stop) of the global-batch rows this host produces (the
        loaders' ``local_batch = global // host_count`` contract)."""
        if global_rows % self.host_count:
            raise ValueError(
                f"global batch {global_rows} not divisible by "
                f"{self.host_count} hosts")
        n = global_rows // self.host_count
        return self.host_index * n, (self.host_index + 1) * n


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh and the process groups of its data
    and model lines. ``device`` is where collectives of small host-made
    values (counts, flags) are staged: NCCL takes CUDA tensors only."""

    data_size: int
    model_size: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object
    device: torch.device

    @property
    def host_view(self) -> HostView:
        """The loaders' identity: the DATA coordinate, so every rank of
        one model group reads the same rows."""
        return HostView(self.data_index, self.data_size)


def refuse_unported(config: MeshConfig) -> None:
    """``seq``, ``pipe`` or ``expert`` > 1 raise "not yet ported"."""
    unported = {a: getattr(config, a) for a in (AXIS_SEQ, AXIS_PIPE,
                                                AXIS_EXPERT)
                if getattr(config, a) > 1}
    if unported:
        raise NotImplementedError(
            f"mesh axes {unported}: not yet ported (the port has the data "
            "and model axes)")


def make_mesh(config: MeshConfig, device: torch.device) -> Mesh:
    """The mesh over the default process group (which must exist: a
    world of one is a group of one). Every rank makes every group, in
    the same order, as ``new_group`` requires."""
    import torch.distributed as dist

    refuse_unported(config)
    world, rank = dist.get_world_size(), dist.get_rank()
    data, _, _, _, model = config.resolve(world)
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    d, m = divmod(rank, model)
    return Mesh(data_size=data, model_size=model, data_index=d,
                model_index=m, data_group=data_groups[m],
                model_group=model_groups[d], device=device)


def mesh_summary(mesh: Mesh) -> str:
    return (f"mesh data={mesh.data_size} model={mesh.model_size} "
            f"(rank at data {mesh.data_index}, model {mesh.model_index}; "
            f"{mesh.device})")
