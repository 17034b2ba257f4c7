"""Collectives and projections (counterpart of ``dtf_tpu.core.comms``).

The named-axis collectives (``psum``, ``pmean``, ``psum_scatter``,
``all_gather``) run on ``torch.distributed`` over a process group (one
line of a mesh axis, :mod:`dtf_tpu_torch.core.mesh`) where the reference
runs ``jax.lax`` collectives inside ``shard_map``, each returning a new
tensor; ``global_norm`` and :class:`GradBuckets` (whose
``grad_reduce_scatter`` is the reference's choke point of that name)
are the data-parallel and ZeRO-1 pieces of the train step.

Projections: ``tp_dense`` / ``TpDense``, only the unsharded,
full-precision case: ``mesh=None`` and ``precision=""``. Tensor
parallelism, the collective-matmul rings and the int8/fp8 tiers come
with later slices. The product is a plain ``torch.matmul`` — XLA
computed it outside any Pallas kernel too.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks of ``group`` (the gradient push of the
    reference's ps, and its NCCL ring)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over the ranks of ``group``."""
    return psum(x, group) / dist.get_world_size(group)


def _single(name: str):
    # the tensor-in, tensor-out collectives took these names in torch 2.13;
    # the card's torch has only the older ones
    return getattr(dist, name, None)


def psum_scatter(x: torch.Tensor, group, *, scatter_dimension: int = 0
                 ) -> torch.Tensor:
    """Reduce-scatter, tiled: the sum over ``group``, of which rank k
    keeps block k of ``scatter_dimension`` (which the group size must
    divide). The building block of ZeRO-1."""
    n = dist.get_world_size(group)
    xs = x.movedim(scatter_dimension, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"psum_scatter: dim {scatter_dimension} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    out = xs.new_empty((xs.shape[0] // n,) + xs.shape[1:])
    (_single("reduce_scatter_single") or dist.reduce_scatter_tensor)(
        out, xs, group=group)
    return out.movedim(0, scatter_dimension)


def all_gather(x: torch.Tensor, group, *, gather_dimension: int = 0
               ) -> torch.Tensor:
    """All-gather, tiled: the ranks' blocks of ``gather_dimension`` in
    rank order."""
    n = dist.get_world_size(group)
    xs = x.movedim(gather_dimension, 0).contiguous()
    out = xs.new_empty((xs.shape[0] * n,) + xs.shape[1:])
    (_single("all_gather_single") or dist.all_gather_into_tensor)(
        out, xs, group=group)
    return out.movedim(0, gather_dimension)


def global_norm(tensors: dict, mesh, zero1=(), model=()) -> torch.Tensor:
    """The L2 norm, in f32, of a tree of which the leaves named in
    ``zero1`` are this rank's ZeRO-1 blocks over the data group, those in
    ``model`` this rank's blocks over the model group (a leaf may be in
    both), and the rest whole on every rank: every element's square
    counted once, as the reference's norm over global arrays counts it.

    A split leaf's squared sum enters one sum over the mesh (ONE
    ``all_reduce`` over the default group, which the mesh spans) from one
    rank of each set of ranks that hold the same elements: a leaf split
    over both axes from every rank, over data only from model index 0,
    over the model axis only from data index 0. The whole leaves' squares
    are added once, after. With no split leaf there is no collective."""
    zero1, model = set(zero1), set(model)
    device = next(iter(tensors.values())).device

    def sq(names):
        total = torch.zeros((), dtype=torch.float32, device=device)
        ts = [tensors[n].float() for n in tensors if n in names]
        for n in torch._foreach_norm(ts) if ts else ():
            total = total + n * n
        return total

    whole = sq(set(tensors) - zero1 - model)
    if not (zero1 or model):
        return torch.sqrt(whole)
    split = sq(zero1 & model)
    if mesh.model_index == 0:
        split = split + sq(zero1 - model)
    if mesh.data_index == 0:
        split = split + sq(model - zero1)
    dist.all_reduce(split)
    return torch.sqrt(split + whole)


class GradBuckets:
    """A step's gradients laid out for their sum over ``group`` in two
    collectives, whatever the number of leaves (one collective a leaf
    costs the host ~0.2 ms each on NCCL).

    The leaves that ZeRO-1 shards (``dims``: name → dim) form one
    [n, m] f32 buffer whose row r holds rank r's block of each such leaf
    (the leaf with its sharded dim moved first, cut into n blocks), so
    one reduce-scatter leaves every rank its own blocks, summed
    (:meth:`grad_reduce_scatter`: half the bytes of an all-reduce); the
    other leaves form one flat f32 buffer, all-reduced whole.
    :meth:`split` gives each leaf back as a view, :meth:`all_gather_into`
    the updated blocks back into whole parameters, in one all-gather."""

    def __init__(self, like: dict, group, dims: dict):
        self.group = group
        self.n = dist.get_world_size(group)
        self.shapes = {k: tuple(t.shape) for k, t in like.items()}
        self.dims = {k: d for k, d in dims.items()
                     if k in like and d is not None}
        self.sharded = [k for k in like if k in self.dims]
        self.whole = [k for k in like if k not in self.dims]

    def _moved(self, k):
        """Leaf k's shape with its sharded dim first."""
        shape, d = self.shapes[k], self.dims[k]
        return (shape[d],) + shape[:d] + shape[d + 1:]

    def flatten(self, grads: dict) -> list:
        """The buffers (each present kind: the [n, m] sharded one, then
        the whole one), f32 copies of ``grads``."""
        out = []
        if self.sharded:
            out.append(torch.cat([
                grads[k].float().movedim(self.dims[k], 0).reshape(self.n, -1)
                for k in self.sharded], dim=1))
        if self.whole:
            out.append(torch.cat([grads[k].float().reshape(-1)
                                  for k in self.whole]))
        return out

    def grad_reduce_scatter(self, flats: list) -> list:
        """The sums over the group: of the sharded buffer this rank's row
        (one reduce-scatter; the ``--grad_shard`` choke point), of the
        whole one all of it (one all-reduce, in place)."""
        out = list(flats)
        if self.sharded:
            mine = out[0].new_empty(out[0].shape[1])
            (_single("reduce_scatter_single") or dist.reduce_scatter_tensor)(
                mine, out[0].reshape(-1), group=self.group)
            out[0] = mine
        if self.whole:
            dist.all_reduce(out[-1], group=self.group)
        return out

    def split(self, flats: list) -> dict:
        """Each leaf as a view of the reduced buffers: this rank's block
        of a sharded leaf, a whole leaf whole."""
        out = {}
        if self.sharded:
            pieces = flats[0].split([math.prod(self.shapes[k]) // self.n
                                     for k in self.sharded])
            for k, piece in zip(self.sharded, pieces):
                moved = self._moved(k)
                out[k] = piece.view((moved[0] // self.n,) + moved[1:]) \
                    .movedim(0, self.dims[k])
        if self.whole:
            pieces = flats[-1].split([math.prod(self.shapes[k])
                                      for k in self.whole])
            for k, piece in zip(self.whole, pieces):
                out[k] = piece.view(self.shapes[k])
        return {k: out[k] for k in self.shapes}

    @torch.no_grad()
    def all_gather_into(self, params: dict, blocks: dict) -> None:
        """Every rank's (updated) blocks of the sharded leaves into the
        whole ``params``, IN PLACE: one all-gather."""
        if not self.sharded:
            return
        mine = torch.cat([blocks[k].movedim(self.dims[k], 0).reshape(-1)
                          for k in self.sharded])
        full = mine.new_empty(self.n * mine.numel())
        (_single("all_gather_single") or dist.all_gather_into_tensor)(
            full, mine, group=self.group)
        rows = full.view(self.n, -1).split(
            [blocks[k].numel() for k in self.sharded], dim=1)
        for k, seg in zip(self.sharded, rows):
            params[k].copy_(seg.reshape(self._moved(k))
                            .movedim(0, self.dims[k]))


def tp_dense(x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None, mesh=None, *, parallel: str,
             dtype: torch.dtype | None = None,
             precision: str = "") -> torch.Tensor:
    """``x @ weight.T + bias`` with x, the weight and the bias cast to
    ``dtype`` first (as flax's ``Dense(dtype=...)`` does). ``weight`` is
    [out, in], torch's ``Linear`` layout (flax kernels are [in, out])."""
    if parallel not in ("column", "row"):
        raise ValueError(f"parallel={parallel!r} must be 'column' or 'row'")
    if mesh is not None:
        raise NotImplementedError(
            "tp_dense over a mesh (tensor parallelism) is not ported yet")
    if precision not in ("", "bf16"):
        raise NotImplementedError(
            f"tp_dense precision={precision!r} (quantized tiers) is not "
            "ported yet")
    if dtype is not None:
        x = x.to(dtype)
        weight = weight.to(dtype)
        bias = bias.to(dtype) if bias is not None else None
    y = torch.matmul(x, weight.t())
    return y if bias is None else y + bias


class TpDense(nn.Module):
    """A linear layer whose parameters stay f32 and whose product runs at
    ``dtype``: ``weight`` [features, in], ``bias`` [features]."""

    def __init__(self, in_features: int, features: int, *, parallel: str,
                 dtype: torch.dtype | None = None, use_bias: bool = True,
                 device=None):
        super().__init__()
        self.parallel = parallel
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(
            features, in_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(
            features, dtype=torch.float32, device=device))
            if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp_dense(x, self.weight, self.bias, parallel=self.parallel,
                        dtype=self.dtype)
