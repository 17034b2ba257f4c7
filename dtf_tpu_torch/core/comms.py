"""Collectives and projections (counterpart of ``dtf_tpu.core.comms``).

The named-axis collectives (``psum``, ``pmean``, ``psum_scatter``,
``all_gather``) run on ``torch.distributed`` over a process group (one
line of a mesh axis, :mod:`dtf_tpu_torch.core.mesh`) where the reference
runs ``jax.lax`` collectives inside ``shard_map``, each returning a new
tensor; ``global_norm`` and :class:`GradBuckets` (whose
``grad_reduce_scatter`` is the reference's choke point of that name)
are the data-parallel and ZeRO-1 pieces of the train step.

Megatron tensor parallelism over the model group. Torch has no
partitioner to insert the collectives GSPMD inserts, so they are
explicit, each an autograd Function with its conjugate backward:
:func:`copy_to_model` (identity forward, the sum over the group
backward: the input of the column-parallel projections that share it)
and :func:`reduce_from_model` (the sum forward, identity backward: the
row-parallel output and the vocab-parallel embedding); for the
Megatron-SP layout of ``--tp_overlap``, :func:`scatter_tokens` (this
rank's token block forward, the all-gather backward) and
:func:`gather_tokens` (the all-gather forward, the reduce-scatter
backward); and :class:`RingExchange`, one step of a ``ring_perm`` ring
(the collective-matmul rings of :mod:`dtf_tpu_torch.ops.collective_matmul`).
Each counts itself in :data:`collective_counts`. Sharded decode and
serving add their own, forward only (serving runs under ``no_grad``):
:func:`gather_vocab` (the vocab-parallel logits' rows made whole before a
sampler), :func:`gather_rows` (a data line's rows to every line) and the
broadcasts :func:`broadcast_from` and :func:`broadcast_object` (the
serving plane's calls, :mod:`dtf_tpu_torch.serve.plane`).

Projections: ``tp_dense`` / ``TpDense``, full precision only
(``precision=""``; the int8/fp8 tiers come with a later slice). Over a
model group the module holds this rank's block of the weight: the
column-parallel one its rows of the [out, in] weight and of the bias,
the row-parallel one its input columns and the whole bias. The product
is a plain ``torch.matmul`` — XLA computed it outside any Pallas kernel
too.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch
import torch.distributed as dist
from torch import nn


#: the collectives issued by :func:`psum` (over any group), by the
#: tensor-parallel operators below and by the sharded serving path, by
#: kind ("ring_exchange": one send and one receive of a ring step;
#: "broadcast": one tensor's, or one object's); a counter a test or the
#: chip smoke reads around a run. The other collectives of this module
#: (ZeRO-1's buckets, ``global_norm``, ``all_gather`` and ``psum_scatter``
#: called directly, as a checkpoint's gather does) are not counted
collective_counts = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
                     "ring_exchange": 0, "broadcast": 0}
#: the host seconds spent inside those calls, by kind (a blocking
#: collective's whole wait; a ring step's post and wait)
collective_seconds = dict.fromkeys(collective_counts, 0.0)


def reset_collective_counts() -> None:
    for k in collective_counts:
        collective_counts[k] = 0
        collective_seconds[k] = 0.0


@contextlib.contextmanager
def _collective(kind: str, count: int = 1):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        collective_counts[kind] += count
        collective_seconds[kind] += time.perf_counter() - t0


def psum(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """Sum (or ``op``) over the ranks of ``group`` (the gradient push of
    the reference's ps, and its NCCL ring), into a copy of ``x``."""
    out = x.clone(memory_format=torch.contiguous_format)
    with _collective("all_reduce"):
        dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
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


class CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, the sum over ``group`` backward.
    Every rank of the group holds the same input and feeds it to its own
    block of a column-parallel weight, so each rank's cotangent is a part
    of the whole one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: the sum over ``group`` forward (one all-reduce),
    identity backward: every rank runs the same computation downstream of
    the sum, so the cotangent each receives is already the whole one (the
    transpose of ``psum`` under ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _token_block(x: torch.Tensor, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    t = x.shape[1] // n
    return x[:, r * t:(r + 1) * t]


class _ScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _token_block(x, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        with _collective("all_gather"):
            return all_gather(g, ctx.group, gather_dimension=1), None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        with _collective("all_gather"):
            return all_gather(x, group, gather_dimension=1)

    @staticmethod
    def backward(ctx, g):
        with _collective("reduce_scatter"):
            return psum_scatter(g, ctx.group, scatter_dimension=1), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """:class:`CopyToGroup` over the model group: the input of the
    column-parallel projections on the plain TP path, once for all those
    that share it (one all-reduce of its cotangent, as GSPMD sums the
    partial cotangents before it reduces)."""
    return CopyToGroup.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """:class:`ReduceFromGroup` over the model group."""
    return ReduceFromGroup.apply(x, mesh.model_group)


def scatter_tokens(x: torch.Tensor, mesh) -> torch.Tensor:
    """Enter the Megatron-SP layout: of a [B, T, D] tensor whole on every
    rank of the model group, this rank's block of T/m tokens; the
    backward all-gathers the blocks' cotangents (the transpose of a
    slice of a replicated value under SPMD)."""
    return _ScatterTokens.apply(x, mesh.model_group)


def gather_tokens(x: torch.Tensor, mesh) -> torch.Tensor:
    """Leave the Megatron-SP layout with ONE activation gather over the
    model group (``tp_activation_gathered`` at the LM head): [B, T/m, D]
    blocks → [B, T, D]; the backward sums the ranks' cotangents (each a
    part: the head is vocab-parallel) and keeps this rank's block (one
    reduce-scatter)."""
    return _GatherTokens.apply(x, mesh.model_group)


def gather_vocab(x: torch.Tensor, mesh) -> torch.Tensor:
    """Whole rows of vocab-parallel logits: this rank's [..., V/m]
    columns → [..., V], the ranks' blocks in model order (one counted
    all-gather over the model group; forward only)."""
    with _collective("all_gather"):
        return all_gather(x, mesh.model_group, gather_dimension=x.ndim - 1)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``x`` [n, ...] → [N·n, ...] in rank order (one
    counted all-gather over ``group``): a data line's part of a sharded
    decode's output to every line."""
    with _collective("all_gather"):
        return all_gather(x, group, gather_dimension=0)


def broadcast_from(x: torch.Tensor, group, src_index: int) -> torch.Tensor:
    """``x`` of the group's rank ``src_index`` on every rank of ``group``,
    IN PLACE (one counted broadcast); returns ``x``."""
    with _collective("broadcast"):
        dist.broadcast(x, dist.get_global_rank(group, src_index),
                       group=group)
    return x


def broadcast_object(obj, src: int = 0):
    """A picklable ``obj`` of global rank ``src`` on every rank of the
    default group: one counted broadcast (the pickle's size and bytes,
    staged through the host under gloo); returns it."""
    box = [obj]
    with _collective("broadcast"):
        dist.broadcast_object_list(box, src=src)
    return box[0]


def ring_perm(n: int) -> list[tuple[int, int]]:
    """THE cyclic ring schedule (the reference's, copied): rank ``i`` of
    the group sends to ``(i + 1) % n``."""
    if n < 1:
        raise ValueError(f"ring_perm: axis size {n} must be >= 1")
    return [(i, (i + 1) % n) for i in range(n)]


class RingExchange:
    """One step of a :func:`ring_perm` ring of ``x`` over ``group``, in
    flight: the send to the next rank and the receive from the previous
    one are both posted at construction. :meth:`wait` returns what
    arrived, on the sender's device."""

    def __init__(self, x: torch.Tensor, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        perm = ring_perm(n)
        dst = perm[r][1]
        src = next(i for i, j in perm if j == r)
        self.device = x.device
        with _collective("ring_exchange"):
            send = x.contiguous()
            if (dist.get_backend(group) == "gloo"
                    and send.device.type != "cpu"):
                # gloo sends and receives host memory: the ring's steps
                # are staged through the host (two copies a step), never
                # swapped for the blocking collectives
                send = send.cpu()
            self._send, self._recv = send, torch.empty_like(send)
            self._reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send,
                           dist.get_global_rank(group, dst), group),
                dist.P2POp(dist.irecv, self._recv,
                           dist.get_global_rank(group, src), group)])

    def wait(self) -> torch.Tensor:
        with _collective("ring_exchange", count=0):
            for req in self._reqs:
                req.wait()
            return self._recv.to(self.device, non_blocking=True)


def tp_overlap_viable(x_shape, mesh) -> bool:
    """Can an activation of shape ``x_shape`` (the WHOLE [B, T, D] of this
    rank's rows) take the collective-matmul ring path? The reference's
    rule: a model axis > 1 and a 3-D activation whose tokens split over
    it (its rows are this rank's already: the data axis split them). Its
    third condition, the sharded feature dims divisible by the axis,
    holds by construction: :class:`TpDense` refuses any other."""
    return (mesh is not None and mesh.model_size > 1 and len(x_shape) == 3
            and x_shape[1] % mesh.model_size == 0)


def tp_dense(x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None, mesh=None, *, parallel: str,
             overlap: bool = False, dtype: torch.dtype | None = None,
             precision: str = "") -> torch.Tensor:
    """``x @ weight.T + bias`` with x, the weight and the bias cast to
    ``dtype`` first (as flax's ``Dense(dtype=...)`` does). ``weight`` is
    [out, in], torch's ``Linear`` layout (flax kernels are [in, out]).

    Over a ``mesh`` with a model axis > 1, ``weight`` and ``bias`` are
    this rank's blocks (:class:`TpDense`). ``parallel='column'``: the
    rank's output features; ``x`` is whole, and its caller has passed it
    through :func:`copy_to_model`. ``parallel='row'``: ``x`` is the
    rank's input features; the products are summed over the model group
    (:func:`reduce_from_model`) and the bias added once, after the sum.
    ``overlap``: ``x`` is in the Megatron-SP layout (the caller decided
    with :func:`tp_overlap_viable`): column-parallel takes the rank's
    token block and returns every token (``ag_matmul``), row-parallel
    returns the rank's token block of the sum (``matmul_rs``), each a
    ring of the next chunk's exchange under this chunk's product."""
    if parallel not in ("column", "row"):
        raise ValueError(f"parallel={parallel!r} must be 'column' or 'row'")
    if precision not in ("", "bf16"):
        raise NotImplementedError(
            f"tp_dense precision={precision!r} (quantized tiers) is not "
            "ported yet")
    tp = mesh is not None and mesh.model_size > 1
    if overlap and not tp:
        raise ValueError("tp_dense(overlap=True) needs a mesh with a model "
                         "axis > 1")
    if dtype is not None:
        x = x.to(dtype)
        weight = weight.to(dtype)
        bias = bias.to(dtype) if bias is not None else None
    if overlap:
        from dtf_tpu_torch.ops import collective_matmul as cm

        ring = cm.ag_matmul if parallel == "column" else cm.matmul_rs
        y = ring(x, weight, mesh.model_group)
    else:
        y = torch.matmul(x, weight.t())
        if tp and parallel == "row":
            y = reduce_from_model(y, mesh)
    return y if bias is None else y + bias


class TpDense(nn.Module):
    """A linear layer whose parameters stay f32 and whose product runs at
    ``dtype``: ``weight`` [features, in], ``bias`` [features] — this
    rank's blocks over ``mesh``'s model group (:func:`tp_dense`): the
    column-parallel layer's ``features / m`` rows, the row-parallel
    layer's ``in_features / m`` input columns and the whole bias."""

    def __init__(self, in_features: int, features: int, *, parallel: str,
                 dtype: torch.dtype | None = None, use_bias: bool = True,
                 device=None, mesh=None):
        super().__init__()
        self.parallel = parallel
        self.dtype = dtype
        self.mesh = mesh if mesh is not None and mesh.model_size > 1 else None
        m = self.mesh.model_size if self.mesh is not None else 1
        split = features if parallel == "column" else in_features
        if split % m:
            raise ValueError(f"{parallel}-parallel dim {split} does not "
                             f"split over the model axis ({m})")
        if parallel == "column":
            features //= m
        else:
            in_features //= m
        self.weight = nn.Parameter(torch.zeros(
            features, in_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(
            features, dtype=torch.float32, device=device))
            if use_bias else None)

    def forward(self, x: torch.Tensor, overlap: bool = False) -> torch.Tensor:
        return tp_dense(x, self.weight, self.bias, self.mesh,
                        parallel=self.parallel, overlap=overlap,
                        dtype=self.dtype)
