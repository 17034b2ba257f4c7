"""Row-sharded embedding tables (counterpart of ``dtf_tpu.parallel.embedding``).

The reference row-shards its tables over a mesh axis and offers two
lookups: plain ``take`` (:class:`RowShardedEmbed`, which the partitioner
turns into local gathers + collectives) and the explicit
:func:`masked_lookup_sharded`, where each shard serves the ids in its row
range, contributes zeros elsewhere, and one ``psum`` sums the shards.
``use_kernel=True`` runs the per-shard gather through the B8 kernel
(:func:`dtf_tpu_torch.ops.embed_gather.gather_rows`).

Over a process group (the model axis of :mod:`dtf_tpu_torch.core.mesh`)
rank k holds rows [k·R/N, (k+1)·R/N) of every table
(:func:`embedding_rules`), and the ``psum`` is one all-reduce of
[batch, dim]. Torch has no partitioner to turn a plain gather on a
sharded table into that, so :class:`RowShardedEmbed` calls the explicit
lookup when it is given a group. The all-reduce's backward is the
identity: every rank runs the same computation downstream of the summed
rows, so the cotangent each rank receives is already the whole one (the
transpose of ``psum`` under ``shard_map``); all-reducing it again would
scale the tables' gradients by N.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` for ids in range: ``index_select``,
    XLA's gather in the reference (not a Pallas kernel)."""
    rows = table.index_select(0, ids.reshape(-1))
    return rows.reshape(ids.shape + (table.shape[1],))


def masked_lookup(table_shard: torch.Tensor, ids: torch.Tensor,
                  shard_index: int,
                  gather_fn: Optional[Callable] = None) -> torch.Tensor:
    """Per-shard body: this shard's contribution to ``table[ids]``.

    ``table_shard`` [rows/n, dim] holds rows ``shard_index * rows/n`` on
    (``shard_index`` stands in for the reference's ``axis_index``);
    ``ids`` [...] are global row ids. Returns [..., dim]: the row where
    the id falls in this shard, exactly 0 elsewhere; rows whose ids fall
    outside get no gradient. ``gather_fn(table_shard, safe_ids)`` swaps
    the row gather (default ``index_select``; the kernel path passes
    :func:`~dtf_tpu_torch.ops.embed_gather.gather_rows`). The caller sums
    the shards' contributions."""
    n_local = table_shard.shape[0]
    local = ids - shard_index * n_local
    in_range = (local >= 0) & (local < n_local)
    safe = local.clamp(0, n_local - 1)
    rows = (gather_fn or _take)(table_shard, safe)
    return torch.where(in_range[..., None], rows, torch.zeros_like(rows))


class _SumOverShards(torch.autograd.Function):
    """All-reduce (sum) of the shards' rows over ``group``; the backward
    is the identity (module docstring)."""

    @staticmethod
    def forward(ctx, rows, group):
        import torch.distributed as dist

        rows = rows.clone()
        dist.all_reduce(rows, group=group)
        return rows

    @staticmethod
    def backward(ctx, g):
        return g, None


def masked_lookup_sharded(table: torch.Tensor, ids: torch.Tensor,
                          group=None, *,
                          use_kernel: bool = False) -> torch.Tensor:
    """``table[ids]`` through :func:`masked_lookup` over the shards of
    ``group``, summed: ``table`` is this rank's shard (rank k of the group
    holds rows from k·len(table) on), ``ids`` the global row ids, the
    same on every rank of the group. ``group`` None is one shard holding
    the whole table, and no collective. ``use_kernel=True`` gathers with
    the B8 kernel on CUDA tensors (its plain version on CPU tensors)."""
    gather_fn = None
    if use_kernel:
        from dtf_tpu_torch.ops.embed_gather import gather_rows

        gather_fn = gather_rows
    if group is None:
        return masked_lookup(table, ids, 0, gather_fn)
    import torch.distributed as dist

    rows = masked_lookup(table, ids, dist.get_rank(group), gather_fn)
    return _SumOverShards.apply(rows, group)


class RowShardedEmbed(nn.Module):
    """An embedding table meant for row sharding: an f32 parameter
    ``weight`` [num_embeddings, features] (the flax param
    ``embedding``), cast to ``dtype`` and then gathered, as
    ``jnp.take(table.astype(dtype), ids)``. Casting first makes the
    backward a scatter-add at ``dtype`` (duplicate ids sum in bf16 for a
    bf16 table), then the cast back to f32, as JAX's transpose does; the
    table's gradient is dense, every row. Initialize it with
    :func:`dtf_tpu_torch.convert.init_params_widedeep` (or load a flax
    tree).

    ``group``: the table is row-sharded over the group's ranks, this
    rank's ``weight`` holding its num_embeddings / size rows, and the
    lookup is :func:`masked_lookup_sharded` with the B8 gather
    (``use_kernel=True``)."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 group=None):
        super().__init__()
        self.dtype = dtype
        self.group = group
        if group is not None:
            import torch.distributed as dist

            n = dist.get_world_size(group)
            if num_embeddings % n:
                raise ValueError(f"{num_embeddings} table rows do not "
                                 f"split over {n} ranks")
            num_embeddings //= n
        self.weight = nn.Parameter(torch.zeros(
            num_embeddings, features, dtype=torch.float32, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = self.weight.to(self.dtype)
        if self.group is None:
            return _take(table, ids)
        return masked_lookup_sharded(table, ids, self.group, use_kernel=True)


def embedding_rules(axis: str = "model"):
    """The placement rule of every :class:`RowShardedEmbed` table: rows
    over ``axis`` (:mod:`dtf_tpu_torch.core.sharding`)."""
    return [(r"embed_tables.*\.weight$", (axis, None))]
