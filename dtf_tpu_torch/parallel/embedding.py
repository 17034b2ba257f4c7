"""Row-sharded embedding tables (counterpart of ``dtf_tpu.parallel.embedding``).

The reference row-shards its tables over a mesh axis and offers two
lookups: plain ``take`` (:class:`RowShardedEmbed`, which the partitioner
turns into local gathers + collectives) and the explicit
:func:`masked_lookup_sharded`, where each shard serves the ids in its row
range, contributes zeros elsewhere, and one ``psum`` sums the shards.
``use_kernel=True`` runs the per-shard lookup through the B8 kernel
(:func:`dtf_tpu_torch.ops.embed_gather.masked_gather_rows`).

Over a process group (the model axis of :mod:`dtf_tpu_torch.core.mesh`)
rank k holds rows [k·R/N, (k+1)·R/N) of every table
(:func:`embedding_rules`), and the ``psum`` is one all-reduce of
[batch, dim]. Torch has no partitioner to turn a plain gather on a
sharded table into that, so :class:`RowShardedEmbed` calls the explicit
lookup when it is given a group, and :func:`lookup_tables` looks up
several such tables that share the ids in ONE B8 launch
(:func:`masked_lookup_grouped`): the shard's shift, range test and zeros,
and each table's cast, happen inside the kernel, where XLA fuses them
into its neighbours. The all-reduce's backward is the identity: every
rank runs the same computation downstream of the summed rows, so the
cotangent each rank receives is already the whole one (the transpose of
``psum`` under ``shard_map``); all-reducing it again would scale the
tables' gradients by N.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from dtf_tpu_torch.core.comms import ReduceFromGroup


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
    the row gather (default ``index_select``;
    :func:`~dtf_tpu_torch.ops.embed_gather.gather_rows` is the reference's
    kernel path, a plain-contract B8 launch between the eager mask ops;
    the port's kernel path folds all of it into one launch,
    :func:`masked_lookup_sharded`). The caller sums the shards'
    contributions."""
    n_local = table_shard.shape[0]
    local = ids - shard_index * n_local
    in_range = (local >= 0) & (local < n_local)
    safe = local.clamp(0, n_local - 1)
    rows = (gather_fn or _take)(table_shard, safe)
    return torch.where(in_range[..., None], rows, torch.zeros_like(rows))


#: the name ``tests/_torch_multirank_worker.py`` imports the shards' sum by
_SumOverShards = ReduceFromGroup


def _shard_index(group) -> int:
    if group is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


def masked_lookup_sharded(table: torch.Tensor, ids: torch.Tensor,
                          group=None, *, use_kernel: bool = False,
                          dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """``table[ids]`` through :func:`masked_lookup` over the shards of
    ``group``, summed: ``table`` is this rank's shard (rank k of the group
    holds rows from k·len(table) on), ``ids`` the global row ids, the
    same on every rank of the group. ``group`` None is one shard holding
    the whole table, and no collective. ``use_kernel=True`` runs the
    shard's lookup as one B8 launch on CUDA tensors (its plain version on
    CPU tensors). ``dtype``: the plain lookup's rows are cast to it
    before the sum (exact: one shard holds each row; the vocab-parallel
    GPT embedding sums bf16 rows)."""
    if use_kernel:
        return masked_lookup_grouped((table,), ids, group)[0]
    rows = masked_lookup(table, ids, _shard_index(group))
    if dtype is not None:
        rows = rows.to(dtype)
    return rows if group is None else ReduceFromGroup.apply(rows, group)


def masked_lookup_grouped(tables, ids: torch.Tensor, group=None,
                          out_dtypes=None) -> tuple:
    """:func:`masked_lookup_sharded` (``use_kernel=True``) of up to two
    tables row-sharded alike over ``group`` and looked up with the same
    ids, in ONE B8 launch (CUDA; the plain version on CPU tensors). Each
    table's rows come out in ``out_dtypes[t]`` (default the table's
    dtype; bf16 from an f32 table rounds each gathered row, bitwise the
    lookup of the table cast first, with no cast of the table). Returns
    one output per table, each summed over ``group``."""
    from dtf_tpu_torch.ops.embed_gather import masked_gather_rows

    outs = masked_gather_rows(tables, ids, _shard_index(group), out_dtypes)
    if group is None:
        return outs
    return tuple(ReduceFromGroup.apply(rows, group) for rows in outs)


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
    lookup is :func:`masked_lookup_grouped`: one B8 launch that rounds
    the gathered rows to ``dtype`` as it stores them, bitwise
    :func:`masked_lookup_sharded` of the cast table, without the cast of
    the shard."""

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
        if self.group is None:
            return _take(self.weight.to(self.dtype), ids)
        return masked_lookup_grouped((self.weight,), ids, self.group,
                                     (self.dtype,))[0]


def lookup_tables(embeds, ids: torch.Tensor) -> tuple:
    """Every :class:`RowShardedEmbed` of ``embeds`` (at most two) looked up
    with the same ids, one output per table. Tables row-sharded over one
    group take ONE B8 launch together (:func:`masked_lookup_grouped`);
    whole tables their own lookups (``index_select``)."""
    group = embeds[0].group
    if any(e.group is not group for e in embeds):
        raise ValueError("lookup_tables: the tables are sharded over "
                         "different groups")
    if group is None:
        return tuple(e(ids) for e in embeds)
    return masked_lookup_grouped(tuple(e.weight for e in embeds), ids, group,
                                 tuple(e.dtype for e in embeds))


def embedding_rules(axis: str = "model"):
    """The placement rule of every :class:`RowShardedEmbed` table: rows
    over ``axis`` (:mod:`dtf_tpu_torch.core.sharding`)."""
    return [(r"embed_tables.*\.weight$", (axis, None))]
