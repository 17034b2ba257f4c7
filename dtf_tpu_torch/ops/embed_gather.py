"""Embedding-row gather (counterpart of ``dtf_tpu.ops.embed_gather``).

One hand-written Hopper kernel (B8, ``csrc/embed_gather.cu``, replacing
the Pallas ``_gather_kernel``) serves two contracts:

- ``table[ids]`` for a [R, D] table and int ids of any rank
  (:func:`gather_rows`). The JAX contract is ids in [0, R). Outside it
  the Pallas kernel would read outside the table and ``jnp.take`` fills
  NaN; here every version gives a NaN row, and the backward drops the
  row's cotangent, as ``.at[ids].add`` does.
- The masked lookup of one row shard (:func:`masked_gather_rows`): up to
  two tables that share the ids, hold the same rows of the shard and are
  looked up in ONE launch. A row whose id falls outside the shard is
  exactly 0 (``dtf_tpu.parallel.embedding.masked_lookup``'s per-shard
  body), and an f32 table may be read into bf16 rows, rounded to nearest
  even as they are stored: bitwise what casting the whole table first
  gives, without the cast.

Side by side for each: the plain PyTorch version
(:func:`gather_rows_reference`, :func:`masked_gather_rows_reference`);
the wrapper of the kernel (:func:`gather_rows_cuda`,
:func:`masked_gather_rows_cuda`), which counts its launches in
:data:`launch_counts`; the differentiable entry (:class:`_Gather`,
:class:`_MaskedGather`, counterparts of ``_gather``'s ``custom_vjp``).
CPU tensors take the plain version, CUDA tensors the kernel; nothing
falls back.
"""

from __future__ import annotations

import ctypes

import torch

#: Launches of the CUDA kernel ``embed_gather`` (B8). A plain integer;
#: :func:`reset_launch_counts` zeroes it.
launch_counts = {"embed_gather": 0}

#: the table types the kernel takes
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _out_of_range(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    return (ids < 0) | (ids >= n_rows)


def gather_rows_reference(table: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """table [R, D], ids [...] int → [..., D]: row ``ids[i]`` of the
    table, a row of NaN where the id is outside [0, R)."""
    n_rows, d = table.shape
    flat = ids.reshape(-1)
    rows = table.index_select(0, flat.clamp(0, max(n_rows - 1, 0)))
    rows = rows.masked_fill(_out_of_range(flat, n_rows)[:, None],
                            float("nan"))
    return rows.reshape(ids.shape + (d,))


def _out_dtypes(tables, out_dtypes):
    if out_dtypes is None:
        return tuple(t.dtype for t in tables)
    out_dtypes = tuple(out_dtypes)
    if len(out_dtypes) != len(tables):
        raise ValueError(f"{len(tables)} tables, {len(out_dtypes)} out "
                         "dtypes")
    return out_dtypes


def _shard_mask(ids: torch.Tensor, shard_index: int, n_local: int):
    """The shard's view of global row ids: (in_range, safe local ids),
    ``masked_lookup``'s shift, range test and clip."""
    local = ids - shard_index * n_local
    in_range = (local >= 0) & (local < n_local)
    return in_range, local.clamp(0, max(n_local - 1, 0))


def masked_gather_rows_reference(tables, ids: torch.Tensor,
                                 shard_index: int, out_dtypes=None):
    """tables: [R_local, D_t] each, rows ``shard_index * R_local`` on of
    tables with one id space; ids [...] global row ids. Returns a tuple,
    per table [..., D_t] in ``out_dtypes[t]`` (default the table's
    dtype): the row where the id falls in this shard, exactly 0
    elsewhere. ``masked_lookup``'s body per table, then the cast (a
    gather copies, so casting after it equals casting the table first)."""
    out_dtypes = _out_dtypes(tables, out_dtypes)
    in_range, safe = _shard_mask(ids, shard_index, tables[0].shape[0])
    outs = []
    for table, dtype in zip(tables, out_dtypes):
        rows = table.index_select(0, safe.reshape(-1)).reshape(
            ids.shape + (table.shape[1],))
        rows = torch.where(in_range[..., None], rows, torch.zeros_like(rows))
        outs.append(rows.to(dtype))
    return tuple(outs)


_lib = None


class _Table(ctypes.Structure):
    """``DtfGatherTable`` of ``csrc/embed_gather.cu``: one table of a
    launch."""
    _fields_ = [("src", ctypes.c_void_p), ("stride_bytes", ctypes.c_longlong),
                ("dst", ctypes.c_void_p), ("d", ctypes.c_int),
                ("in_elt", ctypes.c_int), ("out_elt", ctypes.c_int)]


def _kernel_lib():
    """The built ``embed_gather`` library, with its C signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    from dtf_tpu_torch.ops import _build

    lib = _build.load("embed_gather")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # every pointer and the stream as c_void_p: an untyped ctypes argument
    # is passed as a 32-bit int and cuts the pointer
    lib.dtf_embed_gather.argtypes = [ctypes.POINTER(_Table), i, p, ll, ll,
                                     ll, i, p]
    lib.dtf_embed_gather.restype = i
    lib.dtf_embed_gather_error_string.argtypes = [i]
    lib.dtf_embed_gather_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check_cuda_inputs(tables, ids: torch.Tensor, what: str) -> None:
    if not 1 <= len(tables) <= 2:
        raise ValueError(f"{what}: {len(tables)} tables; the kernel looks "
                         "up one or two in a launch")
    for table in tables:
        if table.device.type != "cuda" or ids.device != table.device:
            raise ValueError(f"{what}: table on {table.device}, ids on "
                             f"{ids.device}; the kernel takes one GPU")
        if table.ndim != 2:
            raise ValueError(f"expected table [R,D], got "
                             f"{tuple(table.shape)}")
        if table.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{what}: table is {table.dtype}; the Hopper "
                             f"kernel takes {KERNEL_DTYPES}")
        if table.shape[1] > 1 and table.stride(1) != 1:
            raise ValueError(f"{what}: the kernel reads rows through their "
                             "stride; the table's last dim must be "
                             f"contiguous (strides {table.stride()})")
        if table.shape[0] != tables[0].shape[0]:
            raise ValueError(f"{what}: tables of {tables[0].shape[0]} and "
                             f"{table.shape[0]} rows do not share ids")
    if ids.dtype != torch.int32:
        raise ValueError(f"{what}: ids are {ids.dtype}; the kernel takes "
                         "int32")


def _launch(tables, ids: torch.Tensor, out_dtypes, row_offset: int,
            zero_outside: bool):
    """One B8 launch over ``tables`` (checked); returns the outputs, one
    [*ids.shape, D_t] tensor per table."""
    flat = ids.reshape(-1).contiguous()
    outs = [torch.empty((flat.numel(), t.shape[1]), dtype=dtype,
                        device=t.device)
            for t, dtype in zip(tables, out_dtypes)]
    live = [(t, o) for t, o in zip(tables, outs) if o.numel()]
    if live:
        descs = (_Table * len(live))(*(
            _Table(t.data_ptr(), t.stride(0) * t.element_size(),
                   o.data_ptr(), t.shape[1], t.element_size(),
                   o.element_size()) for t, o in live))
        lib = _kernel_lib()
        err = lib.dtf_embed_gather(
            descs, len(live), flat.data_ptr(), flat.numel(), row_offset,
            tables[0].shape[0], int(zero_outside),
            torch.cuda.current_stream(flat.device).cuda_stream)
        if err:
            raise RuntimeError(
                "embed_gather launch failed: "
                f"{lib.dtf_embed_gather_error_string(err).decode()} (error "
                f"{err}; tables "
                f"{[(tuple(t.shape), t.dtype) for t, _ in live]}, "
                f"{flat.numel()} ids)")
        launch_counts["embed_gather"] += 1
    return tuple(o.reshape(ids.shape + (o.shape[1],)) for o in outs)


def gather_rows_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launch B8: the contract of :func:`gather_rows_reference` on CUDA
    tensors, for an f32 or bf16 table and int32 ids. Raises on what the
    kernel does not take; never computes the result another way."""
    _check_cuda_inputs((table,), ids, "gather_rows_cuda")
    (out,) = _launch((table,), ids, (table.dtype,), 0, False)
    return out


def masked_gather_rows_cuda(tables, ids: torch.Tensor, shard_index: int,
                            out_dtypes=None):
    """Launch B8 once for every table: the contract of
    :func:`masked_gather_rows_reference` on CUDA tensors, for one or two
    f32 or bf16 tables of the same rows, int32 ids, and each out dtype
    the table's or bf16 from f32. Raises on what the kernel does not
    take; never computes the result another way."""
    tables = tuple(tables)
    out_dtypes = _out_dtypes(tables, out_dtypes)
    _check_cuda_inputs(tables, ids, "masked_gather_rows_cuda")
    for t, dtype in zip(tables, out_dtypes):
        if dtype != t.dtype and not (t.dtype == torch.float32
                                     and dtype == torch.bfloat16):
            raise ValueError(f"masked_gather_rows_cuda: a {t.dtype} table "
                             f"into {dtype} rows; the kernel stores the "
                             "table's type, or bf16 from f32")
    return _launch(tables, ids, out_dtypes, shard_index * tables[0].shape[0],
                   True)


class _Gather(torch.autograd.Function):
    """The differentiable gather (``_gather``'s ``custom_vjp``). Forward:
    the kernel on CUDA, the plain version on the CPU. Backward
    (``_gather_bwd``): the cotangent scatter-added into an f32 zero table
    (duplicate ids accumulate), cast to the cotangent's type. That is
    XLA's scatter in the reference, not a Pallas kernel, so ``index_add_``
    is its counterpart here."""

    @staticmethod
    def forward(ctx, table, ids):
        if table.device.type == "cpu" and ids.device.type == "cpu":
            out = gather_rows_reference(table, ids)
        else:
            out = gather_rows_cuda(table, ids)
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return out

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        bad = _out_of_range(ids, ctx.n_rows)
        dt = torch.zeros((ctx.n_rows, ct.shape[-1]), dtype=torch.float32,
                         device=ct.device)
        dt.index_add_(0, ids.clamp(0, max(ctx.n_rows - 1, 0)),
                      ct.float().masked_fill(bad[:, None], 0.0))
        return dt.to(ct.dtype), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: table [R, D], ids [...] int in [0, R); returns
    [..., D]. Differentiable with respect to ``table``. CPU tensors run
    the plain version; CUDA tensors the Hopper kernel, or raise."""
    if table.ndim != 2:
        raise ValueError(f"expected table [R,D], got {tuple(table.shape)}")
    out = _Gather.apply(table, ids.reshape(-1))
    return out.reshape(ids.shape + (table.shape[1],))


class _MaskedGather(torch.autograd.Function):
    """The differentiable masked lookup of one row shard: one output per
    table. Forward: one B8 launch for all the tables on CUDA, the plain
    version on the CPU. Backward: plain PyTorch, as the reference's is
    XLA's scatter (``_gather_bwd``; the TPU kernel has no backward
    kernel). The tables share one in-shard mask; each cotangent, 0 where
    the id is outside the shard, is scatter-added into an f32 zero table
    at the clipped ids, then taken through the out dtype to the table's
    (for a bf16 out dtype the round trip the cast's transpose makes).
    That is the backward of ``masked_lookup`` on the cast table, op for
    op, so the gradients are bitwise the same."""

    @staticmethod
    def forward(ctx, ids, shard_index, out_dtypes, *tables):
        if all(t.device.type == "cpu" for t in (ids, *tables)):
            outs = masked_gather_rows_reference(tables, ids, shard_index,
                                                out_dtypes)
        else:
            outs = masked_gather_rows_cuda(tables, ids, shard_index,
                                           out_dtypes)
        ctx.save_for_backward(ids)
        ctx.shard_index = shard_index
        ctx.tables = [(t.shape[1], t.dtype) for t in tables]
        ctx.n_local = tables[0].shape[0]
        ctx.out_dtypes = out_dtypes
        return outs

    @staticmethod
    def backward(ctx, *cts):
        (ids,) = ctx.saved_tensors
        in_range, safe = _shard_mask(ids.reshape(-1), ctx.shard_index,
                                     ctx.n_local)
        outside = ~in_range[:, None]
        grads = []
        for need, ct, (d, dtype), out_dtype in zip(
                ctx.needs_input_grad[3:], cts, ctx.tables, ctx.out_dtypes):
            if not need:
                grads.append(None)
                continue
            dt = torch.zeros((ctx.n_local, d), dtype=torch.float32,
                             device=ct.device)
            dt.index_add_(0, safe, ct.reshape(-1, d).float().masked_fill(
                outside, 0.0))
            grads.append(dt.to(out_dtype).to(dtype))
        return (None, None, None, *grads)


def masked_gather_rows(tables, ids: torch.Tensor, shard_index: int,
                       out_dtypes=None):
    """The masked lookup of shard ``shard_index`` for every table of
    ``tables`` (each [R_local, D_t], the same rows of one id space): a
    tuple of [..., D_t] in ``out_dtypes`` (default each table's dtype;
    bf16 rows from an f32 table are rounded as they are stored), exactly
    0 where the id falls outside the shard. Differentiable with respect
    to the tables. CPU tensors run the plain version; CUDA tensors ONE
    launch of the Hopper kernel for up to two tables, or raise."""
    tables = tuple(tables)
    for table in tables:
        if table.ndim != 2:
            raise ValueError(f"expected table [R,D], got "
                             f"{tuple(table.shape)}")
    return _MaskedGather.apply(ids, shard_index,
                               _out_dtypes(tables, out_dtypes), *tables)
