"""Embedding-row gather (counterpart of ``dtf_tpu.ops.embed_gather``).

``table[ids]`` for a [R, D] table and int ids of any rank. Side by side:

- :func:`gather_rows_reference`: the plain PyTorch version.
- :func:`gather_rows_cuda`: the wrapper of the hand-written Hopper kernel
  in ``csrc/embed_gather.cu`` (replacing the Pallas ``_gather_kernel``),
  with the same contract. It counts its launches in
  :data:`launch_counts`.
- :func:`gather_rows`: the public entry, differentiable through
  :class:`_Gather` (the counterpart of ``_gather``'s ``custom_vjp``). CPU
  tensors take the plain version, CUDA tensors the kernel; nothing falls
  back.

The JAX contract is ids in [0, R). Outside it the Pallas kernel would
read outside the table and ``jnp.take`` fills NaN; here both versions
give a NaN row, and the backward drops the row's cotangent, as
``.at[ids].add`` does.
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


_lib = None


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
    lib.dtf_embed_gather.argtypes = [p, ll, ll, p, ll, p, i, i, p]
    lib.dtf_embed_gather.restype = i
    lib.dtf_embed_gather_error_string.argtypes = [i]
    lib.dtf_embed_gather_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check_cuda_inputs(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError(f"gather_rows_cuda: table on {table.device}, ids "
                         f"on {ids.device}; the kernel takes one GPU")
    if table.ndim != 2:
        raise ValueError(f"expected table [R,D], got {tuple(table.shape)}")
    if table.dtype not in KERNEL_DTYPES:
        raise ValueError(f"gather_rows_cuda: table is {table.dtype}; the "
                         f"Hopper kernel takes {KERNEL_DTYPES}")
    if table.shape[1] > 1 and table.stride(1) != 1:
        raise ValueError("gather_rows_cuda: the kernel reads rows through "
                         "their stride; the table's last dim must be "
                         f"contiguous (strides {table.stride()})")
    if ids.dtype != torch.int32:
        raise ValueError(f"gather_rows_cuda: ids are {ids.dtype}; the "
                         "kernel takes int32")


def gather_rows_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launch B8: the contract of :func:`gather_rows_reference` on CUDA
    tensors, for an f32 or bf16 table and int32 ids. Raises on what the
    kernel does not take; never computes the result another way."""
    _check_cuda_inputs(table, ids)
    flat = ids.reshape(-1).contiguous()
    n_rows, d = table.shape
    out = torch.empty((flat.numel(), d), dtype=table.dtype,
                      device=table.device)
    if flat.numel() and d:
        elt = table.element_size()
        lib = _kernel_lib()
        err = lib.dtf_embed_gather(
            table.data_ptr(), table.stride(0) * elt, n_rows,
            flat.data_ptr(), flat.numel(), out.data_ptr(), d * elt, elt,
            torch.cuda.current_stream(table.device).cuda_stream)
        if err:
            raise RuntimeError(
                "embed_gather launch failed: "
                f"{lib.dtf_embed_gather_error_string(err).decode()} "
                f"(error {err}; table {tuple(table.shape)} {table.dtype}, "
                f"{flat.numel()} ids)")
        launch_counts["embed_gather"] += 1
    return out.reshape(ids.shape + (d,))


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
