"""Fused LM head + cross-entropy (counterpart of ``dtf_tpu.ops.fused_ce``).

The [N, V] logits and their cotangent are never stored: the head product
and the CE run tile by tile, and the backward rebuilds each tile's
dlogits from the saved per-token logsumexp. Side by side:

- :func:`fused_ce_fwd_reference` / :func:`fused_ce_bwd_reference`: the
  plain PyTorch versions. The forward is B5's contract, ``(lse, tgt)``
  per token: the logsumexp over the V live columns and the target logit
  (0 for a label outside [0, V)). The backward is B6 + B7:
  ``dlogits = dce · (softmax − onehot)`` rebuilt from ``lse``, then
  ``dx = dlogits · W`` and ``dW = dlogitsᵀ · x``.
- :func:`fused_ce_fwd_cuda`, :func:`fused_ce_dx_cuda`,
  :func:`fused_ce_dw_cuda`: the wrappers of the hand-written Hopper
  kernels in ``csrc/fused_ce.cu`` (replacing the Pallas ``_fwd_kernel``,
  ``_dx_kernel`` and ``_dw_kernel``), with the same contracts. B5, B6 and
  B7 run their products in 3xTF32 on the tensor cores and read the
  streamed operand through :func:`fused_ce_split_cuda`, the split pass
  (plain version :func:`fused_ce_split_reference`): one launch a forward,
  kept for the backward. B5 runs the vocab in parts
  (:func:`fused_ce_fwd_parts_cuda`, plain version
  :func:`fused_ce_parts_reference`) that :func:`fused_ce_merge_cuda`
  combines in a fixed order (plain version
  :func:`fused_ce_merge_reference`). They count their launches in
  :data:`launch_counts`.
- :func:`fused_lm_cross_entropy`: the public entry, differentiable
  through :class:`_FusedCE` (the counterpart of ``_fused_ce``'s
  ``custom_vjp``). CPU tensors take the plain versions, CUDA tensors the
  kernels; nothing falls back.

The head weight is ``nn.Linear.weight``'s layout, [V, D] (the JAX
package's kernel transposed); the kernels read it through its row
stride. Sums are f32 (f64 for f64 inputs in the plain versions, so that
``gradcheck`` can run). ``bias`` is not supported, as in the reference.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from dtf_tpu_torch.ops.losses import _acc_dtype

#: head widths (d_model) the backward kernels are compiled for: a
#: cluster of CTAs (384: 2 x 192 columns, 768: 3 x 256, 1024: 8 x 128)
#: holds the [128, D] output slice by slice in registers
HEAD_WIDTHS = (384, 768, 1024)

#: vocab rows a part of B5 (``fwd::PART_ROWS`` in ``csrc/fused_ce.cu``; the
#: wrapper checks that the two agree)
FWD_PART_ROWS = 1536

#: Launches of the CUDA kernels: ``fused_ce_fwd`` (B5), ``fused_ce_merge``
#: (the merge of B5's vocab parts), ``fused_ce_split`` (the split pass),
#: ``fused_ce_dx`` (B6) and ``fused_ce_dw`` (B7). Plain integers;
#: :func:`reset_launch_counts` zeroes them.
launch_counts = {"fused_ce_fwd": 0, "fused_ce_merge": 0,
                 "fused_ce_split": 0, "fused_ce_dx": 0, "fused_ce_dw": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _logits(x, w, acc):
    return torch.matmul(x.to(acc), w.to(acc).t())


def fused_ce_fwd_reference(x: torch.Tensor, w: torch.Tensor,
                           labels: torch.Tensor):
    """x [N, D], w [V, D], labels [N] int → (lse [N], tgt [N]) in the
    working type: the logsumexp of x·Wᵀ over its V columns, and the logit
    at the label's column (0 where the label is outside [0, V))."""
    acc = _acc_dtype(x, w)
    logits = _logits(x, w, acc)
    v = w.shape[0]
    labels = labels.long()
    live = (labels >= 0) & (labels < v)
    picked = logits.gather(1, labels.clamp(0, v - 1)[:, None])[:, 0]
    tgt = torch.where(live, picked, torch.zeros_like(picked))
    return torch.logsumexp(logits, dim=-1), tgt


def fused_ce_parts_reference(x: torch.Tensor, w: torch.Tensor,
                             labels: torch.Tensor,
                             part_rows: int = FWD_PART_ROWS) -> torch.Tensor:
    """What B5 writes: for each part of ``part_rows`` vocab rows (the last
    one ragged) and each token, the max ``m`` of its logits in the part,
    ``l`` = Σ exp(logit − m) and the target logit if the label lies in
    the part (else 0), as ws [parts, 3, N] in the working type. ``m`` is
    −inf and ``l`` 0 for a part with no column."""
    acc = _acc_dtype(x, w)
    v = w.shape[0]
    labels = labels.long()
    rows = []
    for v0 in range(0, v, part_rows):
        logits = _logits(x, w[v0:v0 + part_rows], acc)
        m = logits.max(dim=1).values
        m_safe = torch.where(m == -torch.inf, torch.zeros_like(m), m)
        l = torch.exp(logits - m_safe[:, None]).sum(dim=1)
        inside = (labels >= v0) & (labels < v0 + logits.shape[1])
        picked = logits.gather(1, (labels - v0).clamp(
            0, logits.shape[1] - 1)[:, None])[:, 0]
        rows.append(torch.stack([m, l, torch.where(
            inside, picked, torch.zeros_like(picked))]))
    return torch.stack(rows)


def fused_ce_merge_reference(ws: torch.Tensor):
    """The merge of B5's parts, ws [parts, 3, N] → (lse, tgt) [N], part by
    part in order (the reference's ``_finalize``): M = max m_p, lse = M +
    log Σ l_p·exp(m_p − M) with M read as 0 while it is −inf and the sum
    as 1 when it is 0; tgt = Σ tgt_p."""
    big_m = ws[:, 0].max(dim=0).values
    m_safe = torch.where(big_m == -torch.inf, torch.zeros_like(big_m),
                         big_m)
    total = torch.zeros_like(big_m)
    tgt = torch.zeros_like(big_m)
    for m, l, t in ws:
        total = total + l * torch.exp(m - m_safe)
        tgt = tgt + t
    return big_m + torch.log(torch.where(total == 0, torch.ones_like(total),
                                         total)), tgt


def fused_ce_bwd_reference(x: torch.Tensor, w: torch.Tensor,
                           labels: torch.Tensor, lse: torch.Tensor,
                           dce: torch.Tensor):
    """The backward (``_run_bwd``): dlogits = dce·(exp(x·Wᵀ − lse) −
    onehot(label)) with an out-of-range label's onehot all 0, then
    (dx = dlogits·W in x's dtype, dW = dlogitsᵀ·x in w's dtype)."""
    acc = _acc_dtype(x, w)
    logits = _logits(x, w, acc)
    v = w.shape[0]
    hot = (torch.arange(v, device=x.device)[None, :]
           == labels.long()[:, None])
    dl = dce.to(acc)[:, None] * (torch.exp(logits - lse.to(acc)[:, None])
                                 - hot.to(acc))
    dx = torch.matmul(dl, w.to(acc))
    dw = torch.matmul(dl.t(), x.to(acc))
    return dx.to(x.dtype), dw.to(w.dtype)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: 10
    explicit mantissa bits, to nearest, ties away from zero (the low 13
    bits of the result are 0). Finite inputs."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(t: torch.Tensor):
    """(hi, lo) with hi = tf32(t), lo = tf32(t − hi): t to ~2⁻²² relative,
    the operand split of a 3xTF32 product (hi·hi' + hi·lo' + lo·hi')."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


#: position p of every group of 8 transposed rows holds row PERM8[p]: the
#: K order in which a wgmma f32 accumulator is the tf32 A fragment
PERM8 = (0, 2, 4, 6, 1, 3, 5, 7)


def padded_rows(rows: int) -> int:
    """The transposed split's row count: ``rows`` rounded up to 8."""
    return -(-rows // 8) * 8


def fused_ce_split_reference(a: torch.Tensor):
    """The split pass for one f32 matrix ``a`` [R, D]: (hi, lo) [R, D]
    and (t_hi, t_lo) [D, padded_rows(R)], the transposed split with every
    group of 8 rows in :data:`PERM8` order and the pad 0."""
    r, d = a.shape
    hi, lo = split_tf32(a.float())
    rp = padded_rows(r)
    pos = torch.arange(rp, device=a.device)
    p7 = pos % 8                     # position p holds row PERM8[p]
    idx = pos - p7 + torch.where(p7 < 4, 2 * p7, 2 * p7 - 7)
    padded = torch.zeros(rp, d, dtype=torch.float32, device=a.device)
    padded[:r] = a.float()
    t_hi, t_lo = split_tf32(padded[idx].t().contiguous())
    return hi, lo, t_hi, t_lo


class CESplit(NamedTuple):
    """The split pass's outputs (:func:`fused_ce_split_cuda`): W's for B5
    and B6, x's for B7 (None where not asked for); each (hi, lo, t_hi,
    t_lo), W's t_hi and t_lo None when only B5 needs W."""
    w: Optional[tuple]
    x: Optional[tuple]


_lib = None


def _kernel_lib():
    """The built ``fused_ce`` library, with its C signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    from dtf_tpu_torch.ops import _build

    lib = _build.load("fused_ce")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # every pointer and the stream as c_void_p: an untyped ctypes argument
    # is passed as a 32-bit int and cuts the pointer
    lib.dtf_fused_ce_fwd_f32.argtypes = [p, ll, p, p, p, p, i, i, i, p]
    lib.dtf_fused_ce_fwd_f32.restype = i
    lib.dtf_fused_ce_fwd_part_rows.argtypes = []
    lib.dtf_fused_ce_fwd_part_rows.restype = i
    lib.dtf_fused_ce_merge_f32.argtypes = [p, i, i, p, p, p]
    lib.dtf_fused_ce_merge_f32.restype = i
    lib.dtf_fused_ce_split_f32.argtypes = [p, ll, i, i, p, p, p, p,
                                           p, ll, i, i, p, p, p, p, i, p]
    lib.dtf_fused_ce_split_f32.restype = i
    for fn in (lib.dtf_fused_ce_dx_f32, lib.dtf_fused_ce_dw_f32):
        fn.argtypes = [p, ll, p, p, p, p, ll, p, p, p, p, p, i, i, i, p]
        fn.restype = i
    lib.dtf_fused_ce_workspace_floats.argtypes = [i, i, i, i]
    lib.dtf_fused_ce_workspace_floats.restype = ll
    lib.dtf_fused_ce_max_clusters.argtypes = [i, i]
    lib.dtf_fused_ce_max_clusters.restype = i
    lib.dtf_fused_ce_error_string.argtypes = [i]
    lib.dtf_fused_ce_error_string.restype = ctypes.c_char_p
    lib.dtf_fused_ce_smem_bytes.argtypes = [i, i]
    lib.dtf_fused_ce_smem_bytes.restype = ll
    _lib = lib
    return lib


def _rows_view(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernel can read it through its row stride (last
    dim contiguous, 16-byte aligned rows), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.stride(0) % 4 == 0
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


def _check_operands(fn: str, x, w):
    """x [N, D] f32 (bf16 is promoted here, as the reference's dot
    promotes it) and w [V, D] f32 on one GPU, at a compiled head width:
    the kernel-readable views of both."""
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device} (x on "
                             f"{x.device}); the kernel takes one GPU")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "must be [N, D] and [V, D]")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: x is {x.dtype}; the Hopper kernel takes "
                         "float32 (bfloat16 is promoted)")
    if w.dtype != torch.float32:
        raise ValueError(f"{fn}: w is {w.dtype}; the Hopper kernel takes "
                         "float32")
    if x.shape[1] not in HEAD_WIDTHS:
        raise ValueError(f"{fn}: head width {x.shape[1]} is not supported "
                         f"by the Hopper kernels (compiled for {HEAD_WIDTHS})")
    return _rows_view(x.float()), _rows_view(w)


def _check_cuda_inputs(fn: str, x, w, labels, stats=()):
    """The checks every wrapper makes, and the kernel-readable operands:
    :func:`_check_operands`, labels [N] on the same GPU (cast to int32
    unless already), f32 [N] statistics."""
    for name, t in (("labels", labels), *stats):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device} (x on "
                             f"{x.device}); the kernel takes one GPU")
    xk, wk = _check_operands(fn, x, w)
    n = xk.shape[0]
    if labels.shape != (n,):
        raise ValueError(f"{fn}: labels {tuple(labels.shape)} != ({n},)")
    if labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{fn}: labels are {labels.dtype}; integer "
                         "labels only")
    for name, t in stats:
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{fn}: {name} must be f32 [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return (xk, wk, labels.to(torch.int32).contiguous(),
            [t.contiguous() for _, t in stats])


def _check_launch(lib, err: int, which: int, name: str, d: int) -> None:
    if err:
        raise RuntimeError(
            f"{name} launch failed: "
            f"{lib.dtf_fused_ce_error_string(err).decode()} (error {err}; "
            f"{lib.dtf_fused_ce_smem_bytes(which, d)} bytes of shared memory "
            f"per CTA at head width {d})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_ce_fwd_parts_cuda(x: torch.Tensor, w: torch.Tensor,
                            labels: torch.Tensor,
                            split: Optional[CESplit] = None) -> torch.Tensor:
    """Launch B5: the contract of :func:`fused_ce_parts_reference` on
    CUDA tensors, ws [parts, 3, N] f32. ``split``: the split pass (W's
    stored hi/lo), launched here for W alone if not given. Raises on what
    the kernel does not take; never computes the result another way."""
    xk, wk, lab, _ = _check_cuda_inputs("fused_ce_fwd_cuda", x, w, labels)
    (n, d), v = xk.shape, wk.shape[0]
    if split is None or split.w is None:
        split = fused_ce_split_cuda(xk, wk, for_fwd=True, for_dx=False,
                                    for_dw=False)
    w_hi, w_lo = split.w[:2]
    if tuple(w_hi.shape) != (v, d) or tuple(w_lo.shape) != (v, d):
        raise ValueError("fused_ce_fwd_cuda: the split does not match x/w")
    lib = _kernel_lib()
    if lib.dtf_fused_ce_fwd_part_rows() != FWD_PART_ROWS:
        raise RuntimeError("fused_ce_fwd_cuda: FWD_PART_ROWS disagrees with "
                           "the built kernel's")
    ws = torch.empty((-(-v // FWD_PART_ROWS), 3, n), dtype=torch.float32,
                     device=x.device)
    err = lib.dtf_fused_ce_fwd_f32(
        xk.data_ptr(), xk.stride(0), w_hi.data_ptr(), w_lo.data_ptr(),
        lab.data_ptr(), ws.data_ptr(), n, v, d, _stream(x))
    _check_launch(lib, err, 0, "fused_ce_fwd", d)
    launch_counts["fused_ce_fwd"] += 1
    return ws


def fused_ce_merge_cuda(ws: torch.Tensor):
    """Launch the merge of B5's parts: the contract of
    :func:`fused_ce_merge_reference` on a CUDA ws [parts, 3, N] f32,
    (lse, tgt) f32 [N]."""
    if (ws.device.type != "cuda" or ws.dtype != torch.float32
            or ws.ndim != 3 or ws.shape[1] != 3 or ws.shape[0] < 1):
        raise ValueError(f"fused_ce_merge_cuda: ws must be f32 [parts, 3, "
                         f"N] on one GPU, got {ws.dtype} {tuple(ws.shape)} "
                         f"on {ws.device}")
    ws = ws.contiguous()
    nparts, _, n = ws.shape
    lse = torch.empty(n, dtype=torch.float32, device=ws.device)
    tgt = torch.empty_like(lse)
    lib = _kernel_lib()
    err = lib.dtf_fused_ce_merge_f32(ws.data_ptr(), nparts, n,
                                     lse.data_ptr(), tgt.data_ptr(),
                                     _stream(ws))
    _check_launch(lib, err, 4, "fused_ce_merge", 0)
    launch_counts["fused_ce_merge"] += 1
    return lse, tgt


def fused_ce_fwd_cuda(x: torch.Tensor, w: torch.Tensor,
                      labels: torch.Tensor,
                      split: Optional[CESplit] = None):
    """B5 and the merge of its parts: the contract of
    :func:`fused_ce_fwd_reference` on CUDA tensors, (lse, tgt) f32 [N].
    ``split`` as for :func:`fused_ce_fwd_parts_cuda`."""
    return fused_ce_merge_cuda(fused_ce_fwd_parts_cuda(x, w, labels, split))


def fused_ce_split_cuda(x: torch.Tensor, w: torch.Tensor, *,
                        for_dx: bool = True, for_dw: bool = True,
                        for_fwd: bool = False) -> CESplit:
    """Launch the split pass once: W's stored hi/lo (B5 and B6 stream W)
    if ``for_fwd`` or ``for_dx``, W's transposed hi/lo too if ``for_dx``,
    x's four (B7 streams x) if ``for_dw``; the contract of
    :func:`fused_ce_split_reference`, bitwise. Scratch: four f32 copies of
    each matrix split (0.72 GB at N 8192, V 50304, D 768; W's stored pair
    alone 0.31 GB), freed with the returned tensors."""
    xk, wk = _check_operands("fused_ce_split_cuda", x, w)
    (n, d), v = xk.shape, wk.shape[0]

    def alloc(rows, transposed=True):
        rp = padded_rows(rows)
        shapes = ((rows, d), (rows, d)) + (((d, rp), (d, rp)) if transposed
                                           else ())
        return tuple(torch.empty(shape, dtype=torch.float32, device=x.device)
                     for shape in shapes) + (None,) * (4 - len(shapes))

    xs = alloc(n) if for_dw else None
    ws = alloc(v, for_dx) if (for_dx or for_fwd) else None
    null4 = (None,) * 4
    ptrs = [t.data_ptr() if t is not None else None
            for t in (*(xs or null4), *(ws or null4))]
    lib = _kernel_lib()
    err = lib.dtf_fused_ce_split_f32(
        xk.data_ptr() if for_dw else None, xk.stride(0), n, padded_rows(n),
        *ptrs[:4], wk.data_ptr() if ws is not None else None, wk.stride(0),
        v, padded_rows(v), *ptrs[4:], d, _stream(x))
    _check_launch(lib, err, 3, "fused_ce_split", d)
    launch_counts["fused_ce_split"] += 1
    return CESplit(w=ws, x=xs)


def _bwd_launch(which: int, x, w, labels, lse, dce, split):
    name = ("fused_ce_dx", "fused_ce_dw")[which - 1]
    xk, wk, lab, (lse, dce) = _check_cuda_inputs(
        f"{name}_cuda", x, w, labels, (("lse", lse), ("dce", dce)))
    n, d = xk.shape
    v = wk.shape[0]
    part = (split.w if which == 1 else split.x) if split is not None else None
    if part is None:
        own_split = fused_ce_split_cuda(xk, wk, for_dx=which == 1,
                                        for_dw=which == 2)
        part = own_split.w if which == 1 else own_split.x
    rows, streamed = (n, v) if which == 1 else (v, n)
    want = ((streamed, d), (streamed, d), (d, padded_rows(streamed)),
            (d, padded_rows(streamed)))
    if tuple(tuple(t.shape) if t is not None else None
             for t in part) != want:
        raise ValueError(f"{name}_cuda: the split does not match x/w")
    own = xk if which == 1 else wk
    out = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    lib = _kernel_lib()
    # a stream of more than 4096 rows is summed in parts (the tensor
    # core's f32 sums truncate) and the parts added in a fixed order
    ws_floats = lib.dtf_fused_ce_workspace_floats(which, n, v, d)
    ws = (torch.empty(ws_floats, dtype=torch.float32, device=x.device)
          if ws_floats else None)
    fn = lib.dtf_fused_ce_dx_f32 if which == 1 else lib.dtf_fused_ce_dw_f32
    err = fn(own.data_ptr(), own.stride(0), *(t.data_ptr() for t in part),
             padded_rows(streamed), lab.data_ptr(), lse.data_ptr(),
             dce.data_ptr(), out.data_ptr(),
             ws.data_ptr() if ws is not None else None, n, v, d, _stream(x))
    _check_launch(lib, err, which, name, d)
    launch_counts[name] += 1
    return out


def fused_ce_dx_cuda(x, w, labels, lse, dce,
                     split: Optional[CESplit] = None) -> torch.Tensor:
    """Launch B6: dx [N, D] in x's dtype from the saved lse and the
    per-token cotangent dce (both f32 [N]). ``split``: the backward's
    split pass (W's part), launched here if not given."""
    return _bwd_launch(1, x, w, labels, lse, dce, split).to(x.dtype)


def fused_ce_dw_cuda(x, w, labels, lse, dce,
                     split: Optional[CESplit] = None) -> torch.Tensor:
    """Launch B7: dW [V, D] f32, the head parameter's own layout.
    ``split``: the backward's split pass (x's part), launched here if not
    given."""
    return _bwd_launch(2, x, w, labels, lse, dce, split)


def max_active_clusters(which: int, d: int) -> int:
    """How many clusters of B6 (``which`` 1) or B7 (2) the card holds at
    once at head width ``d`` (``cudaOccupancyMaxActiveClusters``): the
    size of one wave."""
    return _kernel_lib().dtf_fused_ce_max_clusters(which, d)


def _on_cpu(*ts) -> bool:
    devices = {t.device.type for t in ts}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"x/w/labels on mixed devices: {sorted(devices)}")


class _FusedCE(torch.autograd.Function):
    """The differentiable fused CE (``_fused_ce``'s ``custom_vjp``).
    Forward: the split pass (W's stored hi/lo for B5; with them, what the
    backward will read: W's transposed pair if x needs a gradient, x's
    four if W does), per-token (lse, tgt) from B5 and the merge, then the
    masked sum and the valid count in PyTorch, as the reference computes
    them outside its kernel. With a ``group`` (tokens split over its
    ranks) the sum and the count are all-reduced, explicitly, and every
    rank returns the global (mean, count). Backward: dce = (g_mean /
    cnt)·valid with the global count, then B6 and B7 on the forward's
    split: dX of this rank's tokens, and dW as this rank's part of the
    sum, which the train step's reduction over ranks completes (the
    reference leaves both halves to shard_map's transpose convention;
    ADVICE.md #1). The count is not differentiable. CPU tensors take the
    plain versions."""

    @staticmethod
    def forward(ctx, x, w, labels, ignore_index, group=None):
        ctx.split = None
        if _on_cpu(x, w, labels):
            lse, tgt = fused_ce_fwd_reference(x, w, labels)
        else:
            labels = labels.to(torch.int32)     # once, for every kernel
            want_dx, want_dw = ctx.needs_input_grad[:2]
            ctx.split = fused_ce_split_cuda(x, w, for_fwd=True,
                                            for_dx=want_dx, for_dw=want_dw)
            lse, tgt = fused_ce_fwd_cuda(x, w, labels, ctx.split)
        if ignore_index is None:
            valid = torch.ones_like(lse)
        else:
            valid = (labels != ignore_index).to(lse.dtype)
        if group is None:
            cnt = valid.sum().clamp_min(1.0)
            mean = ((lse - tgt) * valid).sum() / cnt
        else:
            import torch.distributed as dist

            sums = torch.stack([((lse - tgt) * valid).sum(), valid.sum()])
            dist.all_reduce(sums, group=group)
            cnt = sums[1].clamp_min(1.0)
            mean = sums[0] / cnt
        ctx.save_for_backward(x, w, labels, lse, valid, cnt)
        ctx.mark_non_differentiable(cnt)
        return mean, cnt

    @staticmethod
    def backward(ctx, g_mean, _g_cnt):
        x, w, labels, lse, valid, cnt = ctx.saved_tensors
        dce = (g_mean / cnt) * valid
        want_dx, want_dw = ctx.needs_input_grad[:2]
        if _on_cpu(x, w, labels):
            dx, dw = fused_ce_bwd_reference(x, w, labels, lse, dce)
            return (dx if want_dx else None, dw if want_dw else None,
                    None, None, None)
        split, ctx.split = ctx.split, None
        dx = (fused_ce_dx_cuda(x, w, labels, lse, dce, split) if want_dx
              else None)
        dw = (fused_ce_dw_cuda(x, w, labels, lse, dce, split) if want_dw
              else None)
        return dx, dw, None, None, None


def fused_lm_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                           labels: torch.Tensor, *,
                           ignore_index: Optional[int] = None,
                           mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean_loss, valid_count) — the contract of
    :func:`dtf_tpu_torch.ops.losses.softmax_cross_entropy` on
    ``x @ w.T``, without the [N, V] logits.

    ``x`` [..., D] (pre-head activations; bf16 is promoted to f32 and its
    gradient returned as bf16), ``w`` [V, D] f32 (``lm_head.weight``),
    ``labels`` [...] int. With ``ignore_index``, ignored positions count
    0 and the mean is over the valid ones, the count clamped to 1. A
    label outside [0, V) picks no logit (its CE is the lse).

    ``mesh`` (:mod:`dtf_tpu_torch.core.mesh`): the token-sharded variant
    (``pallas_lm_cross_entropy_sharded``). ``x`` and ``labels`` are this
    rank's tokens of the data axis, ``w`` whole on every rank; each rank
    runs the kernels on its own tokens, and the mean and the count are
    the global ones (:class:`_FusedCE`). The vocab stays whole, so a
    model axis > 1 raises."""
    group = None
    if mesh is not None:
        if mesh.model_size > 1:
            raise ValueError(
                "the fused CE keeps the vocab whole per rank; it cannot "
                "combine with a model (TP) mesh axis — use the standard "
                "loss")
        group = mesh.data_group
    xf = x.reshape(-1, x.shape[-1])
    if not torch.is_grad_enabled():
        # no backward will run: the forward then splits W's stored pair
        # alone (inside the Function, needs_input_grad still reads
        # requires_grad)
        xf, w = xf.detach(), w.detach()
    return _FusedCE.apply(xf, w, labels.reshape(-1), ignore_index, group)
