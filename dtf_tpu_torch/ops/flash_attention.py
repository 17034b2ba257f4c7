"""Flash attention, forward and backward (counterpart of ``dtf_tpu.ops.flash_attention``).

Side by side, for each direction:

- :func:`flash_attention_reference` / :func:`flash_attention_bwd_reference`:
  the plain PyTorch versions. The forward returns ``(out, lse)`` as the
  JAX package's ``_fwd`` does: ``out`` [B·H, T_q, D] in the input dtype,
  ``lse`` [B·H, T_q] f32; a row whose keys are all masked gives
  ``out = 0`` and ``lse = -inf``. The backward is ``_bwd``: ``(dq, dk,
  dv)`` in the input dtype, a dead row's gradient 0.
- :func:`flash_attention_cuda` / :func:`flash_attention_bwd_cuda`: the
  wrappers of the hand-written Hopper kernels ``csrc/flash_fwd.cu``
  (replaces the Pallas ``_fwd_kernel`` and ``_fwd_kernel_hfold``) and
  ``csrc/flash_bwd.cu`` (``_dq_kernel`` and ``_dkv_kernel``), with the
  same contracts. They count their launches in :data:`launch_counts`.
- :func:`flash_attention`: the public [B, H, T, D] entry, differentiable
  through :class:`_Flash` (the counterpart of ``_flash``'s
  ``custom_vjp``). CPU tensors take the plain versions, CUDA tensors the
  kernels; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: head dims the kernels are compiled for (their 64×64 tiles are
#: constants of csrc/flash_*.cu, not read from the JAX package's tuning
#: cache)
HEAD_DIMS = (64, 128)

#: rows of the kernels' q- and k-blocks: one grid-y step each
BLOCK_ROWS = 64
#: the card's grid limits: x up to 2³¹ − 1 blocks, y up to 65,535
GRID_X_MAX, GRID_Y_MAX = 2 ** 31 - 1, 65535

#: Launches of the CUDA kernels, by the TPU kernel each call stands for:
#: ``flash_fwd`` (B1, ``block_h == 1``), ``flash_fwd_hfold`` (B4,
#: ``block_h > 1``), ``flash_dq`` (B2) and ``flash_dkv`` (B3). Plain
#: integers; :func:`reset_launch_counts` zeroes them.
launch_counts = {"flash_fwd": 0, "flash_fwd_hfold": 0, "flash_dq": 0,
                 "flash_dkv": 0}

_NEG_INF = float("-inf")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _mask_bias(kv_mask: torch.Tensor, b: int, t_k: int) -> torch.Tensor:
    """[b, 1, t_k] f32 additive bias: 0 valid, -inf padded key. Per
    batch, not per (batch·head): every head reads the same row. Unpadded
    — the kernel masks its own ragged edge."""
    bias = torch.zeros(kv_mask.shape, dtype=torch.float32,
                       device=kv_mask.device)
    bias = bias.masked_fill(~kv_mask.bool(), _NEG_INF)
    return bias.reshape(b, 1, t_k)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working type: f32 for bf16/f32 inputs (the
    kernels' sums), f64 for f64 inputs (so gradcheck can run)."""
    return torch.promote_types(x.dtype, torch.float32)


def _scores(q, k, mask_bias, *, sm_scale, causal, window, acc):
    """The masked scores [B,H,T_q,T_k] in ``acc``: input-dtype products
    summed in ``acc``, times sm_scale, the ``_score_mask`` rule, then the
    bias row."""
    t_q, t_k = q.shape[2], k.shape[2]
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * sm_scale
    if causal:
        q_pos = torch.arange(t_q, device=q.device)[:, None]
        k_pos = torch.arange(t_k, device=q.device)[None, :]
        keep = q_pos >= k_pos
        if window:
            keep = keep & (q_pos - k_pos < window)
        s = s.masked_fill(~keep, _NEG_INF)
    if mask_bias is not None:
        s = s + mask_bias[:, None].to(acc)                 # [B,1,1,T_k]
    return s


def flash_attention_reference(q, k, v, mask_bias=None, *, sm_scale: float,
                              causal: bool = False, window: int = 0):
    """The plain forward: q [B,H,T_q,D], k/v [B,H,T_k,D], mask_bias
    [B,1,T_k] f32 or None → (out [B·H,T_q,D] in q's dtype, lse [B·H,T_q]
    f32). The same math as the kernel in one pass: f32 scores of the
    input-dtype products, the ``_score_mask`` rule, then the bias row; p
    relative to the row max is cast to v's dtype before P·V; out = P·V / l."""
    b, h, t_q, d = q.shape
    acc = _acc_dtype(q)
    s = _scores(q, k, mask_bias, sm_scale=sm_scale, causal=causal,
                window=window, acc=acc)
    m = s.amax(dim=-1, keepdim=True)
    # a fully masked row keeps m == -inf; a 0 stand-in keeps exp finite
    m_safe = torch.where(m == _NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.matmul(p.to(v.dtype).to(acc), v.to(acc)) / l_safe
    lse = torch.where(l == 0.0, torch.full_like(l, _NEG_INF),
                      m + torch.log(l_safe))
    return (out.to(q.dtype).reshape(b * h, t_q, d),
            lse.reshape(b * h, t_q))


def flash_attention_bwd_reference(q, k, v, mask_bias, out, lse, do, *,
                                  sm_scale: float, causal: bool = False,
                                  window: int = 0):
    """The plain backward (``_bwd``): q/do [B,H,T_q,D], k/v [B,H,T_k,D],
    mask_bias [B,1,T_k] or None, the forward's out (any shape of
    [B·H,T_q,D]) and lse [B·H,T_q] → (dq, dk, dv) shaped like q, k, v in
    the input dtype.

    Δ = rowsum(dO∘O) in f32 from the saved ``out``; P = exp(S − lse),
    forced to 0 where lse = −inf; dP = dO·Vᵀ; dS = P∘(dP − Δ)·sm_scale;
    dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO, with P cast to dO's dtype and dS to
    K's / Q's dtype before their products, as the kernels cast them."""
    b, h, t_q, d = q.shape
    acc = _acc_dtype(q)
    out = out.reshape(b, h, t_q, d)
    lse = lse.reshape(b, h, t_q, 1).to(acc)
    delta = (do.to(acc) * out.to(acc)).sum(dim=-1, keepdim=True)
    s = _scores(q, k, mask_bias, sm_scale=sm_scale, causal=causal,
                window=window, acc=acc)
    dead = torch.isneginf(lse)
    p = torch.where(dead, torch.zeros_like(s),
                    torch.exp(s - torch.where(dead, torch.zeros_like(lse),
                                              lse)))
    dv = torch.matmul(p.to(do.dtype).to(acc).transpose(-1, -2), do.to(acc))
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    ds = p * (dp - delta) * sm_scale
    dq = torch.matmul(ds.to(k.dtype).to(acc), k.to(acc))
    dk = torch.matmul(ds.to(q.dtype).to(acc).transpose(-1, -2), q.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_libs: dict = {}


def _kernel_lib(name: str):
    """The built kernel library ``name``, with its C signatures declared."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    from dtf_tpu_torch.ops import _build

    lib = _build.load(name)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # every pointer and the stream as c_void_p: an untyped ctypes argument
    # is passed as a 32-bit int and cuts the pointer
    if name == "flash_fwd":
        lib.dtf_flash_fwd_bf16.argtypes = (
            [p] * 6 + [i] * 5 + [ll] * 9 + [ctypes.c_float, i, i, i, p])
        lib.dtf_flash_fwd_bf16.restype = i
        lib.dtf_cuda_error_string.argtypes = [i]
        lib.dtf_cuda_error_string.restype = ctypes.c_char_p
        lib.dtf_flash_fwd_smem_bytes.argtypes = [i]
        lib.dtf_flash_fwd_smem_bytes.restype = ll
    else:
        tail = [ll] * 12 + [ctypes.c_float, i, i, p]
        lib.dtf_flash_bwd_dq_bf16.argtypes = [p] * 8 + [i] * 5 + tail
        lib.dtf_flash_bwd_dq_bf16.restype = i
        lib.dtf_flash_bwd_dkv_bf16.argtypes = [p] * 9 + [i] * 5 + tail
        lib.dtf_flash_bwd_dkv_bf16.restype = i
        lib.dtf_flash_bwd_error_string.argtypes = [i]
        lib.dtf_flash_bwd_error_string.restype = ctypes.c_char_p
        lib.dtf_flash_bwd_smem_bytes.argtypes = [i, i]
        lib.dtf_flash_bwd_smem_bytes.restype = ll
    _libs[name] = lib
    return lib


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel can read it through its strides (last dim
    contiguous, 16-byte aligned rows), else a contiguous copy."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()


def _check_cuda_inputs(fn: str, q, named) -> None:
    """The checks every wrapper makes: one GPU, bf16 and a compiled head
    dim (the grid's limits are :func:`check_grid`'s)."""
    b, h, _, d = q.shape
    for name, x in named:
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{fn}: {name} is on {x.device} (q on "
                             f"{q.device}); the kernel takes one GPU")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{fn}: {name} is {x.dtype}; the Hopper "
                             "kernel takes bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"{fn}: head_dim {d} is not supported by the Hopper kernel "
            f"(compiled for {HEAD_DIMS})")


def check_grid(b: int, h: int, t_q: int, t_k: int, *, block_h: int = 1,
               backward: bool = False) -> None:
    """Raise unless the kernels' grids launch at these sizes. Grid x holds
    B·H/``block_h`` head groups (B·H in the backward), up to
    :data:`GRID_X_MAX`; grid y holds the ⌈T_q/64⌉ q-blocks of the forward
    and dQ and, for dK/dV (``backward``), the ⌈T_k/64⌉ k-blocks, up to
    :data:`GRID_Y_MAX`. The Pallas grids take any size; these limits are
    the card's."""
    groups = b * h // block_h
    if groups > GRID_X_MAX:
        raise ValueError(f"B·H/block_h = {groups} exceeds the grid's x "
                         f"limit ({GRID_X_MAX})")
    sizes = (("T_q", t_q), ("T_k", t_k)) if backward else (("T_q", t_q),)
    for name, t in sizes:
        blocks = -(-t // BLOCK_ROWS)
        if blocks > GRID_Y_MAX:
            raise ValueError(
                f"{name} = {t} takes {blocks} blocks of {BLOCK_ROWS} rows, "
                f"above the grid's y limit ({GRID_Y_MAX})")


def _cuda_bias(mask_bias, q, b, t_k):
    if mask_bias is None:
        return None
    mask_bias = mask_bias.to(device=q.device, dtype=torch.float32).contiguous()
    if mask_bias.shape != (b, 1, t_k):
        raise ValueError(f"mask_bias {tuple(mask_bias.shape)} != "
                         f"({b}, 1, {t_k})")
    return mask_bias


def flash_attention_cuda(q, k, v, mask_bias=None, *, sm_scale: float,
                         causal: bool = False, window: int = 0,
                         block_h: int = 1):
    """Launch the Hopper forward kernel: the contract of
    :func:`flash_attention_reference`, on CUDA bf16 tensors, with
    ``block_h`` heads per CTA. Raises on what the kernel does not take;
    never computes the result another way."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    _check_cuda_inputs("flash_attention_cuda", q,
                       (("q", q), ("k", k), ("v", v)))
    if k.shape != (b, h, t_k, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if block_h < 1 or h % block_h:
        raise ValueError(f"block_h={block_h} must be >= 1 and divide "
                         f"heads={h}")
    check_grid(b, h, t_q, t_k, block_h=block_h)
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty((b * h, t_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t_q), dtype=torch.float32, device=q.device)
    mask_bias = _cuda_bias(mask_bias, q, b, t_k)
    lib = _kernel_lib("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dtf_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask_bias is None else mask_bias.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, t_q, t_k, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(sm_scale), int(bool(causal)), int(window), int(block_h),
        stream)
    if err:
        raise RuntimeError(
            f"flash_fwd launch failed: "
            f"{lib.dtf_cuda_error_string(err).decode()} (error {err}; "
            f"{lib.dtf_flash_fwd_smem_bytes(d)} bytes of shared memory per "
            f"CTA at head_dim {d})")
    launch_counts["flash_fwd" if block_h == 1 else "flash_fwd_hfold"] += 1
    return out, lse


def _bwd_args(q, k, v, do, lse, delta, mask_bias):
    """The checked, kernel-readable operands and the C argument list
    shared by the two backward kernels (pointers, sizes, strides)."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    _check_cuda_inputs("flash_attention_bwd_cuda", q,
                       (("q", q), ("k", k), ("v", v), ("do", do)))
    if (k.shape != (b, h, t_k, d) or v.shape != k.shape
            or do.shape != q.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} / do "
                         f"{tuple(do.shape)} do not match q "
                         f"{tuple(q.shape)}")
    check_grid(b, h, t_q, t_k, backward=True)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or x.numel() != b * h * t_q:
            raise ValueError(f"{name} must be f32 [B·H, T_q], got "
                             f"{x.dtype} {tuple(x.shape)}")
    q, k, v, do = (_kernel_view(x) for x in (q, k, v, do))
    lse, delta = lse.contiguous(), delta.contiguous()
    mask_bias = _cuda_bias(mask_bias, q, b, t_k)
    keep = (q, k, v, do, lse, delta, mask_bias)     # alive until launched
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if mask_bias is None else mask_bias.data_ptr()]
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *do.stride()[:3]]
    return keep, ptrs, (b, h, t_q, t_k, d), strides


def _bwd_check(lib, err, which: int, name: str, d: int) -> None:
    if err:
        raise RuntimeError(
            f"{name} launch failed: "
            f"{lib.dtf_flash_bwd_error_string(err).decode()} (error {err}; "
            f"{lib.dtf_flash_bwd_smem_bytes(which, d)} bytes of shared "
            f"memory per CTA at head_dim {d})")


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, mask_bias=None, *,
                      sm_scale: float, causal: bool = False,
                      window: int = 0) -> torch.Tensor:
    """Launch the dQ kernel (B2): dq [B,H,T_q,D] bf16 from the saved lse
    and Δ = rowsum(dO∘O) (both f32 [B·H, T_q])."""
    keep, ptrs, (b, h, t_q, t_k, d), strides = _bwd_args(
        q, k, v, do, lse, delta, mask_bias)
    dq = torch.empty((b, h, t_q, d), dtype=torch.bfloat16, device=q.device)
    lib = _kernel_lib("flash_bwd")
    err = lib.dtf_flash_bwd_dq_bf16(
        *ptrs, dq.data_ptr(), b, h, t_q, t_k, d, *strides, float(sm_scale),
        int(bool(causal)), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    del keep
    _bwd_check(lib, err, 0, "flash_dq", d)
    launch_counts["flash_dq"] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, mask_bias=None, *,
                       sm_scale: float, causal: bool = False,
                       window: int = 0):
    """Launch the dK/dV kernel (B3): (dk, dv) [B,H,T_k,D] bf16."""
    keep, ptrs, (b, h, t_q, t_k, d), strides = _bwd_args(
        q, k, v, do, lse, delta, mask_bias)
    dk = torch.empty((b, h, t_k, d), dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    lib = _kernel_lib("flash_bwd")
    err = lib.dtf_flash_bwd_dkv_bf16(
        *ptrs, dk.data_ptr(), dv.data_ptr(), b, h, t_q, t_k, d, *strides,
        float(sm_scale), int(bool(causal)), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    del keep
    _bwd_check(lib, err, 1, "flash_dkv", d)
    launch_counts["flash_dkv"] += 1
    return dk, dv


def flash_attention_bwd_cuda(q, k, v, mask_bias, out, lse, do, *,
                             sm_scale: float, causal: bool = False,
                             window: int = 0):
    """The contract of :func:`flash_attention_bwd_reference` on CUDA bf16
    tensors: Δ = rowsum(dO∘O) in f32 from the saved bf16 ``out`` (in
    PyTorch, as the JAX package computes it in XLA outside its kernels),
    then the dQ and the dK/dV kernels."""
    b, h, t_q, d = q.shape
    delta = (do.float() * out.reshape(b, h, t_q, d).float()).sum(dim=-1)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, mask_bias,
                           sm_scale=sm_scale, causal=causal, window=window)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, mask_bias,
                                sm_scale=sm_scale, causal=causal,
                                window=window)
    return dq, dk, dv


def _on_cpu(*xs) -> bool:
    devices = {x.device.type for x in xs}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"q/k/v on mixed devices: {sorted(devices)}")


class _Flash(torch.autograd.Function):
    """The differentiable flash call (``_flash``'s ``custom_vjp``): the
    forward keeps ``(q, k, v, mask_bias, out, lse)``; the backward
    recomputes P from ``lse`` and returns a zero gradient for the bias.
    CPU tensors take the plain versions, CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, mask_bias, sm_scale, causal, window, block_h):
        b, h, t_q, d = q.shape
        if _on_cpu(q, k, v):
            out, lse = flash_attention_reference(
                q, k, v, mask_bias, sm_scale=sm_scale, causal=causal,
                window=window)
        else:
            out, lse = flash_attention_cuda(
                q, k, v, mask_bias, sm_scale=sm_scale, causal=causal,
                window=window, block_h=block_h)
        ctx.save_for_backward(q, k, v, mask_bias, out, lse)
        ctx.opts = dict(sm_scale=sm_scale, causal=causal, window=window)
        return out.reshape(b, h, t_q, d)

    @staticmethod
    def backward(ctx, do):
        # block_h is a forward-only lever, as in _flash_bwd
        q, k, v, mask_bias, out, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_reference if _on_cpu(q, k, v)
               else flash_attention_bwd_cuda)
        dq, dk, dv = bwd(q, k, v, mask_bias, out, lse, do, **ctx.opts)
        dmb = None if mask_bias is None else torch.zeros_like(mask_bias)
        return dq, dk, dv, dmb, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    window: int = 0,
                    kv_mask: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None,
                    block_h: int = 0) -> torch.Tensor:
    """Fused attention. [B, H, T, D] → [B, H, T, D]; differentiable.

    ``sm_scale`` defaults to ``1/sqrt(head_dim)``. ``kv_mask``: [B, T_k]
    bool, True = valid key; a query row whose keys are all masked gives 0
    and gradient 0. ``window > 0`` (requires ``causal``): query t attends
    keys in (t-window, t], and the kernels visit only the in-window
    blocks. ``block_h`` (0 = 1): heads per CTA of the forward kernel; must
    divide ``heads``.

    CPU tensors take :func:`flash_attention_reference` and
    :func:`flash_attention_bwd_reference`; CUDA tensors take the Hopper
    kernels or raise.
    """
    if q.ndim != 4:
        raise ValueError(f"expected [B, H, T, D], got shape {tuple(q.shape)}")
    if window < 0 or (window and not causal):
        raise ValueError(
            f"window={window} must be >= 0 and requires causal=True")
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    block_h = block_h or 1
    if block_h < 1 or h % block_h:
        raise ValueError(f"block_h={block_h} must be >= 1 and divide "
                         f"heads={h}")
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    mask_bias = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, t_k):
            raise ValueError(
                f"kv_mask shape {tuple(kv_mask.shape)} != (batch, t_k)="
                f"({b}, {t_k})")
        mask_bias = _mask_bias(kv_mask, b, t_k)
    return _Flash.apply(q, k, v, mask_bias, scale, bool(causal), int(window),
                        block_h)
