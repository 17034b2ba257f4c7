"""Flash attention, forward only (counterpart of ``dtf_tpu.ops.flash_attention``).

Three pieces side by side:

- :func:`flash_attention_reference`: the plain PyTorch forward. It returns
  ``(out, lse)`` as the JAX package's ``_fwd`` does: ``out`` [B·H, T_q, D]
  in the input dtype, ``lse`` [B·H, T_q] f32; a row whose keys are all
  masked gives ``out = 0`` and ``lse = -inf``.
- :func:`flash_attention_cuda`: the wrapper of the hand-written Hopper
  kernel ``csrc/flash_fwd.cu`` (replaces the Pallas ``_fwd_kernel`` and
  ``_fwd_kernel_hfold``), with the same contract. It counts its launches
  in :data:`launch_counts`.
- :func:`flash_attention`: the public [B, H, T, D] entry. CPU tensors go
  to the reference, CUDA tensors to the kernel; nothing falls back.

The backward kernels (dQ, dK/dV) come with the training slice, so the
public entry refuses tensors that require grad.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: head dims the kernel is compiled for (its 64×64 tiles are constants
#: of csrc/flash_fwd.cu, not read from the JAX package's tuning cache)
HEAD_DIMS = (64, 128)

#: Launches of the CUDA kernel, by the TPU kernel each call stands for:
#: ``flash_fwd`` (B1, ``block_h == 1``) and ``flash_fwd_hfold`` (B4,
#: ``block_h > 1``). Plain integers; :func:`reset_launch_counts` zeroes them.
launch_counts = {"flash_fwd": 0, "flash_fwd_hfold": 0}

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


def flash_attention_reference(q, k, v, mask_bias=None, *, sm_scale: float,
                              causal: bool = False, window: int = 0):
    """The plain forward: q [B,H,T_q,D], k/v [B,H,T_k,D], mask_bias
    [B,1,T_k] f32 or None → (out [B·H,T_q,D] in q's dtype, lse [B·H,T_q]
    f32). The same math as the kernel in one pass: f32 scores of the
    input-dtype products, the ``_score_mask`` rule, then the bias row; p
    relative to the row max is cast to v's dtype before P·V; out = P·V / l."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        q_pos = torch.arange(t_q, device=q.device)[:, None]
        k_pos = torch.arange(t_k, device=q.device)[None, :]
        keep = q_pos >= k_pos
        if window:
            keep = keep & (q_pos - k_pos < window)
        s = s.masked_fill(~keep, _NEG_INF)
    if mask_bias is not None:
        s = s + mask_bias[:, None]                       # [B,1,1,T_k]
    m = s.amax(dim=-1, keepdim=True)
    # a fully masked row keeps m == -inf; a 0 stand-in keeps exp finite
    m_safe = torch.where(m == _NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = torch.where(l == 0.0, torch.full_like(l, _NEG_INF),
                      m + torch.log(l_safe))
    return (out.to(q.dtype).reshape(b * h, t_q, d),
            lse.reshape(b * h, t_q))


_lib = None


def _kernel_lib():
    """The built kernel library, with its C signatures declared."""
    global _lib
    if _lib is None:
        from dtf_tpu_torch.ops import _build

        lib = _build.load("flash_fwd")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # every pointer and the stream as c_void_p: an untyped ctypes
        # argument is passed as a 32-bit int and cuts the pointer
        lib.dtf_flash_fwd_bf16.argtypes = (
            [p] * 6 + [i] * 5 + [ll] * 9 + [ctypes.c_float, i, i, i, p])
        lib.dtf_flash_fwd_bf16.restype = i
        lib.dtf_cuda_error_string.argtypes = [i]
        lib.dtf_cuda_error_string.restype = ctypes.c_char_p
        lib.dtf_flash_fwd_smem_bytes.argtypes = [i]
        lib.dtf_flash_fwd_smem_bytes.restype = ll
        _lib = lib
    return _lib


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel can read it through its strides (last dim
    contiguous, 16-byte aligned rows), else a contiguous copy."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()


def flash_attention_cuda(q, k, v, mask_bias=None, *, sm_scale: float,
                         causal: bool = False, window: int = 0,
                         block_h: int = 1):
    """Launch the Hopper kernel: the contract of
    :func:`flash_attention_reference`, on CUDA bf16 tensors, with
    ``block_h`` heads per CTA. Raises on what the kernel does not take;
    never computes the result another way."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} is on {x.device}"
                             f" (q on {q.device}); the kernel takes one GPU")
        if x.dtype != torch.bfloat16:
            raise ValueError(
                f"flash_attention_cuda: {name} is {x.dtype}; the Hopper "
                "kernel takes bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention_cuda: head_dim {d} is not supported by the "
            f"Hopper kernel (compiled for {HEAD_DIMS})")
    if k.shape != (b, h, t_k, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if block_h < 1 or h % block_h:
        raise ValueError(f"block_h={block_h} must be >= 1 and divide "
                         f"heads={h}")
    if (b * h) // block_h > 65535:
        raise ValueError(f"B·H/block_h = {(b * h) // block_h} exceeds the "
                         "grid's y limit (65535); raise block_h")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty((b * h, t_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t_q), dtype=torch.float32, device=q.device)
    bias_ptr = None
    if mask_bias is not None:
        mask_bias = mask_bias.to(device=q.device,
                                 dtype=torch.float32).contiguous()
        if mask_bias.shape != (b, 1, t_k):
            raise ValueError(f"mask_bias {tuple(mask_bias.shape)} != "
                             f"({b}, 1, {t_k})")
        bias_ptr = mask_bias.data_ptr()
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dtf_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    window: int = 0,
                    kv_mask: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None,
                    block_h: int = 0) -> torch.Tensor:
    """Fused attention forward. [B, H, T, D] → [B, H, T, D].

    ``sm_scale`` defaults to ``1/sqrt(head_dim)``. ``kv_mask``: [B, T_k]
    bool, True = valid key; a query row whose keys are all masked gives 0.
    ``window > 0`` (requires ``causal``): query t attends keys in
    (t-window, t], and the kernel visits only the in-window k-blocks.
    ``block_h`` (0 = 1): heads per CTA; must divide ``heads``.

    CPU tensors take :func:`flash_attention_reference`; CUDA tensors take
    the Hopper kernel or raise. Forward only: tensors that require grad
    are refused until the backward kernels are ported.
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
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in the port: the backward "
            "kernels (dQ, dK/dV) come with the training slice; use "
            "dense_attention for gradients")
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    mask_bias = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, t_k):
            raise ValueError(
                f"kv_mask shape {tuple(kv_mask.shape)} != (batch, t_k)="
                f"({b}, {t_k})")
        mask_bias = _mask_bias(kv_mask, b, t_k)
    devices = {x.device.type for x in (q, k, v)}
    if devices == {"cpu"}:
        out, _ = flash_attention_reference(
            q, k, v, mask_bias, sm_scale=scale, causal=causal,
            window=int(window))
    elif devices == {"cuda"}:
        out, _ = flash_attention_cuda(
            q, k, v, mask_bias, sm_scale=scale, causal=causal,
            window=int(window), block_h=block_h)
    else:
        raise ValueError(f"q/k/v on mixed devices: {sorted(devices)}")
    return out.reshape(b, h, t_q, d)
