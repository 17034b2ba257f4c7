"""Attention ops: the dense reference (counterpart of ``dtf_tpu.ops.attention``).

Layout [batch, heads, seq, head_dim] (B H T D), as in the JAX package.
Scores and the softmax are float32 whatever the input dtype. Ring, zigzag
and halo attention (sequence parallelism) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    window: int = 0,
                    bias: Optional[torch.Tensor] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Reference O(T²) attention. [B,H,T,D] → [B,H,T,D]; f32 softmax.

    ``window > 0`` (requires ``causal``): query t attends keys in
    (t-window, t]. ``bias`` is added to the f32 scores (broadcast to
    [B,H,T_q,T_k]). A row whose scores are all -inf gives 0, not NaN.
    """
    t_q, d = q.shape[-2], q.shape[-1]
    t_k = k.shape[-2]
    if window < 0 or (window and not causal):
        raise ValueError(
            f"window={window} must be >= 0 and requires causal=True")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    # products of the input dtype summed in f32 (preferred_element_type)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        q_pos = torch.arange(t_q, device=q.device)[:, None]
        k_pos = torch.arange(t_k, device=q.device)[None, :]
        keep = q_pos >= k_pos
        if window:
            keep = keep & (q_pos - k_pos < window)
        scores = scores.masked_fill(~keep, float("-inf"))
    dead = torch.isneginf(scores).all(dim=-1, keepdim=True)
    probs = torch.softmax(scores.masked_fill(dead, 0.0), dim=-1)
    probs = probs.masked_fill(dead, 0.0)
    out = torch.matmul(probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)
