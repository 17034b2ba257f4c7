"""Losses (counterpart of ``dtf_tpu.ops.losses``): the monolithic softmax
cross-entropy and its ignore/mean tail. The vocab- and token-chunked LM
losses and the fused head + CE kernels (B5–B7) come with a later slice."""

from __future__ import annotations

from typing import Optional

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          ignore_index: Optional[int] = None,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example CE for integer labels: logits [..., V], labels [...].
    Returns (mean_loss, valid_count), both f32 scalars. The logsumexp is
    taken in f32. With ``ignore_index`` (e.g. -100), ignored positions
    contribute 0 and the mean is over the valid positions only."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe = labels
    if ignore_index is not None:
        safe = torch.where(labels != ignore_index, labels,
                           torch.zeros_like(labels))
    picked = torch.gather(logits, -1, safe.long()[..., None])[..., 0]
    return _masked_mean(lse - picked, labels, ignore_index)


def _masked_mean(ce: torch.Tensor, labels: torch.Tensor,
                 ignore_index: Optional[int]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean over valid, valid_count), the count clamped to 1 so that an
    all-ignored batch gives 0.0 rather than NaN."""
    if ignore_index is None:
        return ce.mean(), torch.tensor(float(ce.numel()), device=ce.device)
    valid = labels != ignore_index
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    n = valid.sum().float().clamp_min(1.0)
    return ce.sum() / n, n
