"""Losses (counterpart of ``dtf_tpu.ops.losses``): the monolithic softmax
cross-entropy and its ignore/mean tail, and the vocab- and token-chunked
LM losses that never hold the whole [N, V] logits, and the vocab-parallel
cross-entropy of tensor parallelism. The fused head + CE kernels (B5–B7)
are :mod:`dtf_tpu_torch.ops.fused_ce`."""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


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


def valid_count(labels: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """The labels that are not ``ignore_index``, as an f32 scalar, NOT
    clamped: a rank's part of a data group's count (the clamp at 1 of
    :func:`_masked_mean` belongs to the whole group's batch)."""
    return (labels != ignore_index).sum().float()


class _VocabParallelCE(torch.autograd.Function):
    """Per-token CE of logits split over ``group`` along the vocab: this
    rank holds columns [start, start + V/m). Forward: the global max (one
    all-reduce), then the sum of exponentials and the target logit (one
    all-reduce of both); backward: this rank's softmax columns minus its
    columns of the one-hot, no collective."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        from dtf_tpu_torch.core import comms
        import torch.distributed as dist

        m = comms.psum(logits.amax(dim=-1), group, op=dist.ReduceOp.MAX)
        local = labels - start
        hit = (local >= 0) & (local < logits.shape[-1])
        local = local.clamp(0, logits.shape[-1] - 1)
        shifted = logits - m[:, None]
        picked = torch.where(hit, shifted.gather(-1, local[:, None])[:, 0],
                             torch.zeros_like(m))
        sums = comms.psum(
            torch.stack([torch.exp(shifted).sum(dim=-1), picked]), group)
        ctx.save_for_backward(logits, m, sums[0], local, hit)
        return torch.log(sums[0]) - sums[1]

    @staticmethod
    def backward(ctx, g):
        logits, m, s, local, hit = ctx.saved_tensors
        grad = torch.exp(logits - m[:, None]) * (g / s)[:, None]
        grad.scatter_add_(1, local[:, None],
                          torch.where(hit, -g, torch.zeros_like(g))[:, None])
        return grad, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 group, *, ignore_index: Optional[int] = None,
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`softmax_cross_entropy` of logits whose vocab is split over
    ``group`` (the vocab-parallel LM head of tensor parallelism): this
    rank's ``logits`` [..., V/m] are columns [r·V/m, (r+1)·V/m) of the
    whole, r its rank in the group. The same ``(mean, valid_count)`` on
    every rank of the group, the ignore/mean tail the same."""
    import torch.distributed as dist

    logits = logits.float()
    vl = logits.shape[-1]
    safe = labels
    if ignore_index is not None:
        safe = torch.where(labels != ignore_index, labels,
                           torch.zeros_like(labels))
    ce = _VocabParallelCE.apply(logits.reshape(-1, vl),
                                safe.reshape(-1).long(),
                                dist.get_rank(group) * vl, group)
    return _masked_mean(ce.reshape(labels.shape), labels, ignore_index)


def _acc_dtype(x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    """The working type of a head product: f32, or f64 for f64 inputs."""
    return torch.promote_types(torch.promote_types(x.dtype, w.dtype),
                               torch.float32)


def _vocab_chunk(m, s, tgt, xf, w_c, b_c, lab, c0):
    """One vocab chunk of the online logsumexp: logits [N, chunk] of the
    head rows ``w_c`` (plus ``b_c``), the running max/sum rescaled, the
    target logit picked where the column is the label."""
    logits = torch.matmul(xf.to(m.dtype), w_c.to(m.dtype).t())
    if b_c is not None:
        logits = logits + b_c.to(m.dtype)[None, :]
    m_new = torch.maximum(m, logits.amax(dim=1))
    # m is -inf until the first live chunk; guard the rescale
    alpha = torch.exp(torch.where(torch.isneginf(m),
                                  torch.full_like(m, float("-inf")),
                                  m - m_new))
    s = s * alpha + torch.exp(logits - m_new[:, None]).sum(dim=1)
    gid = c0 + torch.arange(logits.shape[1], device=logits.device)
    hit = gid[None, :] == lab[:, None]
    tgt = tgt + torch.where(hit, logits, torch.zeros_like(logits)).sum(dim=1)
    return m_new, s, tgt


def chunked_lm_cross_entropy(x: torch.Tensor, w_head: torch.Tensor,
                             labels: torch.Tensor, *, chunk: int = 8192,
                             bias: Optional[torch.Tensor] = None,
                             ignore_index: Optional[int] = None,
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE fused with the LM head, chunking the VOCAB: each step
    is an [N, D] × [D, chunk] product feeding an online logsumexp and the
    target pick, recomputed in the backward
    (``torch.utils.checkpoint``), so live logits are O(N·chunk).

    ``x`` [..., D] (post-final-LN activations), ``w_head`` [V, D] (the
    ``lm_head.weight`` layout: the JAX function's [D, V] kernel
    transposed), ``bias`` optional [V], ``labels`` [...] int. Returns
    (mean_loss, valid_count) with :func:`softmax_cross_entropy`'s
    ignore/mean semantics. The last chunk is cut at V rather than padded,
    so there are no dead columns: a label at or past V matches no column
    and picks 0, the reference's live-column restriction."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    lab = labels.reshape(-1).long()
    n, v = xf.shape[0], w_head.shape[0]
    acc = _acc_dtype(x, w_head)
    m = torch.full((n,), float("-inf"), dtype=acc, device=x.device)
    s = torch.zeros((n,), dtype=acc, device=x.device)
    tgt = torch.zeros((n,), dtype=acc, device=x.device)
    for c0 in range(0, v, chunk):
        b_c = None if bias is None else bias[c0:c0 + chunk]
        m, s, tgt = checkpoint(_vocab_chunk, m, s, tgt, xf,
                               w_head[c0:c0 + chunk], b_c, lab, c0,
                               use_reentrant=False)
    ce = (m + torch.log(s)) - tgt
    return _masked_mean(ce.reshape(lead), labels, ignore_index)


def _token_chunk(xc, w_head, bias, lc, ignore_index):
    """One token chunk: full-vocab logits [chunk, V] and a plain CE →
    (sum of the valid rows' CE, valid count)."""
    acc = _acc_dtype(xc, w_head)
    logits = torch.matmul(xc.to(acc), w_head.to(acc).t())
    if bias is not None:
        logits = logits + bias.to(acc)[None, :]
    lse = torch.logsumexp(logits, dim=-1)
    valid = (torch.ones_like(lc, dtype=torch.bool) if ignore_index is None
             else lc != ignore_index)
    safe = torch.where(valid, lc, torch.zeros_like(lc))
    # iota-compare pick: an out-of-range label matches no column, picks 0
    col = torch.arange(logits.shape[1], device=logits.device)
    picked = torch.where(col[None, :] == safe[:, None], logits,
                         torch.zeros_like(logits)).sum(dim=-1)
    ce = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return ce.sum(), valid.sum().to(acc)


def token_chunked_lm_cross_entropy(x: torch.Tensor, w_head: torch.Tensor,
                                   labels: torch.Tensor, *,
                                   chunk: int = 4096,
                                   bias: Optional[torch.Tensor] = None,
                                   ignore_index: Optional[int] = None,
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused head + CE chunking TOKENS: each step is ONE full-vocab
    product ([chunk, D] × [D, V]) followed by a plain CE, recomputed in
    the backward, so live logits and their cotangent are O(chunk·V).

    Arguments and result as :func:`chunked_lm_cross_entropy` (``w_head``
    [V, D]). The last chunk is cut at N rather than padded."""
    xf = x.reshape(-1, x.shape[-1])
    lab = labels.reshape(-1).long()
    acc = _acc_dtype(x, w_head)
    tot = torch.zeros((), dtype=acc, device=x.device)
    cnt = torch.zeros((), dtype=acc, device=x.device)
    for r0 in range(0, xf.shape[0], chunk):
        ce, n = checkpoint(_token_chunk, xf[r0:r0 + chunk], w_head, bias,
                           lab[r0:r0 + chunk], ignore_index,
                           use_reentrant=False)
        tot, cnt = tot + ce, cnt + n
    # the clamped-count contract of _masked_mean (all ignored -> 0.0)
    cnt = cnt.clamp_min(1.0)
    return tot / cnt, cnt
