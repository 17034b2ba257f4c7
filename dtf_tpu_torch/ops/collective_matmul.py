"""The collective matmuls of Megatron TP under ``--tp_overlap``
(counterpart of ``dtf_tpu.ops.collective_matmul``, its bf16 rings).

Each (collective, matmul) pair of a TP block is a ring over the model
group, built on :class:`dtf_tpu_torch.core.comms.RingExchange` (the
reference's ``ring_perm``: rank i sends to i + 1): every step posts the
next chunk's exchange BEFORE this chunk's product, so the transfer runs
under the matmul.

- :func:`ag_matmul` — all-gather ∘ matmul, the COLUMN-parallel
  projection (q/k/v, mlp_in): token chunks ride the ring, each is
  multiplied by the rank's weight rows on arrival;
- :func:`matmul_rs` — matmul ∘ reduce-scatter, the ROW-parallel
  projection (attn_out, mlp_out): the partial-sum accumulator rides the
  ring while each step's chunk product computes.

Each is a ``torch.autograd.Function`` whose backward is the mirrored
pattern (d(ag_matmul) is a matmul_rs for dx and a gather-on-contract
ring for dW; d(matmul_rs) an ag_matmul for dy and the same dW ring), so
no blocking collective appears under autograd either.

Layout (Megatron-SP): between projections the activations are
token-sharded over the model group. Per rank, with ``n`` the group's
size, ``t`` the rank's token rows, ``d`` the model width and ``f`` the
rank's feature slice, and weights in the port's [out, in] layout:

    ag_matmul : x [..., t, d]   w [f, d]  → y [..., n·t, f]
    matmul_rs : y [..., n·t, f] w [d, f]  → z [..., t, d]

The ring bodies take [in, out] operands, as the reference's do. Products
and the accumulators riding the ring are in the operands' dtype, as the
reference's. The quantized rings (``matmul_precision``) are not ported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dtf_tpu_torch.core import comms


def _rows(full: torch.Tensor, src: int, t: int) -> torch.Tensor:
    """Row block ``[src·t, src·t + t)`` of the token axis (-2)."""
    return full[..., src * t:(src + 1) * t, :]


def _ag_matmul_impl(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """all_gather(x, tokens) @ w as an n-step ring; ``w`` [d, f]."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    t = x.shape[-2]
    y = x.new_empty(x.shape[:-2] + (n * t, w.shape[1]))
    pending = comms.RingExchange(x, group) if n > 1 else None
    _rows(y, idx, t).copy_(torch.matmul(x, w))
    for k in range(1, n):
        xb = pending.wait()
        if k < n - 1:              # the last chunk is sent nowhere
            pending = comms.RingExchange(xb, group)
        _rows(y, (idx - k) % n, t).copy_(torch.matmul(xb, w))
    return y


def _matmul_rs_impl(y: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """reduce_scatter(y @ w, tokens) as an n-step ring; ``w`` [f, d].
    Step k on rank j adds the product of row chunk (j - k - 1) mod n, so
    the last step lands each whole sum on its owner."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if y.shape[-2] % n:
        raise ValueError(f"matmul_rs: token rows {y.shape[-2]} not "
                         f"divisible by the model axis ({n})")
    t = y.shape[-2] // n
    acc = torch.matmul(_rows(y, (idx - 1) % n, t), w)
    for k in range(1, n):
        pending = comms.RingExchange(acc, group)
        part = torch.matmul(_rows(y, (idx - k - 1) % n, t), w)
        acc = pending.wait() + part
    return acc


def _contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ over the leading and token dims: a [..., t, c], b [..., t, f] →
    [c, f]."""
    return torch.matmul(a.reshape(-1, a.shape[-1]).t(),
                        b.reshape(-1, b.shape[-1]))


def _ring_dw(chunk: torch.Tensor, full: torch.Tensor, group) -> torch.Tensor:
    """The dW ring: Σ_s chunk_sᵀ @ full[rows s], the rank's row block
    ``chunk`` [..., t, c] riding the ring over ``full`` [..., n·t, f]
    (every row here). Returns [c, f]."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    t = chunk.shape[-2]
    pending = comms.RingExchange(chunk, group) if n > 1 else None
    acc = _contract(chunk, _rows(full, idx, t))
    for k in range(1, n):
        cb = pending.wait()
        if k < n - 1:
            pending = comms.RingExchange(cb, group)
        acc = acc + _contract(cb, _rows(full, (idx - k) % n, t))
    return acc


class _AgMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return _ag_matmul_impl(x, w.t(), group)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        # dx: dy @ w summed over the ranks, this rank's tokens (matmul_rs);
        # dW: Σ over the token blocks as x rides the ring
        dx = _matmul_rs_impl(dy, w, ctx.group)
        dw = _ring_dw(x, dy, ctx.group).t()
        return dx, dw, None


class _MatmulRs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, w, group):
        ctx.save_for_backward(y, w)
        ctx.group = group
        return _matmul_rs_impl(y, w.t(), group)

    @staticmethod
    def backward(ctx, dz):
        y, w = ctx.saved_tensors
        # dy: the gathered dz @ w (ag_matmul); dW: Σ as dz rides the ring
        dy = _ag_matmul_impl(dz, w, ctx.group)
        dw = _ring_dw(dz, y, ctx.group)
        return dy, dw, None


def ag_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Column-parallel collective matmul: ``x`` [..., t, d] this rank's
    token rows, ``w`` [f, d] this rank's rows of the [out, in] weight.
    Returns ``all_gather(x) @ wᵀ`` [..., n·t, f]."""
    return _AgMatmul.apply(x, w, group)


def matmul_rs(y: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Row-parallel collective matmul: ``y`` [..., n·t, f] every token
    with this rank's features, ``w`` [d, f] this rank's input columns of
    the [out, in] weight. Returns this rank's token rows of the sum over
    the ranks of ``y @ wᵀ``, [..., t, d]."""
    return _MatmulRs.apply(y, w, group)
