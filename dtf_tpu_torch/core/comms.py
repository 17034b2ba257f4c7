"""Projections (counterpart of ``dtf_tpu.core.comms``: ``tp_dense`` / ``TpDense``).

Only the unsharded, full-precision case is ported: ``mesh=None`` and
``precision=""``. Tensor parallelism, the collective-matmul rings and the
int8/fp8 tiers come with later slices. The product is a plain
``torch.matmul`` — XLA computed it outside any Pallas kernel too.
"""

from __future__ import annotations

import torch
from torch import nn


def tp_dense(x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None, mesh=None, *, parallel: str,
             dtype: torch.dtype | None = None,
             precision: str = "") -> torch.Tensor:
    """``x @ weight.T + bias`` with x, the weight and the bias cast to
    ``dtype`` first (as flax's ``Dense(dtype=...)`` does). ``weight`` is
    [out, in], torch's ``Linear`` layout (flax kernels are [in, out])."""
    if parallel not in ("column", "row"):
        raise ValueError(f"parallel={parallel!r} must be 'column' or 'row'")
    if mesh is not None:
        raise NotImplementedError(
            "tp_dense over a mesh (tensor parallelism) is not ported yet")
    if precision not in ("", "bf16"):
        raise NotImplementedError(
            f"tp_dense precision={precision!r} (quantized tiers) is not "
            "ported yet")
    if dtype is not None:
        x = x.to(dtype)
        weight = weight.to(dtype)
        bias = bias.to(dtype) if bias is not None else None
    y = torch.matmul(x, weight.t())
    return y if bias is None else y + bias


class TpDense(nn.Module):
    """A linear layer whose parameters stay f32 and whose product runs at
    ``dtype``: ``weight`` [features, in], ``bias`` [features]."""

    def __init__(self, in_features: int, features: int, *, parallel: str,
                 dtype: torch.dtype | None = None, use_bias: bool = True,
                 device=None):
        super().__init__()
        self.parallel = parallel
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(
            features, in_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(
            features, dtype=torch.float32, device=device))
            if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp_dense(x, self.weight, self.bias, parallel=self.parallel,
                        dtype=self.dtype)
