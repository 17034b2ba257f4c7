"""Metrics (counterpart of ``dtf_tpu.metrics`` and of the analytic MFU
count in ``dtf_tpu.telemetry.accounting``): :func:`quantile`, the one
nearest-rank convention of every reported percentile.

:class:`MetricWriter` prints scalars to stdout and keeps them in
``history``; TensorBoard summaries wait for a later slice.
"""

from __future__ import annotations

import sys
from typing import Mapping

#: NVIDIA H100 SXM dense bf16 tensor-core peak (data sheet), the MFU
#: denominator of the port (never the TPU's)
H100_PEAK_BF16_FLOPS = 989e12


def quantile(xs, q):
    """Nearest-rank quantile of a small sample (None when empty) — the
    serve scheduler's TTFT and per-token p50/p99 convention, the JAX
    package's ``dtf_tpu.metrics.quantile``."""
    if not xs:
        return None
    xs = sorted(xs)
    i = min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))
    return xs[i]


def param_count(params) -> int:
    """Total parameter count of a ``{name: tensor}`` dict."""
    return int(sum(p.numel() for p in params.values()))


def analytic_lm_flops_per_step(*, n_params: int, layers: int, width: int,
                               seq_len: int, tokens_per_step: int) -> float:
    """Full-step (fwd+bwd) FLOPs of a dense transformer LM step:
    ``(6·N + 12·L·d·s) · tokens`` — the JAX package's analytic model."""
    return float(6 * n_params + 12 * layers * width * seq_len) \
        * tokens_per_step


class MetricWriter:
    """Scalar writer: one stdout line per call, and ``history`` (a list of
    ``(step, {name: float})``) for callers that read the run back.
    ``echo=False`` (a rank that is not the chief) keeps the history and
    prints nothing."""

    def __init__(self, echo: bool = True):
        self.echo = echo
        self.history: list[tuple[int, dict]] = []

    def write_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
        scalars = {k: float(v) for k, v in scalars.items()}
        self.history.append((int(step), scalars))
        if self.echo:
            body = ", ".join(f"{k}={v:.6g}"
                             for k, v in sorted(scalars.items()))
            print(f"[{int(step)}] {body}", flush=True)

    def flush(self) -> None:
        sys.stdout.flush()

    def close(self) -> None:
        self.flush()
