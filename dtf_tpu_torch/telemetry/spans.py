"""Named wall-time samples with p50/p99 rollups (``SpanRecorder`` of
``dtf_tpu.telemetry.spans``).

The serving router records its control-plane tick profile here
(``cp_pick``, ``cp_engine_tick``, ``cp_health_sweep``, ``cp_page_ops``,
``cp_bookkeeping``). Host clock arithmetic only: a span never touches a
device tensor, so recording adds no device-to-host sync.
"""

from __future__ import annotations

import collections
import time
from contextlib import contextmanager
from typing import Iterator, Mapping

from dtf_tpu_torch.metrics import quantile

#: samples kept per phase for the quantiles (totals and counts are exact)
DEFAULT_KEEP = 4096


class SpanRecorder:
    """``add(name, seconds)`` records a sample (:meth:`span` times a
    block); totals and counts are exact over the run, the quantiles are
    over the last ``keep`` samples of a phase. ``clock`` is injectable."""

    def __init__(self, keep: int = DEFAULT_KEEP, *,
                 clock=time.perf_counter):
        self._keep = keep
        self._clock = clock
        self._samples: dict[str, collections.deque] = {}
        self._totals: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def add(self, name: str, seconds: float) -> None:
        dq = self._samples.get(name)
        if dq is None:
            dq = self._samples[name] = collections.deque(maxlen=self._keep)
            self._totals[name] = 0.0
            self._counts[name] = 0
        dq.append(seconds)
        self._totals[name] += seconds
        self._counts[name] += 1

    @contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(name, self._clock() - t0)

    def total(self, name: str) -> float:
        return self._totals.get(name, 0.0)

    def count(self, name: str) -> int:
        return self._counts.get(name, 0)

    def rollup(self) -> Mapping[str, Mapping[str, float]]:
        """``{phase: {count, total_s, mean_s, p50_s, p99_s}}``."""
        out = {}
        for name, dq in self._samples.items():
            xs = list(dq)
            n = self._counts[name]
            out[name] = {
                "count": n,
                "total_s": round(self._totals[name], 6),
                "mean_s": round(self._totals[name] / max(n, 1), 6),
                "p50_s": round(quantile(xs, 0.5), 6),
                "p99_s": round(quantile(xs, 0.99), 6),
            }
        return out


__all__ = ["DEFAULT_KEEP", "SpanRecorder"]
