"""Per-request trace events (the port of ``dtf_tpu.telemetry.trace``).

A :class:`TraceCollector` keeps chrome-trace events on the host: the
router and scheduler record one lifecycle slice a request (submit →
terminal), its queue wait, and every engine-call slice (prefill chunk,
page load and save, decode) tagged with the trace ids it served.
:func:`dtf_tpu_torch.telemetry.profile.export_chrome_trace` writes them
as one Perfetto-loadable JSON file.

Host clock arithmetic and bounded memory (a ring): recording never
touches a device tensor, so it adds no device-to-host sync.
"""

from __future__ import annotations

import collections
import time
from contextlib import contextmanager
from typing import Iterator, Mapping, Optional

#: default event retention
DEFAULT_KEEP = 65536


class TraceCollector:
    """Bounded chrome-trace event ring with a fixed time zero.

    Timestamps are microseconds since construction (the chrome ``ts``
    convention); ``clock`` is injectable. ``dropped`` counts events the
    ring pushed out."""

    def __init__(self, keep: int = DEFAULT_KEEP, *,
                 clock=time.perf_counter):
        self.clock = clock
        self._t0 = clock()
        self._events: collections.deque = collections.deque(maxlen=keep)
        self.dropped = 0

    def now_us(self) -> float:
        return (self.clock() - self._t0) * 1e6

    def _push(self, ev: dict) -> None:
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        self._events.append(ev)

    def complete(self, name: str, *, cat: str, tid, t0_us: float,
                 t1_us: float, pid: str = "serve",
                 args: Optional[Mapping] = None) -> None:
        ev = {"name": name, "ph": "X", "cat": cat, "pid": pid, "tid": tid,
              "ts": round(t0_us, 3), "dur": round(max(t1_us - t0_us, 0.0),
                                                  3)}
        if args:
            ev["args"] = dict(args)
        self._push(ev)

    def instant(self, name: str, *, cat: str, tid, pid: str = "serve",
                args: Optional[Mapping] = None) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "cat": cat, "pid": pid,
              "tid": tid, "ts": round(self.now_us(), 3)}
        if args:
            ev["args"] = dict(args)
        self._push(ev)

    @contextmanager
    def span(self, name: str, *, cat: str, tid, pid: str = "serve",
             args: Optional[Mapping] = None) -> Iterator[None]:
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, cat=cat, tid=tid, pid=pid,
                          t0_us=t0, t1_us=self.now_us(), args=args)

    @property
    def events(self) -> list[dict]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)


__all__ = ["DEFAULT_KEEP", "TraceCollector"]
