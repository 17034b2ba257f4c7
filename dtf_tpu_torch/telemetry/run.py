"""The run's telemetry object (the port of ``dtf_tpu.telemetry.run``, as
far as serving needs it).

:class:`Telemetry` holds the phase spans (:class:`~dtf_tpu_torch.
telemetry.spans.SpanRecorder`: the scheduler's engine-call spans, the
router's ``serve_swap``), an optional request tracer
(:class:`~dtf_tpu_torch.telemetry.trace.TraceCollector`) and the flight
recorder (:class:`~dtf_tpu_torch.telemetry.flight.FlightRecorder`: the
serving tier's postmortem providers, a SIGTERM dump between
:meth:`Telemetry.start` and :meth:`Telemetry.stop`). :meth:`report`
gives one run-report dict and :func:`merge_artifact` folds it into a
``TELEMETRY.json``. Not yet ported, and raising: the stall watchdog
(``watchdog=True``), the goodput buckets (``account``) and the compile
fence (``count_traces``) — the training launchers' ``--telemetry``.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Mapping, Optional

from dtf_tpu_torch._hostio import atomic_replace
from dtf_tpu_torch.telemetry.flight import FlightRecorder
from dtf_tpu_torch.telemetry.spans import SpanRecorder


class Telemetry:
    """Per-run telemetry (module docstring). ``out_dir`` is where the
    flight recorder writes ``postmortem.json`` and ``heartbeat.json``
    (None: in memory only)."""

    def __init__(self, out_dir: Optional[str] = None, *,
                 keep_steps: int = 64, watchdog: bool = True,
                 clock=time.monotonic, wall=time.time):
        if watchdog:
            raise NotImplementedError(
                "the stall watchdog (Telemetry(watchdog=True), the training "
                "launchers' --telemetry) is not yet ported; pass "
                "watchdog=False")
        self.out_dir = out_dir
        self.spans = SpanRecorder()
        self.flight = FlightRecorder(
            os.path.join(out_dir, "postmortem.json") if out_dir else None,
            keep=keep_steps,
            heartbeat_path=(os.path.join(out_dir, "heartbeat.json")
                            if out_dir else None),
            wall=wall)
        self.clock = clock
        #: per-request trace events (serving): None unless a caller
        #: attaches a TraceCollector
        self.tracer = None
        self._t_start: Optional[float] = None
        self._t_stop: Optional[float] = None
        self._prev_sigterm = None
        self._active = False

    # -------------------------------------------------- not ported (raise)

    def account(self, bucket: str, seconds: float) -> None:
        raise NotImplementedError("the goodput buckets are not yet ported")

    def count_traces(self, name: str, fn):
        raise NotImplementedError("the compile fence is not yet ported")

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Open the run window and chain a SIGTERM postmortem dump before
        any handler already installed."""
        if self._active:
            return
        self._active = True
        if self._t_start is None:
            self._t_start = self.clock()
        self._t_stop = None
        if threading.current_thread() is threading.main_thread():
            try:
                self._prev_sigterm = signal.signal(
                    signal.SIGTERM, self._on_sigterm)
            except (ValueError, OSError):
                self._prev_sigterm = None

    def _on_sigterm(self, signum, frame):
        self.flight.dump("sigterm")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
            return
        # SIG_DFL / SIG_IGN before: restore it and deliver again, so the
        # hook never makes the process immune to SIGTERM
        try:
            signal.signal(signum,
                          prev if prev is not None else signal.SIG_DFL)
            self._prev_sigterm = None
            os.kill(os.getpid(), signum)
        except (ValueError, OSError):
            pass

    def stop(self) -> None:
        if not self._active:
            return
        self._active = False
        self._t_stop = self.clock()
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
            self._prev_sigterm = None

    # ------------------------------------------------------------ postmortem

    def dump_postmortem(self, reason: str,
                        extra: Optional[Mapping] = None) -> dict:
        return self.flight.dump(reason, extra)

    def add_postmortem_provider(self, name: str, fn) -> None:
        """Register a flight-recorder context provider (host facts only:
        see :meth:`FlightRecorder.add_provider`)."""
        self.flight.add_provider(name, fn)

    # -------------------------------------------------------------- report

    def wall_s(self) -> float:
        if self._t_start is None:
            return 0.0
        end = self._t_stop if self._t_stop is not None else self.clock()
        return end - self._t_start

    def report(self, extra: Optional[Mapping] = None) -> dict:
        """The run-report dict (one JSON line); safe to call more than
        once. The JAX package's compile and goodput keys are absent: the
        port has no XLA compile to count."""
        out = {
            "telemetry": "run_report",
            "wall_s": round(self.wall_s(), 3),
            "phases": self.spans.rollup(),
            "flight": {"records": len(self.flight.records),
                       "dumps": self.flight.dumps},
        }
        if self.tracer is not None:
            out["trace_events"] = len(self.tracer)
            out["trace_dropped"] = self.tracer.dropped
        if extra:
            out.update(extra)
        return out


def merge_artifact(path: str, report: Mapping, *, keep_runs: int = 20,
                   meta: Optional[Mapping] = None) -> dict:
    """Fold one run report into a ``TELEMETRY.json`` artifact:
    ``{"runs": [...]}``, newest last, at most ``keep_runs``. A malformed
    existing file is replaced, never crashed on."""
    data: dict = {"runs": []}
    try:
        with open(path) as f:
            prev = json.load(f)
        if isinstance(prev, dict) and isinstance(prev.get("runs"), list):
            data = prev
    except (OSError, ValueError):
        pass
    entry = dict(report)
    if meta:
        entry.update(meta)
    data["runs"] = (data["runs"] + [entry])[-keep_runs:]
    atomic_replace(path, json.dumps(data, indent=1))
    return data


__all__ = ["Telemetry", "merge_artifact"]
