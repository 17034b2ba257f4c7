"""The flight recorder's postmortem and heartbeat (the port of
``dtf_tpu.telemetry.flight``, as far as serving needs it).

A :class:`FlightRecorder` dumps one postmortem JSON line on demand (a
SIGTERM through :class:`dtf_tpu_torch.telemetry.run.Telemetry`, or a
caller's ``dump``) into ``postmortem.json``, with the context of every
registered provider — the serving tier's in-flight request ids and slot
ages — and writes the liveness heartbeat file that
:class:`dtf_tpu_torch.serve.client.Heartbeat` stamps with its serve
panel. The dump path touches no device API: it runs when the device may
be wedged. The training half (step records, the stall watchdog) is not
ported yet.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Mapping, Optional

from dtf_tpu_torch._hostio import append_line, atomic_replace


def _rss_mb() -> Optional[float]:
    try:
        import resource

        # linux ru_maxrss is KB
        return round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1)
    except (ImportError, OSError):
        return None


class FlightRecorder:
    """Postmortem dumps and the heartbeat file. ``path``: the postmortem
    file, one JSON line a dump (a later dump never hides an earlier one);
    ``heartbeat_path``: the liveness file (None: none). ``wall`` is
    injectable."""

    def __init__(self, path: Optional[str] = None, *, keep: int = 64,
                 heartbeat_path: Optional[str] = None, wall=time.time):
        self.path = path
        self.heartbeat_path = heartbeat_path
        self.wall = wall
        #: the step records a training loop would keep (none in serving;
        #: the dump carries the list as the JAX package's does)
        self.records: collections.deque = collections.deque(maxlen=keep)
        self.last_scalars: dict = {}
        self.dumps = 0
        self._providers: dict = {}
        # reentrant: a SIGTERM handler may dump while the same thread
        # holds the lock
        self._lock = threading.RLock()

    def add_provider(self, name: str, fn) -> None:
        """Register ``fn() -> dict`` of host facts, merged into every dump
        under ``context[name]``; a provider that raises is reported as its
        error and never masks the dump. ``fn=None`` removes it."""
        with self._lock:
            if fn is None:
                self._providers.pop(name, None)
            else:
                self._providers[name] = fn

    def write_heartbeat(self, *, stalled: bool = False,
                        extra: Optional[Mapping] = None) -> None:
        """One atomic liveness record; ``extra`` merges the caller's facts
        (the serve panel). Never raises."""
        path = self.heartbeat_path
        if not path:
            return
        with self._lock:
            step = self.records[-1]["step"] if self.records else None
        rec = {"t": round(self.wall(), 3), "pid": os.getpid(),
               "step": step, "stalled": bool(stalled)}
        if extra:
            rec.update(extra)
        try:
            atomic_replace(path, json.dumps(rec))
        except OSError:
            pass

    def dump(self, reason: str, extra: Optional[Mapping] = None) -> dict:
        """Append one postmortem JSON line and return the record. Never
        raises: it runs inside handlers where a second failure would hide
        the first."""
        with self._lock:
            post = {
                "telemetry": "postmortem",
                "reason": reason,
                "t": round(self.wall(), 3),
                "pid": os.getpid(),
                "n_records": len(self.records),
                "records": list(self.records),
                "last_scalars": dict(self.last_scalars),
            }
            rss = _rss_mb()
            if rss is not None:
                post["rss_mb"] = rss
            if self._providers:
                ctx = {}
                for name, fn in self._providers.items():
                    try:
                        ctx[name] = fn()
                    except Exception as e:  # noqa: BLE001 — a provider's
                        # failure must not mask the postmortem
                        ctx[name] = {"provider_error": repr(e)[:200]}
                post["context"] = ctx
            if extra:
                post.update(extra)
            self.dumps += 1
        if self.path:
            try:
                append_line(self.path, json.dumps(post))
            except OSError:
                pass
        return post


__all__ = ["FlightRecorder"]
