"""Chrome-trace export (the port of ``dtf_tpu.telemetry.profile``): so far
only :func:`export_chrome_trace` of the host's request events. Device
slices from a profiler window (``ProfilerHook``) are not ported yet."""

from __future__ import annotations

import json
from typing import Mapping, Optional, Sequence

from dtf_tpu_torch._hostio import atomic_replace


def export_chrome_trace(path: str, *, trace=None,
                        request_events: Optional[Sequence[Mapping]] = None,
                        meta: Optional[Mapping] = None) -> dict:
    """Write one Perfetto-loadable chrome-trace JSON of the request
    lifecycles (a :class:`~dtf_tpu_torch.telemetry.trace.TraceCollector`'s
    ``events``), in the JAX package's document shape: ``traceEvents``,
    ``displayTimeUnit`` and, with ``meta``, ``metadata``. Returns the
    document. ``trace`` (device slices) raises: not yet ported."""
    if trace is not None:
        raise NotImplementedError(
            "device slices in a chrome trace (ProfilerHook) are not yet "
            "ported; pass request_events only")
    doc: dict = {"traceEvents": [], "displayTimeUnit": "ms"}
    if meta:
        doc["metadata"] = dict(meta)
    if request_events:
        doc["traceEvents"] += [dict(e) for e in request_events]
    atomic_replace(path, json.dumps(doc))
    return doc


__all__ = ["export_chrome_trace"]
