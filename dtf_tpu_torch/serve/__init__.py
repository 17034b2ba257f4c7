"""Online inference: continuous-batching decode over the GPT (the port of
``dtf_tpu.serve``).

- :mod:`dtf_tpu_torch.serve.engine` — ``DecodeEngine``: the KV cache and
  each slot's position, sampler state and sampling parameters as device
  state, with exactly two fixed-shape step functions
  (``prefill_into_slot``, ``decode_all``).
- :mod:`dtf_tpu_torch.serve.scheduler` — request queue, FIFO admission
  with prefill/decode interleave, slot allocation, EOS / max-len eviction,
  deadlines, load shedding, and TTFT / per-token latency / queue depth /
  occupancy / SLO metrics.
- :mod:`dtf_tpu_torch.serve.client` — the in-process submit/poll API, the
  open-loop replay pump, a seeded Poisson load generator and a heartbeat.

``python -m dtf_tpu_torch.serve_gpt`` is the launcher. Not yet ported: the
prefix page pool, speculative decoding, beam search, the router with its
health, hot-swap and log-sink tier, and sharded serving.
"""

from dtf_tpu_torch.serve.client import (Heartbeat, PoissonLoadGen,
                                        ServeClient, replay)
from dtf_tpu_torch.serve.engine import DecodeEngine
from dtf_tpu_torch.serve.scheduler import (FAILED_STATUSES, Request,
                                           RequestFailed, Scheduler)

__all__ = ["DecodeEngine", "FAILED_STATUSES", "Heartbeat", "PoissonLoadGen",
           "Request", "RequestFailed", "Scheduler", "ServeClient", "replay"]
