"""Online inference: continuous-batching decode over the GPT (the port of
``dtf_tpu.serve``).

- :mod:`dtf_tpu_torch.serve.engine` — ``DecodeEngine``: the KV cache and
  each slot's position, sampler state and sampling parameters as device
  state, with two fixed-shape step functions (``prefill_into_slot``,
  ``decode_all``), four with a speculative draft (the draft's prefill
  and step; the decode step becomes the verify step) and two more with
  the prefix page pool (page load and save).
- :mod:`dtf_tpu_torch.serve.pages` — ``PrefixIndex`` (the host index of
  the page pool: whole-prefix hashes, pins, LRU eviction, save on the
  second sighting) and ``PageStore`` (a pool and its index, mountable by
  several engines).
- :mod:`dtf_tpu_torch.serve.scheduler` — request queue, FIFO admission
  with prefill/decode interleave, slot allocation, EOS / max-len eviction,
  deadlines, load shedding, and TTFT / per-token latency / queue depth /
  occupancy / SLO metrics.
- :mod:`dtf_tpu_torch.serve.router` — ``Router``: N engine replicas
  over one set of weights behind least-occupancy admission, with
  quarantine and requeue, prefill/decode disaggregation over a shared
  page store, and the rolling weight swap (canary, rollback) from a
  publish dir (:mod:`dtf_tpu_torch.publish`).
- :mod:`dtf_tpu_torch.serve.health` — the replicas' health state machine
  (healthy, degraded, quarantined, probation) and the serve verbs of
  ``DTF_FAULT_INJECT``.
- :mod:`dtf_tpu_torch.serve.client` — the in-process submit/poll API, the
  open-loop replay pump, a seeded Poisson load generator and a heartbeat.
- :mod:`dtf_tpu_torch.serve.logsink` — ``LogSink``: every done request
  recorded into CRC-framed rotated shards (import it directly: it needs
  no engine).

- :mod:`dtf_tpu_torch.serve.plane` — ``CallPlane``: a sharded fleet's
  leader (rank 0 broadcasts each device call, addressed to a replica or
  the fleet) and its followers; ``ShardSets``, the shard sets of a roll.

``python -m dtf_tpu_torch.serve_gpt`` is the launcher. Not yet ported:
the draft-only swap.
"""

from dtf_tpu_torch.serve.client import (Heartbeat, PoissonLoadGen,
                                        ServeClient, replay)
from dtf_tpu_torch.serve.engine import DecodeEngine
from dtf_tpu_torch.serve.health import (HealthConfig, HealthTracker,
                                        install_serve_fault)
from dtf_tpu_torch.serve.pages import PageStore, PrefixHandle, PrefixIndex
from dtf_tpu_torch.serve.router import Router, SwapConfig, poisson_replay
from dtf_tpu_torch.serve.scheduler import (FAILED_STATUSES, Request,
                                           RequestFailed, Scheduler)

__all__ = ["DecodeEngine", "FAILED_STATUSES", "Heartbeat", "HealthConfig",
           "HealthTracker", "PageStore", "PoissonLoadGen", "PrefixHandle",
           "PrefixIndex", "Request", "RequestFailed", "Router", "Scheduler",
           "ServeClient", "SwapConfig", "install_serve_fault",
           "poisson_replay", "replay"]
