"""The serving fleet: a router over engine replicas (the port of
``dtf_tpu.serve.router``).

A :class:`Router` owns N ``(DecodeEngine, Scheduler)`` replicas that
share ONE set of weight tensors (:meth:`Router.build` loads the model
once; each further replica takes its parameters, so N replicas cost N KV
caches, not N weight copies) and keep independent KV state. It admits a
request to the replica of least slot occupancy among the routable ones —
health rank first, then occupancy, then queue depth, then replica index,
so admission is deterministic. The router has the scheduler's
``submit`` / ``tick`` / ``pending`` surface, so
:func:`dtf_tpu_torch.serve.client.replay` drives a fleet as it drives one
scheduler. Replicas tick in turn in the one pump thread: on one card
they share its host and device, so a fleet's tokens/s there is not a
scaling figure.

**Health** (on by default with more than one replica;
:mod:`dtf_tpu_torch.serve.health`): every replica tick is wall-timed on
the router's clock and fed to the watchdog. A wedged or repeatedly slow
replica — or one whose decode raises — is QUARANTINED: it is skipped and
no longer ticked, and its in-flight requests are requeued onto survivors
in submit order with their fleet id and original submit time. A requeue
replays the request whole: the survivor prefills again and regenerates
the stream, which equals the fault-free stream because a slot's result
does not depend on the other slots (at one ``n_slots``). After its
probation delay the replica is readmitted on trial, an idle one
exercised by ``DecodeEngine.probe``. With no routable replica the router
sheds at the front door with ``retry_after_s`` = the earliest probation
ETA.

**Disaggregation** (``prefill_replicas`` = P): the first P replicas only
prefill. A request whose prompt has at least one full page not yet in
the page store goes to a prefill replica as a ONE-token job; its pages
land in the store every replica mounts (the KV transport), and when the
job ends the request is handed to a decode replica with its original
submit time, where admission gathers the pages instead of recomputing
them. ``poll`` reads ``"prefill"`` meanwhile.

**Stats**: fleet aggregates, the ``replica{i}_*`` panel (completions,
occupancy, TTFT, queue peak, sheds, timeouts, requeues; health state and
role), the fleet-summed engine counters and the control-plane tick
profile (``cp_pick``, ``cp_engine_tick``, ``cp_health_sweep``,
``cp_page_ops``, ``cp_bookkeeping`` on
:class:`~dtf_tpu_torch.telemetry.spans.SpanRecorder`; host arithmetic
only). Not yet ported, and raising: the rolling weight swap
(``start_swap`` and the rest of the hot-swap, :class:`SwapConfig`), the
serve-log sink, the event log and telemetry.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

from dtf_tpu_torch.metrics import quantile as _quantile
from dtf_tpu_torch.serve import health as health_lib
from dtf_tpu_torch.serve.engine import DecodeEngine
from dtf_tpu_torch.serve.scheduler import (FAILED_STATUSES, Request,
                                           RequestFailed, Scheduler)
from dtf_tpu_torch.telemetry.spans import SpanRecorder

#: per-replica stat keys surfaced as ``replica{i}_<key>``
_REPLICA_KEYS = ("serve_completed", "serve_occupancy_mean",
                 "serve_ttft_p50_s", "serve_ttft_p99_s",
                 "serve_queue_peak", "serve_ttft_slo_ok_frac",
                 "serve_shed", "serve_timeouts", "serve_requeued_in")

#: the control-plane tick profile's phases
CP_PHASES = ("cp_pick", "cp_engine_tick", "cp_health_sweep", "cp_page_ops",
             "cp_bookkeeping")

_HOT_SWAP = "the rolling weight swap (hot-swap) is not yet ported"


class SwapConfig:
    """The rolling swap's knobs: not yet ported (hot-swap)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_HOT_SWAP)


class Router:
    """Least-occupancy admission over N engine replicas (module
    docstring). Build from engines (sharing weights by construction) or
    with :meth:`build`; ``ttft_slo_s``, ``clock`` and the scheduler
    keywords apply to every replica's scheduler. ``health``: None (on
    with more than one replica), True, False, a
    :class:`~dtf_tpu_torch.serve.health.HealthConfig` or a
    :class:`~dtf_tpu_torch.serve.health.HealthTracker`."""

    def __init__(self, engines: Sequence[DecodeEngine], writer=None, *,
                 telemetry=None, ttft_slo_s: float = 0.0,
                 clock=time.monotonic, health=None,
                 prefill_replicas: int = 0, log_sink=None, events=None,
                 **scheduler_kw):
        if not engines:
            raise ValueError("Router needs at least one engine replica")
        for name, value in (("telemetry", telemetry), ("log_sink", log_sink),
                            ("events", events)):
            if value is not None:
                raise NotImplementedError(f"Router({name}=...) is not yet "
                                          "ported")
        self._prefill_replicas = prefill_replicas
        if prefill_replicas:
            if not 0 < prefill_replicas < len(engines):
                raise ValueError(
                    f"prefill_replicas={prefill_replicas} must leave at "
                    f"least one decode replica (have {len(engines)})")
            stores = {id(getattr(e, "page_store", None)) for e in engines}
            if any(getattr(e, "page_store", None) is None
                   for e in engines) or len(stores) != 1:
                raise ValueError(
                    "prefill/decode disaggregation needs every replica "
                    "to mount ONE shared page store (the KV transport) — "
                    "build via Router.build(prefill_replicas=..., "
                    "prefix_pages=...)")
        self._roles = ["prefill" if i < prefill_replicas else "decode"
                       for i in range(len(engines))]
        self.clock = clock
        self._cp = SpanRecorder(clock=clock)
        self.schedulers = [
            Scheduler(e, writer, ttft_slo_s=ttft_slo_s, clock=clock,
                      replica_index=i, **scheduler_kw)
            for i, e in enumerate(engines)]
        if health is False:
            self.health: Optional[health_lib.HealthTracker] = None
        elif isinstance(health, health_lib.HealthTracker):
            self.health = health
        elif isinstance(health, health_lib.HealthConfig):
            self.health = health_lib.HealthTracker(len(engines), health,
                                                   clock=clock)
        elif health is None and len(engines) == 1:
            self.health = None
        else:    # None with a fleet, or True
            self.health = health_lib.HealthTracker(len(engines), clock=clock)
        self.ttft_slo_s = ttft_slo_s
        #: fleet rid -> (replica, the replica's local rid)
        self._where: dict[int, tuple[int, int]] = {}
        #: front-door sheds: terminal records no scheduler saw, bounded
        #: like the schedulers' completed records
        self._router_shed: dict[int, dict] = {}
        self._shed_cap = int(scheduler_kw.get("completed_cap", 100_000))
        self._shed_router = 0
        self._requeued = 0
        #: prefill-phase handoffs in flight: fleet rid -> (the ORIGINAL
        #: request, its submit moment); the rid points at the one-token
        #: job on a prefill replica meanwhile
        self._handoff: dict[int, tuple[Request, float]] = {}
        self._handoffs = 0
        self._next_id = 0
        self._ticks = 0
        #: the fleet's param version (hot-swap is not ported: always 0)
        self._version = 0

    @classmethod
    def build(cls, cfg, params, *, n_replicas: int, n_slots: int,
              max_len: int, prefill_chunk: int = 16, mesh=None,
              kv_page_size: int = 0, prefix_pages: int = 0,
              page_save_after: int = 2, draft_cfg=None, draft_params=None,
              spec_k: int = 0, prefill_replicas: int = 0, device="cuda",
              **router_kw) -> "Router":
        """N replicas over ONE set of weights: replica 0 loads ``params``,
        every other replica takes replica 0's parameter tensors. Each has
        its own slot state (and page pool, when on). The draft arms the
        DECODE replicas only (a prefill replica never decodes).
        ``prefill_replicas`` = P disaggregates: the first P replicas are
        prefill-role and every replica mounts replica 0's page store,
        with saves made on the first sighting (``page_save_after`` = 1: a
        transport that waited for a second sighting would carry
        nothing)."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas={n_replicas} must be >= 1")
        if prefill_replicas and not prefix_pages:
            raise ValueError(
                "prefill_replicas needs prefix_pages > 0: the page pool "
                "IS the prefill→decode KV transport")
        if prefill_replicas and not 0 < prefill_replicas < n_replicas:
            raise ValueError(
                f"prefill_replicas={prefill_replicas} must leave at "
                f"least one decode replica (have {n_replicas})")
        if prefill_replicas:
            page_save_after = 1
        engines, store = [], None
        for r in range(n_replicas):
            pre = r < prefill_replicas
            engines.append(DecodeEngine(
                cfg, params, n_slots=n_slots, max_len=max_len,
                prefill_chunk=prefill_chunk, mesh=mesh, device=device,
                kv_page_size=kv_page_size, prefix_pages=prefix_pages,
                page_save_after=page_save_after, shared_pages=store,
                draft_cfg=None if pre else draft_cfg,
                draft_params=None if pre else draft_params,
                spec_k=0 if pre else spec_k,
                weights_from=engines[0] if engines else None))
            if prefill_replicas and store is None:
                store = engines[0].page_store
        return cls(engines, prefill_replicas=prefill_replicas, **router_kw)

    # ------------------------------------------------------------ admission

    def _routable(self, i: int) -> bool:
        return self.health is None or self.health.routable(i)

    def _pick(self, phase: str = "decode") -> Optional[int]:
        """The replica for a new request: routable ones only, by health
        rank, occupancy, queue depth, then index. Under disaggregation
        only the ``phase``'s role — unless no replica of it is routable,
        when the whole routable fleet serves it. None when nothing is
        routable (the caller sheds)."""
        t0 = self.clock()
        try:
            cands = [i for i in range(len(self.schedulers))
                     if self._routable(i)]
            if not cands:
                return None
            if self._prefill_replicas:
                role = [i for i in cands if self._roles[i] == phase]
                cands = role or cands
            rank = (self.health.rank if self.health is not None
                    else (lambda i: 0))
            return min(cands,
                       key=lambda i: (rank(i), self.schedulers[i].occupancy,
                                      self.schedulers[i].queue_depth, i))
        finally:
            self._cp.add("cp_pick", self.clock() - t0)

    def _wants_prefill_replica(self, req: Request) -> bool:
        """A request is prefill-heavy when at least one full page of its
        prompt is not in the shared store yet; cached stems and sub-page
        prompts go straight to a decode replica."""
        if not self._prefill_replicas:
            return False
        eng = self.schedulers[0].engine
        prompt = tuple(int(t) for t in req.prompt)
        full = max(0, (len(prompt) - 1) // eng.page_size)
        if full < 1:
            return False
        have, _ = eng._prefix.longest(prompt, cap=full,
                                      epoch=eng.param_version)
        return have < full

    def _shed_at_door(self, rid: int) -> None:
        eta = (self.health.quarantined_eta_s()
               if self.health is not None else None)
        self._router_shed[rid] = {
            "status": "shed", "tokens": [],
            "retry_after_s": round(eta if eta is not None else 1.0, 3)}
        self._where.pop(rid, None)
        self._shed_router += 1
        while len(self._router_shed) > self._shed_cap:
            self._router_shed.pop(next(iter(self._router_shed)))

    def submit(self, req: Request) -> int:
        """Admit a request; returns its fleet-wide id. The id is taken
        only once a replica accepted (a rejected prompt takes none)."""
        rid = self._next_id
        if self._wants_prefill_replica(req):
            i = self._pick("prefill")
            if i is None:
                self._next_id += 1
                self._shed_at_door(rid)
                return rid
            t0 = self.clock()
            job = dataclasses.replace(req, max_new=1)
            local = self.schedulers[i].submit(job, trace_id=rid,
                                              submit_t=t0)
            self._next_id += 1
            self._where[rid] = (i, local)
            self._handoff[rid] = (req, t0)
            self._handoffs += 1
            return rid
        i = self._pick()
        if i is None:
            self._next_id += 1
            self._shed_at_door(rid)
            return rid
        local = self.schedulers[i].submit(req, trace_id=rid)
        self._next_id += 1
        self._where[rid] = (i, local)
        return rid

    def _promote_handoffs(self) -> None:
        """Move every finished prefill job's original request onto a
        decode replica: ``done`` (its pages are saved) and ``shed`` (the
        prefill queue was full; the decode tier may have room) promote; a
        ``timeout`` or ``error`` job is the request's own verdict — its
        deadline ran from the original submit, and a poisoned prefill
        raises wherever it lands."""
        for rid in list(self._handoff):
            i, local = self._where[rid]
            st = self.schedulers[i].poll(local)
            if st["status"] not in ("done",) + FAILED_STATUSES:
                continue
            req, t0 = self._handoff.pop(rid)
            if st["status"] in ("timeout", "error"):
                continue               # adopted verdict; record retained
            self.schedulers[i].release(local)
            j = self._pick()
            if j is None:
                self._shed_at_door(rid)
                continue
            local2 = self.schedulers[j].submit(req, trace_id=rid,
                                               submit_t=t0)
            self._where[rid] = (j, local2)

    def replica_of(self, rid: int) -> int:
        """The replica that holds request ``rid``."""
        return self._where[rid][0]

    def postmortem_state(self) -> dict:
        """Per-replica in-flight ids and slot ages, the router's counters
        and the health verdicts — host facts only."""
        out = {f"replica{i}": s.postmortem_state()
               for i, s in enumerate(self.schedulers)}
        out["router"] = {"shed_at_door": self._shed_router,
                         "requeued": self._requeued,
                         "version": self._version,
                         "replica_versions": [s.engine.param_version
                                              for s in self.schedulers]}
        if self.health is not None:
            out["router"]["health"] = self.health.states()
            out["router"]["health_counters"] = dict(self.health.counters)
            out["router"]["health_transitions"] = \
                list(self.health.transitions)[-10:]
        return out

    # ------------------------------------------------------ quarantine drain

    def quarantine(self, i: int, cause: str = "forced") -> None:
        """Quarantine replica ``i`` now and requeue its in-flight
        requests onto survivors (the health watchdog reaches the same
        path from :meth:`tick`)."""
        if self.health is None:
            raise RuntimeError(
                "Router health is disabled (single replica without an "
                "explicit HealthConfig) — nothing to quarantine with")
        self.health.quarantine(i, cause)
        self._requeue_from(i)

    def _requeue_from(self, i: int) -> None:
        """Drain replica ``i``: every in-flight request goes to a survivor
        in submit order with its fleet id and original submit time (a
        drained prefill job to the prefill tier, if any of it is
        routable); with no routable survivor it sheds at the door."""
        for rec in self.schedulers[i].evict_for_requeue():
            rid = rec.trace_id
            phase = "prefill" if rid in self._handoff else "decode"
            j = self._pick(phase)      # never i: quarantined
            if j is None:
                self._handoff.pop(rid, None)
                self._shed_at_door(rid)
                continue
            local = self.schedulers[j].submit(
                rec.req, trace_id=rid, submit_t=rec.submit_t, requeued=True)
            self._where[rid] = (j, local)
            self._requeued += 1

    def _probe(self, i: int) -> None:
        """One timed decode probe of an idle probation replica, so its
        readmission need not wait for live traffic."""
        t0 = self.clock()
        try:
            self.schedulers[i].engine.probe()
        except Exception as e:  # noqa: BLE001 — a failed probe is the
            # quarantine signal; an idle replica has nothing to requeue
            self.health.note_fault(i, e)
            return
        self.health.note_tick(i, self.clock() - t0)

    # -------------------------------------------------------------- hot-swap

    def start_swap(self, *args, **kwargs):
        raise NotImplementedError(_HOT_SWAP)

    def finish_swap(self, *args, **kwargs):
        raise NotImplementedError(_HOT_SWAP)

    def maybe_swap_published(self, *args, **kwargs):
        raise NotImplementedError(_HOT_SWAP)

    def maybe_swap_draft(self, *args, **kwargs):
        raise NotImplementedError(_HOT_SWAP)

    def stamp_version(self, *args, **kwargs):
        raise NotImplementedError(_HOT_SWAP)

    # ----------------------------------------------------------- pump surface

    @property
    def pending(self) -> int:
        return sum(s.pending for s in self.schedulers)

    def tick(self) -> None:
        """One round on every routable replica with work. With health on,
        each replica tick is wall-timed and judged; a quarantine verdict
        (slow, wedged or faulted) drains that replica at once, so the
        pump never calls into it again. The tick's host time is split
        into the ``cp_*`` phases."""
        self._ticks += 1
        cp = self._cp
        h = self.health
        t_loop0 = self.clock()
        engine_s = 0.0
        for i, s in enumerate(self.schedulers):
            if h is None:
                if s.pending:
                    t0 = self.clock()
                    s.tick()
                    engine_s += self.clock() - t0
                continue
            if not h.routable(i):
                continue
            if not s.pending:
                if h.state(i) == health_lib.PROBATION:
                    self._probe(i)
                continue
            t0 = self.clock()
            try:
                s.tick()
            except Exception as e:  # noqa: BLE001 — a decode-path engine
                # failure has no single owning request: quarantine the
                # replica and replay its in-flight work on survivors
                engine_s += self.clock() - t0
                h.note_fault(i, e)
                self._requeue_from(i)
                continue
            dur = self.clock() - t0
            engine_s += dur
            if h.note_tick(i, dur) == health_lib.QUARANTINED:
                self._requeue_from(i)
        t_loop1 = self.clock()
        cp.add("cp_engine_tick", engine_s)
        cp.add("cp_health_sweep", max(0.0, (t_loop1 - t_loop0) - engine_s))
        t0 = self.clock()
        self._promote_handoffs()
        t1 = self.clock()
        cp.add("cp_page_ops", t1 - t0)
        cp.add("cp_bookkeeping", self.clock() - t1)

    def run_until_idle(self, max_ticks: int = 100000, *,
                       on_tick=None) -> None:
        for _ in range(max_ticks):
            if not self.pending:
                return
            self.tick()
            if on_tick is not None:
                on_tick()
        raise RuntimeError(f"requests still pending after {max_ticks} ticks")

    def poll(self, rid: int) -> dict:
        shed = self._router_shed.get(rid)
        if shed is not None:
            return dict(shed)
        if rid in self._handoff:
            # the prefill phase of a disaggregated request: the job's own
            # statuses and its one token are plumbing
            return {"status": "prefill", "tokens": []}
        i, local = self._where[rid]
        return self.schedulers[i].poll(local)

    def result(self, rid: int, max_ticks: int = 100000) -> list[int]:
        for _ in range(max_ticks):
            st = self.poll(rid)
            if st["status"] == "done":
                return st["tokens"]
            if st["status"] in FAILED_STATUSES:
                raise RequestFailed(rid, st)
            self.tick()
        raise RuntimeError(f"request {rid} not done after {max_ticks} ticks")

    def release(self, rid: int) -> None:
        if self._router_shed.pop(rid, None) is not None:
            return
        i, local = self._where.pop(rid)
        self.schedulers[i].release(local)

    def drain(self) -> None:
        self.run_until_idle()

    # --------------------------------------------------------------- metrics

    def trace_counts(self) -> list[dict]:
        """Each replica's step-function builds, page steps included."""
        return [{**s.engine.trace_counts,
                 **{f"page_{k}": v
                    for k, v in s.engine.page_trace_counts.items()}}
                for s in self.schedulers]

    def accept_by_version(self) -> dict:
        """Fleet-summed speculative counts ``{version: (proposed,
        accepted)}``."""
        fleet: dict = {}
        for s in self.schedulers:
            for v, (prop, acc) in s.accept_by_version().items():
                cur = fleet.get(v, (0, 0))
                fleet[v] = (cur[0] + prop, cur[1] + acc)
        return dict(sorted(fleet.items()))

    def stats(self, brief: bool = False) -> dict:
        """Fleet aggregates and the ``replica{i}_*`` panel."""
        n = len(self.schedulers)
        out = {
            "router_replicas": float(n),
            "router_completed": float(sum(s._completed
                                          for s in self.schedulers)),
            "router_queue_depth": float(sum(s.queue_depth
                                            for s in self.schedulers)),
            "router_occupancy": (sum(s.occupancy for s in self.schedulers)
                                 / n),
        }
        if brief:
            return out
        out["router_version"] = float(self._version)
        out["router_swaps"] = 0.0
        out["router_swap_rollbacks"] = 0.0
        out["router_swap_in_progress"] = 0.0
        for i, s in enumerate(self.schedulers):
            out[f"replica{i}_version"] = float(s.engine.param_version)
        out["router_shed"] = float(self._shed_router
                                   + sum(s._shed for s in self.schedulers))
        out["router_timeouts"] = float(sum(s._timeouts
                                           for s in self.schedulers))
        out["router_request_errors"] = float(
            sum(s._request_errors for s in self.schedulers))
        out["router_requeued"] = float(self._requeued)
        if self._prefill_replicas:
            out["router_prefill_replicas"] = float(self._prefill_replicas)
            out["router_handoffs"] = float(self._handoffs)
            for i, role in enumerate(self._roles):
                out[f"replica{i}_role"] = role
        if self.health is not None:
            hc = self.health.counters
            out["router_quarantines"] = float(hc["quarantines"])
            out["router_probation_readmits"] = float(hc["readmits"])
            out["router_replica_faults"] = float(hc["faults"])
            for i in range(n):
                out[f"replica{i}_health"] = self.health.state(i)
        # a prefill replica's TTFTs are its jobs' (plumbing): the decode
        # replicas record the user's, from the original submit
        ttfts = [t for i, s in enumerate(self.schedulers)
                 if not (self._prefill_replicas
                         and self._roles[i] == "prefill")
                 for t in s._ttfts]
        out["router_ttft_p50_s"] = _quantile(ttfts, 0.5)
        out["router_ttft_p99_s"] = _quantile(ttfts, 0.99)
        if self.ttft_slo_s > 0.0:
            out["router_ttft_slo_ok_frac"] = (
                sum(1 for t in ttfts if t <= self.ttft_slo_s) / len(ttfts)
                if ttfts else 1.0)
        for v, (prop, acc) in self.accept_by_version().items():
            if prop:
                out[f"router_spec_accept_rate_v{v}"] = acc / prop
        counters: dict = {}
        for s in self.schedulers:
            for k, v in s.engine.counters.items():
                counters[k] = counters.get(k, 0) + v
        out.update({f"router_{k}": float(v) for k, v in counters.items()})
        out["router_ticks"] = float(self._ticks)
        for name, roll in self._cp.rollup().items():
            out[f"{name}_total_s"] = roll["total_s"]
            out[f"{name}_mean_s"] = roll["mean_s"]
            out[f"{name}_p99_s"] = roll["p99_s"]
        for i, s in enumerate(self.schedulers):
            st = s.stats()
            for k in _REPLICA_KEYS:
                if k in st:
                    out[f"replica{i}_{k}"] = st[k]
        return out


def poisson_replay(router, arrivals, *, clock=time.perf_counter,
                   sleep=time.sleep) -> float:
    """:func:`dtf_tpu_torch.serve.client.replay` on a router (the same
    submit / tick / pending surface)."""
    from dtf_tpu_torch.serve.client import replay

    return replay(router, arrivals, clock=clock, sleep=sleep)


__all__ = ["CP_PHASES", "Router", "SwapConfig", "poisson_replay"]
