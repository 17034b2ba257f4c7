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
only). Not yet ported, and raising: the draft-only swap
(``maybe_swap_draft``).

**The run-record plane** (host facts only: no device readback, no token
changed): ``events=`` (:class:`dtf_tpu_torch.telemetry.events.EventLog`)
receives ``requeue_drain``, ``swap_start``, ``swap_canary``,
``swap_rollback``, ``swap_commit`` and every :attr:`CP_PROFILE_EVERY`
ticks ``cp_profile``, each stamped with the router tick, and the health
tracker's ``health_transition``; ``log_sink=`` is one
:class:`dtf_tpu_torch.serve.logsink.LogSink` every replica's scheduler
records into; ``telemetry=`` gives each scheduler its spans and tracer,
times each replica's swap as ``serve_swap`` and registers the fleet's
postmortem provider.

**The rolling weight swap** (:meth:`Router.start_swap`): a new version
rolls across the fleet with no downtime. One replica at a time is
drained through the requeue path (its requests replay whole on the
others), swapped (``DecodeEngine.swap_params``: its module rebinds to
the version's tensors, no step function is built again), probed and
readmitted. The first is the CANARY: it serves alone on the new version
for :class:`SwapConfig`'s ``canary_ticks`` under the health watchdog and
a TTFT floor, and a breach, or a failed swap step (the ``wedge_in_swap``
verb), rolls every swapped replica back to the previous version. A
replica whose rollback fails stays out of traffic until a repair
realigns it. The router places each version's tensors once and hands
the same set to every replica, so the fleet holds one set, two during a
roll. ``maybe_swap_published`` drives it from a
:class:`dtf_tpu_torch.publish.PublishWatcher`; records stamp the version
that decoded them, and a commit or a rollback frees the prefix pages of
other versions. Each swap step is timed on the router's clock
(:meth:`Router.swap_profile`).

**A fleet of sharded replicas** (``Router.build(mesh=)``, the reference's
N replicas on one mesh over one set of sharded weights): every rank of
the mesh builds the same fleet, each replica a ``DecodeEngine(mesh=)``
on this rank's heads and data line, all on ONE call plane
(:mod:`dtf_tpu_torch.serve.plane`) and one set of the rank's shard
tensors (by identity). Rank 0's router leads: it routes, watches health,
polls the publish dir and rolls the fleet under the same canary,
rollback, repair and skew rules, and every device call it leads to is
announced with its replica's index. On every other rank the router is a
FOLLOWER (:meth:`Router.follow`): no scheduler, health tracker or record
plane (they read the clock); its engines and the fleet's own steps run
the leader's calls. A roll's steps over the plane: ``stage`` (every rank
loads the version the leader verified from the publish dir at that
explicit version, with its digest checked, and places its shards; no
parameter tensor crosses the group), one ``swap`` a replica (its
rebind; a rollback's and a repair's too), the probe's decode, then
``commit`` or ``rollback`` (each rank drops the sets it no longer serves
and frees the stale prefix pages). A rank holds its previous shard set,
by identity, until the commit or the rollback: a roll's peak is a fresh
fleet's plus one shard set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import time
from typing import Callable, Optional, Sequence

from dtf_tpu_torch.metrics import quantile as _quantile
from dtf_tpu_torch.serve import health as health_lib
from dtf_tpu_torch.serve.engine import DecodeEngine
from dtf_tpu_torch.serve.plane import FLEET, shared_plane
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

log = logging.getLogger("dtf_tpu_torch")


@dataclasses.dataclass(frozen=True)
class SwapConfig:
    """Knobs of the rolling weight swap (module docstring).

    The FIRST swapped replica is the canary: for ``canary_ticks`` router
    ticks it serves on the new version alone, and a breach inside that
    window — its health leaving HEALTHY, or, with a TTFT objective set,
    its post-swap ok-fraction under ``slo_floor`` over at least
    ``slo_min_samples`` completions — rolls the fleet back. After a clean
    window the rest of the fleet follows, one replica a tick."""

    canary_ticks: int = 8
    slo_floor: float = 0.0          # 0 = health gate only
    slo_min_samples: int = 1

    def __post_init__(self):
        if self.canary_ticks < 1:
            raise ValueError(
                f"canary_ticks={self.canary_ticks} must be >= 1 (a swap "
                "with no canary window cannot be health-gated)")
        if not 0.0 <= self.slo_floor <= 1.0:
            raise ValueError(f"slo_floor={self.slo_floor} must be in "
                             "[0, 1]")
        if self.slo_min_samples < 1:
            raise ValueError(
                f"slo_min_samples={self.slo_min_samples} must be >= 1")


@dataclasses.dataclass(frozen=True)
class VersionSource:
    """Where every rank of a sharded fleet takes a version from: the
    publish ``directory``, the ``digest`` the leader verified, and the
    ``draft_factory`` (picklable: it travels with the call) that cuts the
    draft from the whole parameters, if any."""

    directory: str
    digest: str
    draft_factory: Optional[Callable] = None

    def load(self, version: int) -> tuple[dict, Optional[dict]]:
        """``(params, draft)`` of ``version``, whole, on the host: the
        explicit load (no fallback). A digest other than the leader's is
        a fault, and raises."""
        from dtf_tpu_torch.publish import load_published, published_digest

        got = published_digest(self.directory, version)
        if got != self.digest:
            raise RuntimeError(
                f"published version {version} at {self.directory} records "
                f"digest {got}, the leader verified {self.digest}: the "
                "ranks would serve different weights")
        _, _, params = load_published(self.directory, version=version)
        return params, (None if self.draft_factory is None
                        else self.draft_factory(params))


class Router:
    """Least-occupancy admission over N engine replicas (module
    docstring). Build from engines (sharing weights by construction) or
    with :meth:`build`; ``ttft_slo_s``, ``clock`` and the scheduler
    keywords apply to every replica's scheduler. ``health``: None (on
    with more than one replica), True, False, a
    :class:`~dtf_tpu_torch.serve.health.HealthConfig` or a
    :class:`~dtf_tpu_torch.serve.health.HealthTracker`. Over a mesh the
    engines share one call plane, and on a rank other than the leader's
    the router only follows (module docstring)."""

    #: router ticks between ``cp_profile`` events on the event log
    CP_PROFILE_EVERY = 256

    def __init__(self, engines: Sequence[DecodeEngine], writer=None, *,
                 telemetry=None, ttft_slo_s: float = 0.0,
                 clock=time.monotonic, health=None,
                 prefill_replicas: int = 0, log_sink=None, events=None,
                 **scheduler_kw):
        if not engines:
            raise ValueError("Router needs at least one engine replica")
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
        #: the replicas' engines, in replica order (the plane's order)
        self.engines = list(engines)
        self._plane = shared_plane(engines)
        if self._plane is not None:
            self._plane.fleet = self
        if not self.is_leader:
            # a follower rank: its engines and the fleet's steps run the
            # leader's calls; no scheduler, health tracker or record
            # plane is built here (they read the clock)
            self.schedulers = []
            return
        self.telemetry = telemetry
        self.clock = clock
        #: one serve-log sink for the fleet: the pump is one thread and
        #: records carry their replica
        self.log_sink = log_sink
        #: one event log for the fleet (module docstring)
        self.events = events
        self._cp = SpanRecorder(clock=clock)
        self.schedulers = [
            Scheduler(e, writer, telemetry=telemetry, ttft_slo_s=ttft_slo_s,
                      clock=clock, postmortem_name=None, log_sink=log_sink,
                      replica_index=i, **scheduler_kw)
            for i, e in enumerate(engines)]
        if health is False:
            self.health: Optional[health_lib.HealthTracker] = None
        elif isinstance(health, health_lib.HealthTracker):
            self.health = health
            if events is not None and health.events is None:
                health.events = events   # one timeline for the fleet
        elif isinstance(health, health_lib.HealthConfig):
            self.health = health_lib.HealthTracker(
                len(engines), health, clock=clock, events=events)
        elif health is None and len(engines) == 1:
            self.health = None
        else:    # None with a fleet, or True
            self.health = health_lib.HealthTracker(len(engines), clock=clock,
                                                   events=events)
        if telemetry is not None:
            # one postmortem provider for the fleet (the replicas' would
            # collide on the name)
            telemetry.add_postmortem_provider("serve_router",
                                              self.postmortem_state)
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
        #: the fleet's COMMITTED param version (each replica's own is on
        #: its engine)
        self._version = 0
        #: the rolling swap in progress (None: steady state)
        self._swap: Optional[dict] = None
        #: the replica being drained and swapped (never routable)
        self._swapping: Optional[int] = None
        #: replicas left on rejected weights (their rollback failed):
        #: replica -> (params, draft, version) to realign them with; never
        #: routable until :meth:`_retry_version_repair` lands
        self._version_repair: dict[int, tuple] = {}
        #: without health there is no quarantine to pace repair retries:
        #: replica -> (next tick allowed, delay in ticks)
        self._repair_backoff: dict[int, tuple[int, int]] = {}
        self._swaps = 0
        self._swap_rollbacks = 0
        self._last_swap: Optional[dict] = None
        #: the version-skew tripwire: warned once while the fleet spans
        #: more than one version outside a swap, re-armed on convergence
        self._skew_warned = False
        #: each swap step on the router's clock: ``swap_drain``,
        #: ``swap_params``, ``swap_probe`` (per replica), ``serve_swap``
        #: (drain and swap, the reference's span), ``swap_canary`` (the
        #: canary's swap to the end of its window) and ``swap_roll``
        #: (start to commit or rollback)
        self._swap_spans = SpanRecorder(clock=clock)

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

    # ------------------------------------------------------ the call plane

    @property
    def is_leader(self) -> bool:
        """True where this router routes: always without a mesh, on the
        world's rank 0 with one."""
        return self._plane is None or self._plane.is_leader

    def leading(self):
        """The leader's serving body (a context manager): on leaving it
        the followers are stopped, ``ok`` unless it raised; a null
        context without a mesh."""
        if self._plane is None:
            return contextlib.nullcontext(self)
        return self._plane.leading()

    def follow(self) -> bool:
        """A follower rank of a sharded fleet: run the leader's calls on
        this rank's replicas and fleet until its stop; returns whether it
        stopped cleanly."""
        if self._plane is None:
            raise RuntimeError("follow() is for the ranks of a sharded "
                               "fleet (Router.build(mesh=))")
        return self._plane.follow()

    def _run_op(self, op: str, args: tuple):
        return getattr(self, f"_op_{op}")(*args)

    def _fleet(self, op: str, *args, run=None):
        """The fleet's step ``op``: here without a mesh; over one,
        announced to every rank first (``run``: the leader's own run, if
        it differs from the followers')."""
        run = run or self._run_op
        if self._plane is None:
            return run(op, args)
        return self._plane.call(FLEET, run, op, args)

    def _stage_here(self, version: int, params, draft
                    ) -> tuple[dict, Optional[dict]]:
        """Place a version's set on this rank once (``DecodeEngine.place``:
        over a mesh this rank's shards) and, over a mesh, register it and
        the sets the replicas serve now, under keys every rank shares."""
        place = getattr(self.engines[0], "place", None)
        if place is not None:
            params, draft = place(params, draft)
        if self._plane is not None:
            sets = self._plane.sets
            for i, e in enumerate(self.engines):
                sets.put(("prev", i), e.params)
                if e.spec_k:
                    sets.put(("prev_draft", i), e.draft_params)
            sets.put(("new", version), params)
            if draft is not None:
                sets.put(("new_draft", version), draft)
        return params, draft

    def _op_stage(self, version: int, source: VersionSource):
        """A follower's staging: the version from its source, whole on the
        host, then this rank's shards."""
        return self._stage_here(version, *source.load(version))

    def _settle(self, version: int, keep: list) -> None:
        """The end of a roll on this rank: drop every staged set but the
        ones a pending repair needs, and free the prefix pages of versions
        other than ``version``."""
        if self._plane is not None:
            self._plane.sets.keep_only(keep)
        self._invalidate_stale_pages(version)

    # two ops, one step: the plane's stats tell a commit from a rollback
    _op_commit = _op_rollback = _settle

    def _repair_keys(self) -> list:
        """The staged sets the pending repairs rebind (over a mesh)."""
        if self._plane is None:
            return []
        sets = self._plane.sets
        return [sets.key_of(t) for params, draft, _ in
                self._version_repair.values()
                for t in (params, draft) if t is not None]

    # ------------------------------------------------------------ admission

    def _emit(self, kind: str, /, **fields) -> None:
        """One fleet event, stamped with the router tick (the pump's own
        counter, which lines events up with the tick profile under an
        injected clock)."""
        if self.events is not None:
            self.events.emit(kind, tick=self._ticks, **fields)

    def _routable(self, i: int) -> bool:
        if i == self._swapping:     # mid-drain or mid-swap
            return False
        if i in self._version_repair:
            # on weights the fleet rolled back from: no traffic (and no
            # probation probe) until the repair lands
            return False
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
        # pages are keyed by version: while the routable replicas'
        # versions differ (a roll in flight), a prefill job would save
        # pages at one version that the decode admission looks up at
        # another — go straight to decode until they converge
        versions = {getattr(s.engine, "param_version", 0)
                    for i, s in enumerate(self.schedulers)
                    if self._routable(i)}
        if len(versions) > 1:
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
                         "replica_versions": [
                             getattr(s.engine, "param_version", None)
                             for s in self.schedulers],
                         "swaps": self._swaps,
                         "swap_rollbacks": self._swap_rollbacks,
                         "swap_in_progress": self._swap is not None,
                         "version_repair_pending": sorted(
                             self._version_repair)}
        if self._last_swap is not None:
            out["router"]["last_swap"] = dict(self._last_swap)
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
        moved = shed = 0
        for rec in self.schedulers[i].evict_for_requeue():
            rid = rec.trace_id
            phase = "prefill" if rid in self._handoff else "decode"
            j = self._pick(phase)      # never i: quarantined
            if j is None:
                self._handoff.pop(rid, None)
                self._shed_at_door(rid)
                shed += 1
                continue
            local = self.schedulers[j].submit(
                rec.req, trace_id=rid, submit_t=rec.submit_t, requeued=True)
            self._where[rid] = (j, local)
            self._requeued += 1
            moved += 1
        if moved or shed:
            self._emit("requeue_drain", replica=i, requeued=moved,
                       shed=shed)

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

    # --------------------------------------------------- rolling weight swap

    def stamp_version(self, version: int) -> None:
        """Stamp the version the fleet was BUILT with (serving a published
        version from the start) on every replica: no swap, no drain. Call
        it before traffic, so records, page epochs and the skew tripwire
        carry the real version."""
        for e in self.engines:
            setter = getattr(e, "set_param_version", None)
            if setter is not None:
                setter(version)
        self._version = int(version)

    @property
    def swap_in_progress(self) -> bool:
        return self._swap is not None

    @property
    def version(self) -> int:
        """The fleet's committed version (each replica's: ``stats()``'s
        ``replica{i}_version``)."""
        return self._version

    def start_swap(self, params, *, version: Optional[int] = None,
                   draft_params=None, config: Optional[SwapConfig] = None,
                   source: Optional[VersionSource] = None) -> int:
        """Begin a ROLLING swap of the fleet onto ``params`` (module
        docstring); it advances one step a :meth:`tick` (with no traffic,
        pump :meth:`finish_swap`). The tensors are placed on the device
        once here (``DecodeEngine.place``): every replica takes the same
        set. ``version`` must move forward (default: committed + 1);
        ``draft_params`` rides the same transaction on speculative
        replicas. Over a mesh ``params`` are whole and ``source`` says
        where the other ranks load the same version from (the staging is
        a call of the plane; ``draft_params`` must be
        ``source.draft_factory(params)``). Returns the target version."""
        if self._swap is not None:
            raise RuntimeError(
                f"a rolling swap to version {self._swap['version']} is "
                "already in progress")
        n = len(self.schedulers)
        if n < 2:
            raise ValueError(
                "a rolling swap needs >= 2 replicas (one drains while "
                "the others serve); a single engine swaps via "
                "DecodeEngine.swap_params after draining")
        version = self._version + 1 if version is None else int(version)
        if version <= self._version:
            raise ValueError(
                f"swap version {version} is not monotone (fleet is at "
                f"{self._version}) — published versions only move "
                "forward")
        cfg = config or SwapConfig()
        if self._plane is not None and source is None:
            raise ValueError(
                "a sharded fleet's swap needs source= (a VersionSource: "
                "the publish dir and the digest every rank loads the "
                "version with — no parameter tensor crosses the group)")
        whole = (params, draft_params)
        params, draft_params = self._fleet(
            "stage", version, source,
            run=lambda op, args: self._stage_here(version, *whole))
        rank = (self.health.rank if self.health is not None
                else (lambda i: 0))
        # healthiest replica first: the canary must start clean, or the
        # gate would trip on trouble it did not cause
        order = sorted(range(n), key=lambda i: (rank(i), i))
        self._swap = {
            "version": version, "params": params, "draft": draft_params,
            "cfg": cfg, "order": order, "canary": order[0],
            "canary_swapped": False, "ticks_left": cfg.canary_ticks,
            "ttft_mark": 0, "done": [], "t0": self.clock(),
            "t_canary": None,
            "prev_params": [getattr(s.engine, "params", None)
                            for s in self.schedulers],
            "prev_draft": [getattr(s.engine, "draft_params", None)
                           if getattr(s.engine, "spec_k", 0) else None
                           for s in self.schedulers],
            "prev_version": [getattr(s.engine, "param_version", 0)
                             for s in self.schedulers],
            "watcher": None,
        }
        self._emit("swap_start", version=version, canary=order[0],
                   canary_ticks=cfg.canary_ticks,
                   draft=draft_params is not None)
        log.info("rolling swap to param version %d started (canary "
                 "replica %d, %d-tick window)", version, order[0],
                 cfg.canary_ticks)
        return version

    def maybe_swap_published(self, watcher, *,
                             config: Optional[SwapConfig] = None,
                             draft_factory=None) -> Optional[int]:
        """Poll a :class:`dtf_tpu_torch.publish.PublishWatcher` and start
        a rolling swap when it hands over a NEW verified version (a
        corrupt publish was already skipped with a warning there).
        ``draft_factory(params) -> draft_params`` rebuilds the draft from
        the new weights (the ``--draft_layers`` early exit). No-op while a
        swap is in progress. Returns the version a swap started for, else
        None."""
        if self._swap is not None:
            return None
        got = watcher.load_new()
        if got is None:
            return None
        version, step, params = got
        if version <= self._version:
            watcher.note_applied(version)
            return None
        draft = draft_factory(params) if draft_factory is not None else None
        source = (None if self._plane is None else VersionSource(
            watcher.directory, watcher.last_digest, draft_factory))
        v = self.start_swap(params, version=version, draft_params=draft,
                            config=config, source=source)
        self._swap["watcher"] = watcher
        self._swap["step"] = step
        return v

    def maybe_swap_draft(self, *args, **kwargs):
        """The draft-only swap (a distilled draft's publish dir): not yet
        ported — its only writer, ``train_gpt --distill_*``, needs the
        serve-log sink."""
        raise NotImplementedError("the draft-only swap (maybe_swap_draft, "
                                  "--draft_publish_dir) is not yet ported")

    def finish_swap(self, max_ticks: int = 100000) -> None:
        """Pump ticks until the swap in progress commits or rolls back
        (ticks with no traffic still advance it)."""
        for _ in range(max_ticks):
            if self._swap is None:
                return
            self.tick()
        raise RuntimeError(f"swap still in progress after {max_ticks} "
                           "ticks")

    def swap_profile(self) -> dict:
        """The swap steps' timings on the router's clock, by span
        (``SpanRecorder.rollup``; ``__init__`` names them)."""
        return {k: dict(v) for k, v in self._swap_spans.rollup().items()}

    def _swap_replica(self, i: int, params, draft, version: int, *,
                      probe: bool = True, mark=None) -> None:
        """Drain replica ``i`` onto the rest of the fleet, swap its
        weights, probe it, readmit it. Its requests requeue with their
        original id and submit time, so a request spanning the swap
        replays WHOLE on one version. ``mark`` runs the moment
        ``swap_params`` returns, before the probe: a replica whose probe
        raises is already recorded as swapped, and a rollback includes
        it (its weights did flip)."""
        spans, clock = self._swap_spans, self.clock
        self._swapping = i
        try:
            t0 = clock()
            self._requeue_from(i)
            t1 = clock()
            self.schedulers[i].engine.swap_params(
                params, draft_params=draft, version=version)
            t2 = clock()
        finally:
            self._swapping = None
        spans.add("swap_drain", t1 - t0)
        spans.add("swap_params", t2 - t1)
        spans.add("serve_swap", t2 - t0)
        if self.telemetry is not None:
            self.telemetry.spans.add("serve_swap", t2 - t0)
        # any successful swap supersedes a pending repair: a later retry
        # would revert the replica to the stale rolled-back weights
        self._version_repair.pop(i, None)
        self._repair_backoff.pop(i, None)
        if mark is not None:
            mark()
        quarantined = (self.health is not None
                       and self.health.state(i) == health_lib.QUARANTINED)
        if probe and not quarantined:
            # the same decode step, timed and judged: a replica that comes
            # back wedged is caught before live traffic lands on it
            fn = getattr(self.schedulers[i].engine, "probe", None)
            if fn is not None:
                t0 = clock()
                fn()        # raises: a swap failure (the caller rolls back)
                dur = clock() - t0
                spans.add("swap_probe", dur)
                if (self.health is not None
                        and self.health.note_tick(i, dur)
                        == health_lib.QUARANTINED):
                    self._requeue_from(i)

    def _advance_swap(self) -> None:
        """One step of the rolling swap, at the end of every tick. Any
        exception in a replica's swap step (``wedge_in_swap``, a failed
        probe, a tree that is not drop-in) rolls the partial fleet back
        onto ONE version: a swap can fail, the fleet cannot."""
        sw = self._swap
        if sw is None:
            return
        try:
            if not sw["canary_swapped"]:
                i = sw["canary"]

                def mark_canary():
                    sw["canary_swapped"] = True
                    sw["t_canary"] = self.clock()
                    sw["ttft_mark"] = self.schedulers[i].ttft_count
                    self._emit("swap_canary", version=sw["version"],
                               replica=i,
                               canary_ticks=sw["cfg"].canary_ticks)

                self._swap_replica(i, sw["params"], sw["draft"],
                                   sw["version"], mark=mark_canary)
                return
            if sw["ticks_left"] > 0:
                cause = self._canary_breach()
                if cause is not None:
                    self._rollback_swap(f"canary breach: {cause}")
                    return
                sw["ticks_left"] -= 1
                if sw["ticks_left"] == 0:
                    self._swap_spans.add("swap_canary",
                                         self.clock() - sw["t_canary"])
                return
            nxt = next((i for i in sw["order"]
                        if i != sw["canary"] and i not in sw["done"]),
                       None)
            if nxt is None:
                self._commit_swap()
                return
            self._swap_replica(nxt, sw["params"], sw["draft"],
                               sw["version"],
                               mark=lambda: sw["done"].append(nxt))
        except Exception as e:  # noqa: BLE001 — a failed swap step rolls
            # back; only the rollback itself may quarantine a replica
            self._rollback_swap(
                f"swap step failed: {type(e).__name__}: {e}")

    def _canary_breach(self) -> Optional[str]:
        """The canary gate: its health first, then the post-swap TTFT
        floor. None: clean so far."""
        sw = self._swap
        i = sw["canary"]
        if (self.health is not None
                and self.health.state(i) != health_lib.HEALTHY):
            return f"canary replica {i} health {self.health.state(i)}"
        cfg = sw["cfg"]
        if self.ttft_slo_s > 0.0 and cfg.slo_floor > 0.0:
            # samples since the canary's swap, counted on the monotone
            # counter (the TTFT deque is bounded: an index into it goes
            # stale once it wraps); requeued requests are left out — their
            # TTFT includes time lost on another replica's fault
            sched = self.schedulers[i]
            new = sched.ttft_count - sw["ttft_mark"]
            d, rq = sched._ttfts, sched._ttft_requeued
            lo = max(0, len(d) - min(new, len(d)))
            samples = [t for t, requeued in zip(
                itertools.islice(d, lo, None),
                itertools.islice(rq, lo, None)) if not requeued]
            if len(samples) >= cfg.slo_min_samples:
                ok = sum(1 for t in samples
                         if t <= self.ttft_slo_s) / len(samples)
                if ok < cfg.slo_floor:
                    return (f"canary TTFT SLO ok-frac {ok:.3f} < floor "
                            f"{cfg.slo_floor} over {len(samples)} "
                            "completions")
        return None

    def _rollback_swap(self, cause: str) -> None:
        """Fleet-wide rollback: every swapped replica (the canary
        included) drains and takes its previous weights back, so the fleet
        converges on one version. A replica that cannot swap back is
        quarantined out of traffic and marked for repair."""
        sw = self._swap
        self._swap = None
        swapped = ([sw["canary"]] if sw["canary_swapped"] else []) \
            + sw["done"]
        log.warning(
            "rolling swap to param version %d ROLLED BACK after %d "
            "replica(s): %s", sw["version"], len(swapped), cause)
        for i in reversed(swapped):
            try:
                self._swap_replica(i, sw["prev_params"][i],
                                   sw["prev_draft"][i],
                                   sw["prev_version"][i], probe=False)
            except Exception as e:  # noqa: BLE001 — a replica wedged both
                # ways leaves traffic by quarantine; the repair record
                # keeps probation from readmitting it on rejected weights
                log.warning("replica %d failed to roll back (%r)", i, e)
                self._version_repair[i] = (sw["prev_params"][i],
                                           sw["prev_draft"][i],
                                           sw["prev_version"][i])
                if self.health is not None:
                    self.health.quarantine(i, f"rollback failed: {e!r}")
                    self._requeue_from(i)
        self._swap_rollbacks += 1
        self._last_swap = {"version": sw["version"],
                           "outcome": "rolled_back", "cause": cause}
        self._swap_spans.add("swap_roll", self.clock() - sw["t0"])
        self._emit("swap_rollback", version=sw["version"], cause=cause,
                   swapped=len(swapped))
        if sw["watcher"] is not None:
            # a rolled-back version must not re-swap at the next poll:
            # only a newer publish may try again
            sw["watcher"].skipped.add(sw["version"])
        self._fleet("rollback", self._version, self._repair_keys())

    def _commit_swap(self) -> None:
        sw = self._swap
        self._swap = None
        self._version = sw["version"]
        self._swaps += 1
        self._last_swap = {"version": sw["version"], "outcome": "done"}
        self._swap_spans.add("swap_roll", self.clock() - sw["t0"])
        if sw["watcher"] is not None:
            sw["watcher"].note_applied(sw["version"])
        self._fleet("commit", self._version, self._repair_keys())
        self._emit("swap_commit", version=sw["version"],
                   draft=sw["draft"] is not None)
        log.info("rolling swap complete: fleet serving param version %d",
                 sw["version"])

    def _retry_version_repair(self, i: int) -> bool:
        """Realign a replica left on rolled-back weights with the fleet's
        version, before any probe or traffic. True once aligned."""
        params, draft, version = self._version_repair[i]
        try:
            self._swap_replica(i, params, draft, version, probe=False)
        except Exception as e:  # noqa: BLE001 — still broken: stays out
            # of traffic; the quarantine backoff (health) or the tick
            # backoff (no health) paces the next try
            log.warning("replica %d version repair failed (%r)", i, e)
            if self.health is not None:
                self.health.quarantine(i, f"version repair failed: {e!r}")
            else:
                _, delay = self._repair_backoff.get(i, (0, 1))
                self._repair_backoff[i] = (self._ticks + delay,
                                           min(delay * 2, 1024))
            return False
        log.info("replica %d re-aligned to param version %d after a "
                 "failed rollback", i, version)
        return True

    def _invalidate_stale_pages(self, version: int) -> None:
        """Free the prefix pages of versions other than ``version`` once
        the fleet has converged (lookups already skip them by version;
        this reclaims the pool). One pass a distinct store: a shared pool
        is walked once, not once a mounting replica."""
        seen: set[int] = set()
        for e in self.engines:
            store = getattr(e, "page_store", None)
            if store is None or id(store) in seen:
                continue
            seen.add(id(store))
            freed = store.index.invalidate_stale(version)
            if freed:
                log.info("freed %d stale-version prefix page(s)", freed)

    def _skew_check(self) -> None:
        """The version-skew tripwire: warn once while the replicas serve
        more than one version OUTSIDE a rolling swap; re-armed when the
        fleet converges."""
        vs = {getattr(s.engine, "param_version", None)
              for s in self.schedulers}
        vs.discard(None)
        if len(vs) > 1 and self._swap is None:
            if not self._skew_warned:
                self._skew_warned = True
                log.warning(
                    "fleet spans param versions %s outside a rolling "
                    "swap — replicas are serving DIFFERENT weights "
                    "(skew tripwire; re-armed on convergence)",
                    sorted(vs))
        elif len(vs) <= 1:
            self._skew_warned = False

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
            if i in self._version_repair:
                # on rejected weights: the repair lands before any probe
                # or traffic. With health, once the quarantine's backoff
                # lets it (routable() moves quarantine to probation);
                # without, on the tick backoff
                if (h.routable(i) if h is not None else
                        self._ticks >= self._repair_backoff.get(i, (0, 1))[0]):
                    self._retry_version_repair(i)
                continue
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
        self._advance_swap()
        self._skew_check()
        cp.add("cp_bookkeeping", self.clock() - t1)
        if self.events is not None and self._ticks % self.CP_PROFILE_EVERY == 0:
            self._emit("cp_profile", **{f"{name}_total_s":
                                        round(cp.total(name), 6)
                                        for name in CP_PHASES})

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
        self._skew_check()
        out["router_version"] = float(self._version)
        out["router_swaps"] = float(self._swaps)
        out["router_swap_rollbacks"] = float(self._swap_rollbacks)
        out["router_swap_in_progress"] = float(self._swap is not None)
        for i, s in enumerate(self.schedulers):
            v = getattr(s.engine, "param_version", None)
            if v is not None:
                out[f"replica{i}_version"] = float(v)
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
        if self.log_sink is not None:
            out["router_log_sink_records"] = float(
                self.log_sink.stats()["records"])
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
        if self.events is not None:
            out["router_events"] = float(self.events.stats()["events"])
        for i, s in enumerate(self.schedulers):
            st = s.stats()
            for k in _REPLICA_KEYS:
                if k in st:
                    out[f"replica{i}_{k}"] = st[k]
        swap_roll = self._swap_spans.rollup().get("serve_swap")
        if swap_roll is not None:
            out["serve_swap_p50_s"] = swap_roll["p50_s"]
            out["serve_swap_p99_s"] = swap_roll["p99_s"]
        if self.telemetry is not None:
            roll = self.telemetry.spans.rollup().get("router_wait")
            if roll is not None:
                out["router_wait_p50_s"] = roll["p50_s"]
                out["router_wait_p99_s"] = roll["p99_s"]
        return out


def poisson_replay(router, arrivals, *, clock=time.perf_counter,
                   sleep=time.sleep) -> float:
    """:func:`dtf_tpu_torch.serve.client.replay` on a router (the same
    submit / tick / pending surface)."""
    from dtf_tpu_torch.serve.client import replay

    return replay(router, arrivals, clock=clock, sleep=sleep)


__all__ = ["CP_PHASES", "Router", "SwapConfig", "VersionSource",
           "poisson_replay"]
