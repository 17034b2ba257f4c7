"""Replica health — quarantine, probation — and serve-side fault
injection (the port of ``dtf_tpu.serve.health``).

Every replica of a :class:`~dtf_tpu_torch.serve.router.Router` carries a
small state machine::

    healthy ──slow ticks──▶ degraded ──more/worse──▶ quarantined
       ▲                        │                         │
       └──── clean tick ────────┘      probation delay    │
       ▲                                                  ▼
       └──── N clean ticks/probes ◀──────────────── probation

- **healthy / degraded** — routable; a degraded replica (slow ticks)
  loses admission priority but keeps serving.
- **quarantined** — not routable: the router skips it, requeues its
  in-flight requests onto survivors and stops ticking it.
- **probation** — after ``probation_delay_s`` a quarantined replica is
  readmitted on trial (last in routing priority; an idle one is
  exercised by ``DecodeEngine.probe``). ``probation_ticks`` clean ticks
  make it healthy; one slow tick or fault quarantines it again with the
  delay multiplied by ``probation_backoff`` (capped).

A tick is slow when its wall time reaches ``max(min_slow_s, slow_factor
× p99 of the replica's recent healthy ticks)`` — slow ticks stay out of
the baseline, so a wedge cannot raise its own bar; one tick at or past
``wedge_s`` quarantines at once. Host clock arithmetic only (an
injectable ``clock``): the tracker never calls into an engine, so a
wedged device cannot hang its own watchdog. On the card a tick's wall
time includes the decode's readback, so the watchdog sees device time.

:func:`install_serve_fault` arms a ``DTF_FAULT_INJECT`` serve verb on a
live router or scheduler by wrapping engine methods: ``wedge_replica``,
``slow_decode``, ``poison_request``, ``poison_draft`` and the hot-swap's
``wedge_in_swap``; ``corrupt_publish`` wraps a publish watcher;
``corrupt_log_record`` and ``crash_in_log_rotate`` arm the pump's
serve-log sink, ``crash_in_event_rotate`` its event log. With an event
log (``HealthTracker(events=)``), every transition lands on the run's
timeline as ``health_transition``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import time
from typing import Optional

from dtf_tpu_torch.fault.inject import (InjectedCrash, InjectedPoison,
                                        ServeFaultPlan,
                                        corrupt_publish_version)
from dtf_tpu_torch.metrics import quantile

log = logging.getLogger("dtf_tpu_torch")

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
PROBATION = "probation"

#: routing priority per state (the router sorts on it first); quarantined
#: is absent on purpose — it is never a candidate
_RANK = {HEALTHY: 0, DEGRADED: 1, PROBATION: 2}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds of the replica state machine (module docstring)."""

    slow_factor: float = 20.0      # × p99 of recent healthy ticks
    min_slow_s: float = 5.0        # floor under the adaptive bar
    wedge_s: float = 20.0          # one tick this slow → quarantine now
    degrade_after: int = 1         # consecutive slow ticks → degraded
    quarantine_after: int = 3      # consecutive slow ticks → quarantined
    probation_delay_s: float = 10.0
    probation_backoff: float = 2.0   # delay multiplier per failed probation
    probation_delay_max_s: float = 300.0
    probation_ticks: int = 3       # clean ticks/probes to readmit fully
    keep: int = 64                 # healthy-tick baseline window

    def __post_init__(self):
        if not 1 <= self.degrade_after <= self.quarantine_after:
            raise ValueError(
                f"need 1 <= degrade_after ({self.degrade_after}) <= "
                f"quarantine_after ({self.quarantine_after})")
        if self.probation_ticks < 1:
            raise ValueError(
                f"probation_ticks={self.probation_ticks} must be >= 1")
        if self.min_slow_s <= 0 or self.wedge_s < self.min_slow_s:
            raise ValueError(
                f"need 0 < min_slow_s ({self.min_slow_s}) <= wedge_s "
                f"({self.wedge_s})")
        if self.probation_backoff < 1.0:
            raise ValueError(
                f"probation_backoff={self.probation_backoff} must be >= 1 "
                "(a shrinking delay would hammer a dead replica)")


@dataclasses.dataclass
class _Replica:
    state: str = HEALTHY
    strikes: int = 0               # consecutive slow ticks
    ok_probation: int = 0          # clean ticks inside this probation
    since: float = 0.0             # clock() of the last transition
    delay_s: float = 0.0           # current quarantine → probation delay
    last_cause: str = ""
    durations: collections.deque = dataclasses.field(
        default_factory=collections.deque)


class HealthTracker:
    """Per-replica state machines and fleet counters.

    The router feeds it ``note_tick(i, wall_s)`` after every replica tick
    and ``note_fault(i, err)`` on an engine exception, and reads
    ``routable`` / ``rank`` for admission and ``state`` / ``counters`` /
    ``transitions`` for its stats. ``events``: an optional
    :class:`dtf_tpu_torch.telemetry.events.EventLog`."""

    def __init__(self, n_replicas: int, cfg: Optional[HealthConfig] = None,
                 *, clock=time.monotonic, events=None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas={n_replicas} must be >= 1")
        self.cfg = cfg or HealthConfig()
        self.clock = clock
        self.events = events
        self._r = [
            _Replica(delay_s=self.cfg.probation_delay_s,
                     durations=collections.deque(maxlen=self.cfg.keep))
            for _ in range(n_replicas)]
        self.counters = {"quarantines": 0, "slow_ticks": 0, "faults": 0,
                         "probations": 0, "readmits": 0}
        #: the last 100 transitions, newest last, each with its cause
        self.transitions: collections.deque = collections.deque(maxlen=100)

    # ------------------------------------------------------------- verdicts

    def threshold_s(self, i: int) -> float:
        """Replica ``i``'s slow bar, over its recent HEALTHY ticks."""
        slow = quantile(list(self._r[i].durations), 0.99)
        return max(self.cfg.min_slow_s,
                   self.cfg.slow_factor * slow if slow is not None else 0.0)

    def note_tick(self, i: int, dur_s: float) -> Optional[str]:
        """One replica tick of ``dur_s`` wall seconds. Returns the new
        state on a transition (the router requeues on ``QUARANTINED``),
        None otherwise."""
        h = self._r[i]
        cfg = self.cfg
        thresh = self.threshold_s(i)
        if dur_s < thresh:
            h.durations.append(dur_s)
            h.strikes = 0
            if h.state == PROBATION:
                h.ok_probation += 1
                if h.ok_probation >= cfg.probation_ticks:
                    self.counters["readmits"] += 1
                    h.delay_s = cfg.probation_delay_s       # reset backoff
                    return self._transit(
                        i, HEALTHY,
                        f"probation passed ({cfg.probation_ticks} clean)")
            elif h.state == DEGRADED:
                return self._transit(i, HEALTHY, "recovered")
            return None
        self.counters["slow_ticks"] += 1
        h.strikes += 1
        if dur_s >= cfg.wedge_s:
            cause = f"tick {dur_s:.3f}s >= wedge bar {cfg.wedge_s:.3f}s"
        else:
            cause = (f"tick {dur_s:.3f}s >= threshold {thresh:.3f}s "
                     f"(strike {h.strikes})")
        if (h.state == PROBATION or dur_s >= cfg.wedge_s
                or h.strikes >= cfg.quarantine_after):
            return self._quarantine(i, cause)
        if h.strikes >= cfg.degrade_after and h.state == HEALTHY:
            return self._transit(i, DEGRADED, cause)
        return None

    def note_fault(self, i: int, err: BaseException) -> str:
        """An engine exception with no single owning request (the decode
        path): quarantine on the spot."""
        self.counters["faults"] += 1
        if self._r[i].state == QUARANTINED:
            return QUARANTINED
        return self._quarantine(i, f"engine fault: {repr(err)[:120]}")

    def quarantine(self, i: int, cause: str) -> str:
        """A forced quarantine (the router's :meth:`quarantine`)."""
        if self._r[i].state == QUARANTINED:
            return QUARANTINED
        return self._quarantine(i, cause)

    def _quarantine(self, i: int, cause: str) -> str:
        h = self._r[i]
        if h.state == PROBATION:
            # a failed probation multiplies the next wait
            h.delay_s = min(h.delay_s * self.cfg.probation_backoff,
                            self.cfg.probation_delay_max_s)
        h.strikes = 0
        h.ok_probation = 0
        self.counters["quarantines"] += 1
        return self._transit(i, QUARANTINED, cause)

    def _transit(self, i: int, state: str, cause: str) -> str:
        h = self._r[i]
        old, h.state = h.state, state
        h.since = self.clock()
        h.last_cause = cause
        self.transitions.append({"replica": i, "from": old, "to": state,
                                 "cause": cause, "t": round(h.since, 3)})
        if self.events is not None:
            # "at" is the tracker's own (injectable) clock; the log's wall
            # "t" orders the record against the other subsystems' events
            self.events.emit("health_transition", replica=i, state_from=old,
                             state_to=state, cause=cause,
                             at=round(h.since, 6))
        log.warning("serve replica %d: %s -> %s (%s)", i, old, state, cause)
        return state

    # ------------------------------------------------------------- admission

    def routable(self, i: int) -> bool:
        """May the router send replica ``i`` work or tick it? A
        quarantined replica whose delay has passed turns PROBATION here,
        lazily: the tracker needs no thread."""
        h = self._r[i]
        if h.state != QUARANTINED:
            return True
        if self.clock() - h.since >= h.delay_s:
            h.ok_probation = 0
            self.counters["probations"] += 1
            self._transit(i, PROBATION,
                          f"probation after {h.delay_s:.1f}s quarantine")
            return True
        return False

    def rank(self, i: int) -> int:
        """Routing priority (0 best): healthy, degraded, then probation."""
        return _RANK.get(self._r[i].state, 3)

    def state(self, i: int) -> str:
        return self._r[i].state

    def states(self) -> list[str]:
        return [h.state for h in self._r]

    def quarantined_eta_s(self) -> Optional[float]:
        """Seconds until the next quarantined replica reaches probation —
        the retry-after hint of a fully quarantined fleet; None when none
        is quarantined."""
        now = self.clock()
        etas = [max(0.0, h.delay_s - (now - h.since))
                for h in self._r if h.state == QUARANTINED]
        return min(etas) if etas else None


# ---------------------------------------------------------------------------
# Serve-side fault injection.
# ---------------------------------------------------------------------------

#: the verbs install_serve_fault arms
_PORTED_KINDS = ("wedge_replica", "slow_decode", "poison_request",
                "poison_draft", "wedge_in_swap", "corrupt_publish",
                "corrupt_log_record", "crash_in_log_rotate",
                "crash_in_event_rotate")


class ServeFaultState:
    """What an installed plan has done so far (tests assert on it)."""

    def __init__(self, plan: ServeFaultPlan):
        self.plan = plan
        self.fired = False
        self.poison_prompt: Optional[tuple] = None


def _arm_poison_submit(plan, pump, state, note) -> None:
    """Mark the prompt of the pump's ``plan.tick``-th submit (0-based)."""
    orig_submit = pump.submit
    count = [0]

    def submit(req, **kw):
        if count[0] == plan.tick and state.poison_prompt is None:
            state.poison_prompt = tuple(int(t) for t in req.prompt)
            note("poison_armed", submit_index=count[0])
        count[0] += 1
        return orig_submit(req, **kw)

    pump.submit = submit


def install_serve_fault(plan: ServeFaultPlan, pump, *, sleep=time.sleep,
                        wedge_s: Optional[float] = None,
                        slow_s: Optional[float] = None,
                        emit=None, watcher=None) -> ServeFaultState:
    """Arm a serve fault on a live Router or Scheduler (``pump``).

    - ``wedge_replica@N[:replica=k]`` — from the target engine's N-th
      decode call on, every decode sleeps ``wedge_s`` (env
      ``DTF_FAULT_WEDGE_S``, default 0.75) before running: alive but
      useless, what the health watchdog must quarantine.
    - ``slow_decode@N[:replica=k]`` — the same with ``slow_s`` (env
      ``DTF_FAULT_SLOW_S``, default 0.2): degrades without wedging.
    - ``poison_request@N`` — the N-th submit (0-based) is marked; every
      prefill chunk of that prompt raises :class:`InjectedPoison`
      wherever it lands, a requeue included. The scheduler isolates it
      (terminal ``error``) and the replica keeps serving.
    - ``poison_draft@N`` — the N-th submit is marked; while it runs on a
      replica, that replica's ``draft_propose`` raises: the engine falls
      back to null proposals (``draft_fallbacks``).
    - ``wedge_in_swap@N[:replica=k]`` — the target replica's N-th
      ``swap_params`` call (0-based) sleeps ``wedge_s`` then raises
      mid-roll: the router must roll the partial fleet back onto ONE
      version. Fires once.
    - ``corrupt_publish@N`` — needs ``watcher`` (a
      :class:`dtf_tpu_torch.publish.PublishWatcher`): the N-th new
      published version it sees (0-based) is damaged on disk before it
      loads (:func:`~dtf_tpu_torch.fault.inject.corrupt_publish_version`);
      the digest check must skip it with a warning and the fleet keep
      its version. No-op without a watcher.
    - ``corrupt_log_record@N`` — the serve-log sink's N-th record (0-based)
      is written with a damaged CRC: readers skip it.
    - ``crash_in_log_rotate@N`` / ``crash_in_event_rotate@N`` — the sink's
      / the event log's N-th rotation (0-based) raises
      :class:`~dtf_tpu_torch.fault.inject.InjectedCrash` after the shard
      is durable and before the manifest commits: the next sink or log
      over the directory adopts the shard.
    Each sink and the event log are armed once, however many replicas
    share them; with none attached the plan arms nothing.

    Ticks count in the target's own call domain, so a plan is
    deterministic under Poisson timing; ``sleep`` is injectable. Each
    firing first prints one JSON line through ``emit`` (default stdout).

    Over a mesh the plan arms on the leader only (a follower's pump arms
    nothing), and every verb acts there BEFORE the call it disturbs is
    announced (:mod:`dtf_tpu_torch.serve.plane`): the sleeps precede the
    decode call, ``poison_request`` raises before the prefill chunk's,
    ``wedge_in_swap`` before the swap's (no rank swaps that replica),
    ``poison_draft`` through the engine's ``draft_guard`` before the
    decode's (every rank then verifies null proposals), and
    ``corrupt_publish`` damages the version before the leader's load.
    """
    if plan.kind not in _PORTED_KINDS:
        raise NotImplementedError(f"serve fault {plan.kind!r} is not yet "
                                  "ported")
    state = ServeFaultState(plan)
    if not getattr(pump, "is_leader", True):
        return state            # a follower rank runs the leader's calls
    scheds = getattr(pump, "schedulers", None) or [pump]
    _emit = emit or (lambda line: print(line, flush=True))

    def note(what: str, **kw) -> None:
        try:
            _emit(json.dumps({
                "fault_inject": what, "kind": plan.kind, "tick": plan.tick,
                "replica": plan.replica, "pid": os.getpid(), **kw}))
        except Exception:   # noqa: BLE001 — reporting must not alter the
            pass            # scenario under test

    if plan.kind == "poison_request":
        _arm_poison_submit(plan, pump, state, note)
        for s in scheds:
            eng = s.engine
            orig = eng.prefill_chunk_into

            def prefill(slot, prompt, chunk_i, *, _orig=orig, **kw):
                if (state.poison_prompt is not None
                        and tuple(int(t) for t in prompt)
                        == state.poison_prompt):
                    if not state.fired:
                        state.fired = True
                        note("firing")
                    raise InjectedPoison(
                        f"injected poison request (submit #{plan.tick})")
                return _orig(slot, prompt, chunk_i, **kw)

            eng.prefill_chunk_into = prefill
        return state

    if plan.kind == "poison_draft":
        _arm_poison_submit(plan, pump, state, note)
        for s in scheds:
            eng = s.engine
            if not getattr(eng, "spec_k", 0):
                continue            # no draft runs there: the plan no-ops
            # over a mesh the decode call runs the draft inside it, and
            # the leader's guard decides before announcing it
            name = ("draft_guard" if getattr(eng, "mesh", None) is not None
                    else "draft_propose")
            orig = getattr(eng, name)

            def draft(*, _orig=orig, _s=s, **kw):
                if state.poison_prompt is not None and any(
                        tuple(int(t) for t in r.req.prompt)
                        == state.poison_prompt
                        for r in _s._running.values()):
                    if not state.fired:
                        state.fired = True
                        note("firing")
                    raise InjectedPoison(
                        f"injected draft poison (submit #{plan.tick})")
                return _orig(**kw)

            setattr(eng, name, draft)
        return state

    if plan.kind == "wedge_in_swap":
        delay = (wedge_s if wedge_s is not None
                 else float(os.environ.get("DTF_FAULT_WEDGE_S", "0.75")))
        for k, s in enumerate(scheds):
            if plan.replica is not None and plan.replica != k:
                continue
            eng = s.engine
            orig = getattr(eng, "swap_params", None)
            if orig is None:
                continue        # an engine with no swap surface: no-op
            calls = [0]

            def swap(*a, _orig=orig, _calls=calls, _k=k, **kw):
                idx = _calls[0]
                _calls[0] += 1
                if idx == plan.tick and not state.fired:
                    state.fired = True
                    note("firing", on_replica=_k, delay_s=delay)
                    sleep(delay)
                    raise InjectedCrash(
                        f"injected wedge_in_swap on replica {_k} "
                        f"(swap call #{idx})")
                return _orig(*a, **kw)

            eng.swap_params = swap
        return state

    if plan.kind == "corrupt_publish":
        if watcher is None:
            return state        # nothing to arm without a publish watcher
        orig_load = watcher.load_new
        seen: list = []

        def load_new(*, _orig=orig_load):
            m = watcher.poll()
            if m is not None:
                v = int(m["version"])
                if v not in seen:
                    seen.append(v)
                    if len(seen) - 1 == plan.tick and not state.fired:
                        state.fired = True
                        note("firing", version=v)
                        try:
                            corrupt_publish_version(watcher.directory, v)
                        except FileNotFoundError:
                            pass   # raced a prune: nothing to corrupt
            return _orig()

        watcher.load_new = load_new
        return state

    def mark(what: str) -> None:
        state.fired = True
        note(what)

    if plan.kind in ("corrupt_log_record", "crash_in_log_rotate"):
        # a router's replicas share one sink: arm each distinct sink once,
        # counting in its own record / rotation domain
        seen_sinks: set = set()
        for s in scheds:
            sink = getattr(s, "_log_sink", None)
            if sink is None or id(sink) in seen_sinks:
                continue
            seen_sinks.add(id(sink))
            if plan.kind == "corrupt_log_record":
                sink.arm_corrupt(plan.tick, note=mark)
            else:
                sink.arm_crash_rotate(plan.tick, note=mark)
        return state

    if plan.kind == "crash_in_event_rotate":
        events = getattr(pump, "events", None)
        if events is not None:
            events.arm_crash_rotate(plan.tick, note=mark)
        return state

    if plan.kind == "wedge_replica":
        delay = (wedge_s if wedge_s is not None
                 else float(os.environ.get("DTF_FAULT_WEDGE_S", "0.75")))
    else:
        delay = (slow_s if slow_s is not None
                 else float(os.environ.get("DTF_FAULT_SLOW_S", "0.2")))
    for k, s in enumerate(scheds):
        if plan.replica is not None and plan.replica != k:
            continue
        eng = s.engine
        orig = eng.decode
        calls = [0]

        def decode(*, _orig=orig, _calls=calls, _k=k, **kw):
            _calls[0] += 1
            if _calls[0] > plan.tick:
                if not state.fired:
                    state.fired = True
                    note("firing", on_replica=_k, delay_s=delay)
                sleep(delay)
            return _orig(**kw)

        eng.decode = decode
    return state


__all__ = ["DEGRADED", "HEALTHY", "HealthConfig", "HealthTracker",
           "PROBATION", "QUARANTINED", "ServeFaultState",
           "install_serve_fault"]
