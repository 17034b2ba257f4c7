"""In-process serving client, seeded Poisson load generator and heartbeat
(the port of ``dtf_tpu.serve.client``).

``ServeClient`` is the submit/poll surface a caller talks to — it owns a
:class:`~dtf_tpu_torch.serve.scheduler.Scheduler` and pumps it.
``PoissonLoadGen`` produces a reproducible open-loop arrival process
(exponential inter-arrivals, seeded prompt and length draws, numpy's
``default_rng`` as in the reference, so the same seed gives the same
arrivals); :func:`replay` is the one pump loop that feeds it to a
scheduler or to a :class:`~dtf_tpu_torch.serve.router.Router` (the same
``submit`` / ``tick`` / ``pending`` surface). :class:`Heartbeat` prints
periodic JSON snapshots of either's ``stats()``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time
from typing import Iterator, Optional, Sequence

import numpy as np

from dtf_tpu_torch.serve.scheduler import (FAILED_STATUSES, Request,
                                           RequestFailed, Scheduler)

log = logging.getLogger("dtf_tpu_torch")


def replay(scheduler, arrivals, *,
           clock=time.perf_counter, sleep=time.sleep,
           on_tick=None) -> float:
    """Open-loop arrival replay: submit each ``(t_arrival, Request)`` when
    its wall-clock moment comes, tick the scheduler (or router) whenever
    work is pending, and drain. Returns the makespan in seconds; request
    ids are the submit order (callers poll ``scheduler``). ``on_tick``
    (optional, zero-arg) fires after every tick — the :class:`Heartbeat`
    hook point."""
    arrivals = list(arrivals)
    t0 = clock()
    i = 0
    while i < len(arrivals) or scheduler.pending:
        now = clock() - t0
        while i < len(arrivals) and arrivals[i][0] <= now:
            scheduler.submit(arrivals[i][1])
            i += 1
        if scheduler.pending:
            scheduler.tick()
            if on_tick is not None:
                on_tick()
        elif i < len(arrivals):
            sleep(min(arrivals[i][0] - now, 0.05))
    return clock() - t0


#: heartbeat snapshot keys, in emit order — the operator's at-a-glance
#: panel (everything else stays in the final stats() line)
_HEARTBEAT_KEYS = ("serve_completed", "serve_queue_depth",
                   "serve_occupancy", "serve_ttft_p50_s",
                   "serve_ttft_p99_s", "serve_ttft_slo_ok_frac",
                   "serve_shed", "serve_timeouts",
                   "router_completed", "router_queue_depth",
                   "router_occupancy", "router_ttft_p50_s",
                   "router_ttft_p99_s", "router_ttft_slo_ok_frac",
                   "router_shed", "router_timeouts", "router_requeued",
                   "router_quarantines", "router_version",
                   "router_swaps", "router_swap_rollbacks",
                   "router_swap_in_progress")


class Heartbeat:
    """Periodic one-line JSON liveness snapshots of a running scheduler or
    router.

    Call :meth:`maybe_emit` after every tick (``replay``'s ``on_tick``):
    every ``every_ticks`` ticks it emits one ``{"serve_heartbeat": ...}``
    line through ``emit`` (default: stderr — stdout's last line stays the
    launcher's one metrics line) with the ``stats()`` panel, a router's
    ``replica{i}_*`` keys included. With ``slo_floor > 0``, a TTFT SLO-ok
    fraction under the floor logs one WARNING an excursion, per key: the
    fleet's (or the scheduler's) and each replica's, each re-armed when it
    recovers; every excursion is counted and the worst fleet fraction
    kept, so :meth:`stats` can put them in the launcher's final line.
    With ``events`` (an :class:`~dtf_tpu_torch.telemetry.events.EventLog`)
    each excursion lands on the run's timeline as a pair of
    ``slo_excursion`` records (``edge`` enter / exit, with their ticks);
    with ``flight`` (a :class:`~dtf_tpu_torch.telemetry.flight.
    FlightRecorder`) each emit also writes the heartbeat file with a
    ``serve`` summary. Host arithmetic only."""

    def __init__(self, sched, *, every_ticks: int, slo_floor: float = 0.0,
                 emit=None, clock=time.monotonic, flight=None, events=None):
        if every_ticks < 1:
            raise ValueError(f"every_ticks={every_ticks} must be >= 1")
        self.sched = sched
        self.every_ticks = every_ticks
        self.slo_floor = slo_floor
        self.emit = emit or (lambda line: print(line, file=sys.stderr))
        self.clock = clock
        self.flight = flight
        self.events = events
        self._t0 = clock()
        self._ticks = 0
        self.emitted = 0
        self.excursions = 0
        self.replica_excursions = 0
        self.worst_ok_frac: Optional[float] = None
        #: open excursions by key ("fleet", "replica{i}"): the tick and
        #: the fraction they began at
        self._episodes: dict = {}

    def snapshot(self) -> dict:
        stats = self.sched.stats()
        snap = {"serve_heartbeat": self.emitted,
                "t_s": round(self.clock() - self._t0, 3)}
        for k in _HEARTBEAT_KEYS:
            if k in stats:
                snap[k] = (round(v, 6) if isinstance(v := stats[k], float)
                           else v)
        for k, v in stats.items():          # a router's replica panel
            if k.startswith("replica"):
                snap[k] = round(v, 6) if isinstance(v, float) else v
        return snap

    def maybe_emit(self) -> Optional[dict]:
        self._ticks += 1
        if self._ticks % self.every_ticks:
            return None
        snap = self.snapshot()
        self.emitted += 1
        self.emit(json.dumps(snap))
        ok = next((snap[k] for k in ("router_ttft_slo_ok_frac",
                                     "serve_ttft_slo_ok_frac")
                   if k in snap), None)
        if ok is not None:
            self.worst_ok_frac = (ok if self.worst_ok_frac is None
                                  else min(self.worst_ok_frac, ok))
        if self.slo_floor > 0.0:
            fracs = {} if ok is None else {"fleet": ok}
            suffix = "_serve_ttft_slo_ok_frac"
            fracs.update((k[:-len(suffix)], v) for k, v in snap.items()
                         if k.startswith("replica") and k.endswith(suffix))
            for key, frac in fracs.items():
                ep = self._episodes.get(key)
                if frac < self.slo_floor and ep is None:
                    self._episodes[key] = {"tick": self._ticks, "ok": frac}
                    if key == "fleet":
                        self.excursions += 1
                        log.warning(
                            "TTFT SLO compliance %.3f below the %.3f floor "
                            "(p99 %.4fs; excursion %d)", frac,
                            self.slo_floor,
                            snap.get("router_ttft_p99_s",
                                     snap.get("serve_ttft_p99_s")) or 0.0,
                            self.excursions)
                    else:
                        self.replica_excursions += 1
                        log.warning(
                            "%s TTFT SLO compliance %.3f below the %.3f "
                            "floor", key, frac, self.slo_floor)
                    if self.events is not None:
                        self.events.emit(
                            "slo_excursion", edge="enter", key=key,
                            ok_frac=round(frac, 6), tick=self._ticks)
                elif frac >= self.slo_floor and ep is not None:
                    del self._episodes[key]
                    if self.events is not None:
                        self.events.emit(
                            "slo_excursion", edge="exit", key=key,
                            ok_frac=round(frac, 6), tick=self._ticks,
                            entered_tick=ep["tick"],
                            ticks=self._ticks - ep["tick"])
        if self.flight is not None:
            # the liveness file a watcher polls, with the serve panel
            serve = {k: snap[k] for k in
                     ("serve_completed", "serve_queue_depth",
                      "router_completed", "router_queue_depth",
                      "router_quarantines", "router_version",
                      "router_swaps", "router_swap_rollbacks")
                     if k in snap}
            versions = {k: snap[k] for k in snap
                        if k.startswith("replica") and k.endswith("_version")}
            if versions:
                serve["replica_versions"] = versions
            self.flight.write_heartbeat(extra={"serve": serve})
        return snap

    def stats(self) -> dict:
        """SLO-excursion aggregates for the launcher's final JSON line: how
        often compliance dipped below the floor and how bad the worst dip
        was (a breach-and-recover run must not look clean)."""
        out = {"heartbeats": float(self.emitted),
               "slo_excursions": float(self.excursions),
               "replica_slo_excursions": float(self.replica_excursions)}
        if self.worst_ok_frac is not None:
            out["worst_ttft_slo_ok_frac"] = round(self.worst_ok_frac, 6)
        return out


class ServeClient:
    """Submit/poll API over an engine. ``submit`` returns a request id;
    ``result`` blocks (pumping the scheduler) until that request is done."""

    def __init__(self, engine, writer=None, **scheduler_kw):
        self.scheduler = Scheduler(engine, writer, **scheduler_kw)

    def submit(self, prompt: Sequence[int], *, max_new: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_id: Optional[int] = None, pad_id: int = 0,
               seed: int = 0) -> int:
        return self.scheduler.submit(Request(
            prompt=list(prompt), max_new=max_new, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_id=eos_id, pad_id=pad_id,
            seed=seed))

    def poll(self, rid: int) -> dict:
        return self.scheduler.poll(rid)

    def step(self) -> None:
        self.scheduler.tick()

    def result(self, rid: int, max_ticks: int = 100000) -> list[int]:
        """Generated tokens of ``rid`` (pumps the scheduler until done).
        A shed/timed-out/errored request raises :class:`RequestFailed`
        at once."""
        for _ in range(max_ticks):
            st = self.poll(rid)
            if st["status"] == "done":
                return st["tokens"]
            if st["status"] in FAILED_STATUSES:
                raise RequestFailed(rid, st)
            self.scheduler.tick()
        raise RuntimeError(f"request {rid} not done after {max_ticks} ticks")

    def drain(self) -> None:
        self.scheduler.run_until_idle()

    def stats(self) -> dict:
        return self.scheduler.stats()


@dataclasses.dataclass(frozen=True)
class PoissonLoadGen:
    """Seeded open-loop load: ``arrivals()`` yields ``(t_arrival, Request)``
    with Exp(rate) inter-arrival gaps, prompts of uniform random length in
    ``[prompt_min, prompt_max]`` over ``vocab_size`` tokens, and ``max_new``
    uniform in ``[new_min, new_max]``; request i samples with seed
    ``seed + i``. Deterministic per seed, and the reference's arrivals for
    the same seed."""

    rate: float                       # requests per second
    n_requests: int
    vocab_size: int
    prompt_min: int = 4
    prompt_max: int = 64
    new_min: int = 8
    new_max: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        # fail at construction, not mid-replay inside numpy
        if self.rate <= 0:
            raise ValueError(f"rate={self.rate} must be > 0")
        if not 1 <= self.prompt_min <= self.prompt_max:
            raise ValueError(
                f"need 1 <= prompt_min ({self.prompt_min}) <= prompt_max "
                f"({self.prompt_max})")
        if not 1 <= self.new_min <= self.new_max:
            raise ValueError(
                f"need 1 <= new_min ({self.new_min}) <= new_max "
                f"({self.new_max})")

    def arrivals(self) -> Iterator[tuple[float, Request]]:
        rng = np.random.default_rng(self.seed)
        t = 0.0
        for i in range(self.n_requests):
            t += float(rng.exponential(1.0 / self.rate))
            n_p = int(rng.integers(self.prompt_min, self.prompt_max + 1))
            prompt = rng.integers(0, self.vocab_size, n_p).tolist()
            yield t, Request(
                prompt=prompt,
                max_new=int(rng.integers(self.new_min, self.new_max + 1)),
                temperature=self.temperature, top_k=self.top_k,
                top_p=self.top_p, eos_id=self.eos_id, seed=self.seed + i)
