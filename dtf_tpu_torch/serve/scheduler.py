"""Request scheduling over a :class:`~dtf_tpu_torch.serve.engine.DecodeEngine`
(the port of ``dtf_tpu.serve.scheduler``).

FIFO admission with prefill/decode interleave: each :meth:`Scheduler.tick`
runs at most ``prefill_chunks_per_tick`` prompt chunks (admitting queued
requests into free slots as the chunk budget allows — a long prompt
spreads its prefill over several ticks instead of stalling everyone's
decode), then one ``decode_all`` step for every occupied slot. Slots are
evicted on EOS, on ``max_new``, or when the slot's ``max_len`` budget
fills; the freed slot is reusable the next tick — the continuous-batching
loop.

Requests can end in a terminal status other than ``done``:

- ``shed`` — bounded-queue admission control (``max_queue``): an
  over-full queue rejects at submit with a ``retry_after_s`` hint;
- ``timeout`` — per-request deadlines (``Request.ttft_deadline_s`` /
  ``deadline_s``, measured from submit on the scheduler clock) evict at
  the next tick, whether the request is queued, mid-prefill or decoding;
- ``error`` — an engine exception during ADMISSION fails the admitting
  request only; decode-path exceptions have no single owner and
  propagate.

With a prefix page pool (``engine.prefix_match``) admission first looks
the prompt up: a hit pins a page chain, loads it into the slot for one
unit of the chunk budget and prefills only the rest; after the last
chunk the request's new full pages are saved, and the chain is released
when the slot is (done, timeout or error alike). With a speculative
engine (``spec_k`` > 0) a decode tick delivers ``tokens[s, :n_emit[s]]``
to each running slot in order, until its eos or budget — the tokens
``n_emit`` plain ticks would have delivered — and counts the proposals
made and accepted, per request and per param version.

Behind a :class:`~dtf_tpu_torch.serve.router.Router` a decode-path
exception goes to the router's health machinery, which quarantines the
replica and drains it: :meth:`Scheduler.evict_for_requeue` hands every
in-flight request back in submit order (status ``requeued`` here, their
prefix pins released), and the survivor's :meth:`Scheduler.submit`
takes each with its fleet id, its original submit time and
``requeued=True``.

``poll`` reports the terminal status (and its hint or cause);
:class:`RequestFailed` is what ``ServeClient.result`` raises on one.
``stats()`` gives TTFT and per-token latency p50/p99, occupancy, queue
peak, the requeue counts, the TTFT SLO fraction, the speculative accept
rate and the page pool's aggregates — host arithmetic only, no device
readback.

The run-record plane, host arithmetic only (no device readback, no
token changed): ``telemetry=`` (:class:`dtf_tpu_torch.telemetry.run.
Telemetry`) times every engine call in a phase span (``serve_prefill_
chunk``, ``serve_page_load``, ``serve_page_save``, ``serve_decode``,
and the queue wait ``router_wait``) and, with a tracer attached, records
each request's ``queue_wait`` and ``request`` slices and the engine-call
slices, tagged with its trace id; standalone, it registers the
scheduler's postmortem provider. ``log_sink=`` (:class:`dtf_tpu_torch.
serve.logsink.LogSink`) records every ``done`` request. An engine that
sets ``annotate_traces`` gets the trace ids in its step calls.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Optional, Sequence

from dtf_tpu_torch.metrics import quantile as _quantile

log = logging.getLogger("dtf_tpu_torch")

#: terminal statuses that are NOT success — ``result()`` raises
#: :class:`RequestFailed` on sight instead of pumping to tick exhaustion.
FAILED_STATUSES = ("shed", "timeout", "error")


class RequestFailed(RuntimeError):
    """A request ended in a terminal non-success status (``shed`` /
    ``timeout`` / ``error``). Carries the ``poll()`` payload so callers
    can honor ``retry_after_s`` without a second lookup."""

    def __init__(self, rid: int, info: dict):
        self.rid = rid
        self.status = info.get("status", "?")
        self.info = dict(info)
        hint = ""
        if "retry_after_s" in info:
            hint = f" (retry after {info['retry_after_s']}s)"
        elif info.get("timeout_kind"):
            hint = f" ({info['timeout_kind']} deadline)"
        elif info.get("error"):
            hint = f" ({info['error']})"
        super().__init__(f"request {rid} terminally {self.status}{hint}")


@dataclasses.dataclass(frozen=True)
class Request:
    """One decode request. Sampling fields mirror ``gpt.generate``;
    the deadline fields are client promises measured from submit on the
    scheduler's clock (0 = none): ``ttft_deadline_s`` bounds the wait for
    the FIRST token, ``deadline_s`` the whole request."""

    prompt: Sequence[int]
    max_new: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    pad_id: int = 0
    seed: int = 0
    ttft_deadline_s: float = 0.0
    deadline_s: float = 0.0


@dataclasses.dataclass
class _Rec:
    rid: int
    req: Request
    #: queued | prefill | running | done | shed | timeout | error |
    #: requeued (drained off a quarantined replica)
    status: str = "queued"
    slot: int = -1
    chunks_done: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    submit_t: float = 0.0
    #: None until the first token lands — NOT 0.0: an injected test clock
    #: legitimately stamps first tokens at t == 0.0
    first_token_t: Optional[float] = None
    #: TTFT in this scheduler's ticks (each replica's own clock: replicas
    #: sharing one pump share its wall time)
    submit_tick: int = 0
    first_token_tick: Optional[int] = None
    #: the request's fleet-wide id behind a router (the local rid alone)
    trace_id: int = -1
    #: readmitted off a quarantined replica
    requeued: bool = False
    finish_t: float = 0.0
    retry_after_s: float = 0.0        # shed hint (poll surfaces it)
    timeout_kind: str = ""            # "ttft" | "total" on timeout
    error: str = ""                   # admission-failure cause on error
    #: the engine's param version at completion
    version: Optional[int] = None
    #: the pinned prefix-page chain (engine.prefix_match) and the pages
    #: loaded from it; released when the slot is
    handle: object = None
    pages_loaded: int = 0
    #: speculative accounting: proposals made for this request and how
    #: many the verifier accepted
    proposed: int = 0
    accepted: int = 0
    #: the submit moment on the tracer's clock (chrome ``ts``)
    submit_us: float = 0.0


class Scheduler:
    """FIFO continuous-batching scheduler (see module docstring).

    ``prefill_chunks_per_tick`` bounds how much prefill work may delay the
    next decode step (0 = admit greedily, the whole queue's worth a tick).
    ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, engine, writer=None, *, log_every: int = 0,
                 prefill_chunks_per_tick: int = 4, clock=time.monotonic,
                 completed_cap: int = 100_000, telemetry=None,
                 ttft_slo_s: float = 0.0, max_queue: int = 0,
                 shed_retry_after_s: float = 0.25,
                 postmortem_name: Optional[str] = "serve_scheduler",
                 log_sink=None, replica_index: int = 0):
        self.engine = engine
        self.writer = writer
        #: the serve-log sink: one record a ``done`` request (a router
        #: hands every replica the same sink)
        self._log_sink = log_sink
        self.telemetry = telemetry
        if telemetry is not None and postmortem_name:
            # a router registers one provider for the fleet instead
            # (postmortem_name None for its replicas)
            telemetry.add_postmortem_provider(postmortem_name,
                                              self.postmortem_state)
        #: this scheduler's replica behind a router (0 alone)
        self.replica_index = int(replica_index)
        self.log_every = log_every
        #: TTFT service-level objective (0 = untracked): ``stats()`` then
        #: reports the fraction of completed first tokens inside it
        self.ttft_slo_s = ttft_slo_s
        if prefill_chunks_per_tick < 0:
            raise ValueError(
                f"prefill_chunks_per_tick={prefill_chunks_per_tick} must "
                "be >= 0 (0 = admit greedily)")
        self.prefill_chunks_per_tick = prefill_chunks_per_tick
        self.clock = clock
        if max_queue < 0:
            raise ValueError(f"max_queue={max_queue} must be >= 0 "
                             "(0 = unbounded)")
        self.max_queue = max_queue
        self.shed_retry_after_s = shed_retry_after_s
        #: completed records (and latency samples) retained for poll();
        #: beyond the cap the OLDEST finished request is forgotten, so a
        #: long-running server does not grow host memory per request
        self.completed_cap = completed_cap
        self._free = list(range(engine.n_slots))
        self._queue: collections.deque[_Rec] = collections.deque()
        self._admitting: Optional[_Rec] = None
        self._running: dict[int, _Rec] = {}
        self._recs: dict[int, _Rec] = {}
        self._done_order: collections.deque[int] = collections.deque()
        self._next_id = 0
        self._tick = 0
        self._ttfts: collections.deque[float] = collections.deque(
            maxlen=completed_cap)
        #: the count of TTFT samples ever recorded (the deque is bounded,
        #: so its length stops moving: the router's canary gate counts
        #: "samples since a mark" on this), and beside each sample whether
        #: its request was requeued (its TTFT includes time lost on
        #: another replica, which the gate must not blame on new weights)
        self._ttft_count = 0
        self._ttft_requeued: collections.deque[bool] = collections.deque(
            maxlen=completed_cap)
        self._tok_lats: collections.deque[float] = collections.deque(
            maxlen=completed_cap)
        self._completed = 0
        self._occupancy_sum = 0.0
        self._queue_peak = 0
        self._shed = 0
        self._timeouts = 0
        self._timeouts_ttft = 0
        self._request_errors = 0
        self._requeued_out = 0
        self._requeued_in = 0
        # deadline sweeps only run once a deadlined request has been seen
        self._any_deadlines = False
        self._spec_proposed = 0
        self._spec_accepted = 0
        #: speculative counts by the param version that served them:
        #: {version: [proposed, accepted]}
        self._accept_by_version: dict[int, list] = {}

    # ----------------------------------------------------------- submit/poll

    def submit(self, req: Request, *, trace_id: Optional[int] = None,
               submit_t: Optional[float] = None,
               requeued: bool = False) -> int:
        """Accept a request; returns its local id. A router passes its
        fleet-wide id as ``trace_id``; its requeue path also passes the
        request's ORIGINAL ``submit_t`` and ``requeued=True``, so TTFT and
        the deadlines include the time lost on the quarantined replica."""
        if not 1 <= len(req.prompt) <= self.engine.max_len - 1:
            raise ValueError(
                f"prompt length {len(req.prompt)} must be in "
                f"[1, {self.engine.max_len - 1}]")
        if req.max_new < 1:
            raise ValueError(f"max_new={req.max_new} must be >= 1")
        rid = self._next_id
        self._next_id += 1
        rec = _Rec(rid, req, requeued=requeued,
                   submit_t=self.clock() if submit_t is None else submit_t,
                   submit_tick=self._tick,
                   trace_id=rid if trace_id is None else trace_id)
        tracer = self._tracer()
        if tracer is not None:
            rec.submit_us = tracer.now_us()
        self._recs[rid] = rec
        if requeued:
            self._requeued_in += 1
        if req.ttft_deadline_s > 0 or req.deadline_s > 0:
            self._any_deadlines = True
        if self.max_queue and len(self._queue) >= self.max_queue:
            # admission control: shed NOW with an honest hint instead of
            # joining a line that already guarantees a deadline miss
            rec.status = "shed"
            rec.retry_after_s = round(
                self.shed_retry_after_s
                * (1 + len(self._queue) / self.max_queue), 6)
            self._shed += 1
            self._remember_done(rec)
            return rid
        self._queue.append(rec)
        self._queue_peak = max(self._queue_peak, len(self._queue))
        return rid

    def poll(self, rid: int) -> dict:
        rec = self._recs[rid]
        out = {"status": rec.status, "tokens": list(rec.tokens)}
        if rec.version is not None:
            out["version"] = rec.version
        if rec.status == "shed":
            out["retry_after_s"] = rec.retry_after_s
        elif rec.status == "timeout":
            out["timeout_kind"] = rec.timeout_kind
        elif rec.status == "error":
            out["error"] = rec.error
        return out

    @property
    def pending(self) -> int:
        """Requests not yet finished (queued + prefilling + running)."""
        return (len(self._queue) + (self._admitting is not None)
                + len(self._running))

    # ------------------------------------------------------------------ tick

    def tick(self) -> None:
        """One scheduling round: deadline sweep, bounded prefill, then one
        decode step."""
        self._tick += 1
        if self._any_deadlines:
            self._sweep_deadlines()
        budget = self.prefill_chunks_per_tick or 10 ** 9
        while budget > 0:
            if self._admitting is None:
                if not (self._queue and self._free):
                    break
                rec = self._queue.popleft()
                rec.slot = self._free.pop(0)
                rec.status = "prefill"
                self._admitting = rec
                if self.telemetry is not None:
                    self.telemetry.spans.add(
                        "router_wait", self.clock() - rec.submit_t)
                    tracer = self._tracer()
                    if tracer is not None:
                        tracer.complete(
                            "queue_wait", cat="request", tid=rec.trace_id,
                            t0_us=rec.submit_us, t1_us=tracer.now_us(),
                            args={"slot": rec.slot})
                # the prefix-page lookup (None with the pool off): the
                # pinned chain loads below, on the same budget
                pm = getattr(self.engine, "prefix_match", None)
                if pm is not None:
                    rec.handle = pm(rec.req.prompt)
            rec = self._admitting
            r = rec.req
            try:
                if rec.handle is not None and not rec.pages_loaded:
                    # the whole chain in ONE page-load step, for one unit
                    # of budget (so admission cannot starve decode); the
                    # load deactivates the slot first
                    self._timed("serve_page_load", self.engine.load_prefix,
                                rec.slot, rec.handle, tid=rec.trace_id)
                    rec.pages_loaded = len(rec.handle.entries)
                    budget -= 1
                    continue
                start = rec.handle.n_tokens if rec.handle is not None else 0
                # the trace id reaches the engine only when it annotates
                ekw = ({"trace_id": rec.trace_id}
                       if getattr(self.engine, "annotate_traces", False)
                       else {})
                out = self._timed(
                    "serve_prefill_chunk", self.engine.prefill_chunk_into,
                    rec.slot, r.prompt, rec.chunks_done, start=start,
                    temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
                    eos_id=r.eos_id, pad_id=r.pad_id, seed=r.seed,
                    tid=rec.trace_id,
                    targs={"slot": rec.slot, "chunk": rec.chunks_done},
                    **ekw)
            except Exception as e:  # noqa: BLE001 — an ADMISSION failure
                # has exactly one owner: fail that request terminally and
                # keep serving. Decode-path exceptions below have no
                # single owner and propagate.
                self._fail(rec, e)
                budget -= 1
                continue
            rec.chunks_done += 1
            budget -= 1
            if out is not None:                      # last chunk: tok0
                tok, done = out
                save = getattr(self.engine, "save_prefix_pages", None)
                if save is not None:
                    try:
                        self._timed("serve_page_save", save, rec.slot,
                                    r.prompt, tid=rec.trace_id)
                    except Exception as e:  # noqa: BLE001 — same owner
                        self._fail(rec, e)
                        continue
                rec.first_token_t = self.clock()
                rec.first_token_tick = self._tick
                rec.tokens.append(tok)
                self._admitting = None
                self._ttfts.append(rec.first_token_t - rec.submit_t)
                self._ttft_requeued.append(rec.requeued)
                self._ttft_count += 1
                if done or self._budget_spent(rec):
                    self._finish(rec)
                else:
                    rec.status = "running"
                    self._running[rec.slot] = rec

        if self._running:
            if self.telemetry is None \
                    and not getattr(self.engine, "annotate_traces", False):
                # the hot loop with the plane off: no id list a tick
                out = self.engine.decode()
            else:
                active = [r.trace_id for r in self._running.values()]
                ekw = ({"trace_ids": active}
                       if getattr(self.engine, "annotate_traces", False)
                       else {})
                out = self._timed("serve_decode", self.engine.decode,
                                  targs={"trace_ids": active}, **ekw)
            now = self.clock()
            spec_k = getattr(self.engine, "spec_k", 0)
            if spec_k:
                # up to k + 1 tokens a slot, delivered in order until the
                # row's eos or budget: what n_emit plain ticks deliver
                toks, dones, n_emit = out
                ver = int(getattr(self.engine, "param_version", 0) or 0)
                bucket = self._accept_by_version.setdefault(ver, [0, 0])
                for slot, rec in list(self._running.items()):
                    n = int(n_emit[slot])
                    self._spec_proposed += spec_k
                    self._spec_accepted += n - 1
                    rec.proposed += spec_k
                    rec.accepted += n - 1
                    bucket[0] += spec_k
                    bucket[1] += n - 1
                    for j in range(n):
                        rec.tokens.append(int(toks[slot, j]))
                        if bool(dones[slot, j]) or self._budget_spent(rec):
                            rec.finish_t = now
                            self._finish(rec)
                            break
            else:
                toks, dones = out
                for slot, rec in list(self._running.items()):
                    rec.tokens.append(int(toks[slot]))
                    if bool(dones[slot]) or self._budget_spent(rec):
                        rec.finish_t = now
                        self._finish(rec)
        self._occupancy_sum += self._occupancy()

        if (self.writer is not None and self.log_every
                and self._tick % self.log_every == 0):
            self.writer.write_scalars(self._tick, self.stats(brief=True))

    def run_until_idle(self, max_ticks: int = 100000, *,
                       on_tick=None) -> None:
        """Drain the queue. ``on_tick`` (zero-arg, optional) fires after
        every tick — the heartbeat hook point, shared with replay()."""
        for _ in range(max_ticks):
            if not self.pending:
                return
            self.tick()
            if on_tick is not None:
                on_tick()
        raise RuntimeError(f"requests still pending after {max_ticks} ticks")

    def release(self, rid: int) -> None:
        """Drop a completed request's record (tokens included) — call after
        consuming the result to keep a long-running server's host memory
        flat without relying on the completed_cap backstop."""
        rec = self._recs.get(rid)
        if rec is not None and rec.status == "done":
            self._recs.pop(rid, None)

    # ------------------------------------------------------------- internals

    def _tracer(self):
        """The run's TraceCollector, if the telemetry has one."""
        return getattr(self.telemetry, "tracer", None)

    def _timed(self, name, fn, *args, tid=None, targs=None, **kwargs):
        """An engine call in a telemetry phase span (a plain call without
        telemetry); with a tracer, also one chrome slice tagged ``tid``
        (the shared ``engine`` track for decode steps). Host clock
        arithmetic only."""
        if self.telemetry is None:
            return fn(*args, **kwargs)
        tracer = self._tracer()
        if tracer is None:
            with self.telemetry.spans.span(name):
                return fn(*args, **kwargs)
        t0 = tracer.now_us()
        try:
            with self.telemetry.spans.span(name):
                return fn(*args, **kwargs)
        finally:
            tracer.complete(name, cat="engine",
                            tid="engine" if tid is None else tid,
                            t0_us=t0, t1_us=tracer.now_us(), args=targs)

    def _budget_spent(self, rec: _Rec) -> bool:
        used = len(rec.req.prompt) + len(rec.tokens)
        return (len(rec.tokens) >= rec.req.max_new
                or used >= self.engine.max_len)

    def _occupancy(self) -> float:
        return 1.0 - len(self._free) / self.engine.n_slots

    @property
    def occupancy(self) -> float:
        """The occupied share of the slots (prefilling ones included) —
        the router's admission signal."""
        return self._occupancy()

    @property
    def ttft_count(self) -> int:
        """TTFT samples ever recorded (monotone)."""
        return self._ttft_count

    @property
    def queue_depth(self) -> int:
        """Requests accepted but not in a slot yet — the router's
        tiebreak."""
        return len(self._queue) + (self._admitting is not None)

    def _finish(self, rec: _Rec) -> None:
        rec.finish_t = rec.finish_t or self.clock()
        if len(rec.tokens) > 1:
            self._tok_lats.append((rec.finish_t - rec.first_token_t)
                                  / (len(rec.tokens) - 1))
        self._completed += 1
        self._retire(rec, "done")

    def _retire(self, rec: _Rec, status: str,
                now: Optional[float] = None) -> None:
        """Shared terminal bookkeeping for done/shed/timeout/error: stamp
        the status, record a done request in the sink, emit the request's
        trace slice, free the slot (if the request held one) and enter the
        bounded retention window."""
        rec.status = status
        rec.finish_t = rec.finish_t or (self.clock() if now is None else now)
        if status == "done":
            rec.version = getattr(self.engine, "param_version", None)
            if self._log_sink is not None:
                # host facts only: the token ints crossed in tick()
                self._log_sink.record({
                    "rid": rec.trace_id if rec.trace_id >= 0 else rec.rid,
                    "replica": self.replica_index,
                    "version": rec.version,
                    "status": status,
                    "prompt": [int(t) for t in rec.req.prompt],
                    "tokens": list(rec.tokens),
                    "ttft_s": round(rec.first_token_t - rec.submit_t, 6)
                    if rec.first_token_t is not None else None,
                    "latency_s": round(rec.finish_t - rec.submit_t, 6),
                    "proposed": rec.proposed,
                    "accepted": rec.accepted,
                })
        tracer = self._tracer()
        if tracer is not None:
            # the whole lifecycle as one slice on the request's track
            args = {"rid": rec.rid, "status": status,
                    "prompt_len": len(rec.req.prompt),
                    "tokens": len(rec.tokens)}
            if rec.first_token_t is not None:
                args["ttft_s"] = round(rec.first_token_t - rec.submit_t, 6)
            tracer.complete("request", cat="request", tid=rec.trace_id,
                            t0_us=rec.submit_us, t1_us=tracer.now_us(),
                            args=args)
        if rec.handle is not None:       # the chain's pin goes with the slot
            self.engine.release_prefix(rec.handle)
            rec.handle = None
        if rec.slot >= 0:
            self._running.pop(rec.slot, None)
            self._free.append(rec.slot)
            self._free.sort()
            rec.slot = -1
        self._remember_done(rec)

    def _remember_done(self, rec: _Rec) -> None:
        self._done_order.append(rec.rid)
        while len(self._done_order) > self.completed_cap:
            self._recs.pop(self._done_order.popleft(), None)

    def _fail(self, rec: _Rec, e: BaseException) -> None:
        """An admission-path engine failure owned by ``rec``: fail it
        terminally (status ``error``) and keep serving. The device slot
        needs no cleanup: a half-prefilled slot is stale state the next
        admission fully resets."""
        self._request_errors += 1
        rec.error = repr(e)[:200]
        log.warning("request %d failed in admission: %s",
                    rec.rid, rec.error)
        if self._admitting is rec:
            self._admitting = None
        self._retire(rec, "error")

    def _timeout(self, rec: _Rec, kind: str, now: float) -> None:
        self._timeouts += 1
        if kind == "ttft":
            self._timeouts_ttft += 1
        rec.timeout_kind = kind
        self._retire(rec, "timeout", now)

    def _deadline_kind(self, rec: _Rec, now: float) -> Optional[str]:
        r = rec.req
        waited = now - rec.submit_t
        if (r.ttft_deadline_s > 0 and rec.first_token_t is None
                and waited >= r.ttft_deadline_s):
            return "ttft"
        if r.deadline_s > 0 and waited >= r.deadline_s:
            return "total"
        return None

    def _sweep_deadlines(self) -> None:
        """Evict every request past its deadline — queued, mid-prefill or
        decoding alike (the freed slot is reusable this same tick)."""
        now = self.clock()
        for rec in [rec for rec in self._queue
                    if self._deadline_kind(rec, now)]:
            self._queue.remove(rec)
            self._timeout(rec, self._deadline_kind(rec, now), now)
        rec = self._admitting
        if rec is not None:
            kind = self._deadline_kind(rec, now)
            if kind:
                self._admitting = None
                self._timeout(rec, kind, now)
        for rec in list(self._running.values()):
            kind = self._deadline_kind(rec, now)
            if kind:
                self._timeout(rec, kind, now)

    # ------------------------------------------------------ quarantine drain

    def evict_for_requeue(self) -> list:
        """Vacate every in-flight request (queued, admitting, running) for
        readmission elsewhere — the router's quarantine drain. Returns the
        records in SUBMIT order, marked ``requeued`` here; their prefix
        pins are released (host index work, safe against a wedged
        engine), their tokens cleared (the survivor regenerates the whole
        stream) and every slot freed. The device state needs no touch: a
        stale slot is a masked spectator until an admission resets it."""
        recs = list(self._queue)
        if self._admitting is not None:
            recs.append(self._admitting)
        recs += list(self._running.values())
        recs.sort(key=lambda r: r.rid)
        self._queue.clear()
        self._admitting = None
        self._running.clear()
        self._free = list(range(self.engine.n_slots))
        for rec in recs:
            if rec.handle is not None:
                try:
                    self.engine.release_prefix(rec.handle)
                except Exception:  # noqa: BLE001 — draining a broken
                    pass           # replica must not fail the requeue
                rec.handle = None
            rec.pages_loaded = 0
            rec.slot = -1
            rec.tokens = []
            rec.proposed = 0
            rec.accepted = 0
            rec.status = "requeued"
            self._requeued_out += 1
        return recs

    def postmortem_state(self) -> dict:
        """In-flight request ids and slot ages — host clocks and counters
        only, no device call (it is read when the device may be wedged)."""
        now = self.clock()
        in_flight, slot_ages = [], {}
        recs = list(self._queue)
        if self._admitting is not None:
            recs.append(self._admitting)
        recs += list(self._running.values())
        for rec in recs:
            in_flight.append({
                "rid": rec.rid, "trace_id": rec.trace_id,
                "status": rec.status, "slot": rec.slot,
                "age_s": round(now - rec.submit_t, 3),
                "tokens": len(rec.tokens)})
            if rec.slot >= 0:
                slot_ages[str(rec.slot)] = round(now - rec.submit_t, 3)
        return {"in_flight": in_flight,
                "queue_depth": len(self._queue),
                "occupancy": round(self._occupancy(), 4),
                "slot_ages_s": slot_ages,
                "completed": self._completed,
                "shed": self._shed,
                "timeouts": self._timeouts,
                "request_errors": self._request_errors,
                "requeued_out": self._requeued_out,
                "requeued_in": self._requeued_in}

    # --------------------------------------------------------------- metrics

    def accept_by_version(self) -> dict:
        """Speculative counts by param version, ``{version: (proposed,
        accepted)}`` — raw ints a fleet can sum (the rates are in
        :meth:`stats`)."""
        return {v: (b[0], b[1])
                for v, b in sorted(self._accept_by_version.items())}

    def stats(self, brief: bool = False) -> dict:
        """Aggregate serving metrics (floats, MetricWriter-compatible)."""
        out = {
            "serve_queue_depth": float(len(self._queue)
                                       + (self._admitting is not None)),
            "serve_occupancy": self._occupancy(),
            "serve_completed": float(self._completed),
        }
        if brief:
            if self._ttfts:
                out["serve_ttft_last_s"] = self._ttfts[-1]
            return out
        out.update({
            "serve_ticks": float(self._tick),
            "serve_shed": float(self._shed),
            "serve_timeouts": float(self._timeouts),
            "serve_timeouts_ttft": float(self._timeouts_ttft),
            "serve_request_errors": float(self._request_errors),
            "serve_requeued_out": float(self._requeued_out),
            "serve_requeued_in": float(self._requeued_in),
            "serve_queue_peak": float(self._queue_peak),
            "serve_occupancy_mean": (self._occupancy_sum / self._tick
                                     if self._tick else 0.0),
            "serve_ttft_p50_s": _quantile(self._ttfts, 0.5),
            "serve_ttft_p99_s": _quantile(self._ttfts, 0.99),
            "serve_tok_latency_p50_s": _quantile(self._tok_lats, 0.5),
            "serve_tok_latency_p99_s": _quantile(self._tok_lats, 0.99),
        })
        if self._spec_proposed:
            out["serve_spec_accept_rate"] = (self._spec_accepted
                                             / self._spec_proposed)
        for v, (prop, acc) in sorted(self._accept_by_version.items()):
            if prop:
                out[f"serve_spec_accept_rate_v{v}"] = acc / prop
        if self.ttft_slo_s > 0.0:
            out["serve_ttft_slo_ok_frac"] = (
                sum(1 for t in self._ttfts if t <= self.ttft_slo_s)
                / len(self._ttfts) if self._ttfts else 1.0)
        counters = getattr(self.engine, "counters", None)
        if counters is not None:
            out.update({f"serve_{k}": float(v) for k, v in counters.items()})
        prefix = getattr(self.engine, "prefix_stats", None)
        if prefix is not None:
            out.update({f"serve_prefix_{k}": float(v)
                        for k, v in prefix().items()})
        if self.telemetry is not None:
            for name, roll in self.telemetry.spans.rollup().items():
                if name.startswith("serve_") or name == "router_wait":
                    out[f"{name}_p50_s"] = roll["p50_s"]
                    out[f"{name}_p99_s"] = roll["p99_s"]
        return out
