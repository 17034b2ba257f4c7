"""Request traces, the heartbeat's records and the serve postmortem on the
port (``dtf_tpu_torch.telemetry.trace``, ``.profile``, ``.flight``,
``.run``; the scheduler's and router's ``telemetry=``), against the JAX
package's, on the CPU.

From ``tests/test_serve_trace.py`` and ``tests/test_events.py``: trace
ids threaded through a router (the fleet id) and a standalone scheduler
(the local id), an explicit id winning, trace ids reaching the engine
only when it annotates, the chrome-trace export, the heartbeat's
``slo_excursion`` records and heartbeat file, postmortem providers whose
error never masks the dump. New here: the same trace events (all but
their timestamps) and the same export document as the JAX package's;
the engine's ``torch.profiler.record_function`` ranges carrying the ids;
and the proof on the real engine that tracing, the sink and the event
log add no device readback (``.item()``, ``.cpu()``, ``.tolist()`` and
``.numpy()`` counted) and change no token.
"""

import json
import logging
import os
import signal

import numpy as np
import pytest
import torch

from dtf_tpu.serve import Heartbeat as JHeartbeat
from dtf_tpu.serve import Request as JRequest
from dtf_tpu.serve import Router as JRouter
from dtf_tpu.telemetry import Telemetry as JTelemetry
from dtf_tpu.telemetry import TraceCollector as JTraceCollector
from dtf_tpu.telemetry import events as jevents
from dtf_tpu.telemetry.flight import FlightRecorder as JFlightRecorder
from dtf_tpu.telemetry.profile import export_chrome_trace as jexport
from dtf_tpu_torch import convert
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.serve import (DecodeEngine, Heartbeat, Request, Router,
                                 Scheduler)
from dtf_tpu_torch.serve.logsink import LogSink
from dtf_tpu_torch.telemetry import events as tevents
from dtf_tpu_torch.telemetry.flight import FlightRecorder
from dtf_tpu_torch.telemetry.profile import export_chrome_trace
from dtf_tpu_torch.telemetry.run import Telemetry, merge_artifact
from dtf_tpu_torch.telemetry.trace import TraceCollector

MAX_LEN = 48

#: a trace event's fields that read the clock
CLOCK_FIELDS = ("ts", "dur")


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


class _FakeEngine:
    """Host-only engine: one chunk a prompt, 1s decoded."""

    n_slots = 2
    max_len = MAX_LEN
    prefill_chunk = 64

    def prefill_chunk_into(self, slot, prompt, chunk_i, *, start=0, **kw):
        return int(prompt[0]) % 7, False

    def decode(self, **kw):
        return [1] * self.n_slots, [False] * self.n_slots


def _tel(api="port"):
    if api == "jax":
        tel = JTelemetry(watchdog=False)
        tel.tracer = JTraceCollector()
    else:
        tel = Telemetry(watchdog=False)
        tel.tracer = TraceCollector()
    return tel


def _no_clock(events):
    return [{k: v for k, v in e.items() if k not in CLOCK_FIELDS}
            for e in events]


# ---------------------------------------------------------------------------
# trace ids
# ---------------------------------------------------------------------------

def test_router_threads_the_fleet_id_as_the_reference():
    """The fleet id is the trace id every replica records: a request's
    lifecycle, queue wait and prefill slices carry it; decode steps sit
    on the shared ``engine`` track with the ids in their args. The JAX
    fleet records the same events, all but their timestamps (the
    routers run on one injected clock, the tracers on their own)."""
    seen = {}
    for api, R, Req in (("jax", JRouter, JRequest),
                        ("port", Router, Request)):
        tel = _tel(api)
        router = R([_FakeEngine(), _FakeEngine()], telemetry=tel,
                   clock=_Clock())
        rids = [router.submit(Req(prompt=[i + 1], max_new=2))
                for i in range(4)]
        router.drain()
        seen[api] = tel.tracer.events
    assert _no_clock(seen["port"]) == _no_clock(seen["jax"])
    events = seen["port"]
    lifecycles = {e["tid"]: e for e in events if e["name"] == "request"}
    assert set(lifecycles) == set(rids)
    for rid in rids:
        assert lifecycles[rid]["args"]["tokens"] == 2
        assert lifecycles[rid]["args"]["ttft_s"] == 0.0
        tagged = [e["name"] for e in events if e["tid"] == rid]
        assert "queue_wait" in tagged and "serve_prefill_chunk" in tagged
    decodes = [e for e in events if e["name"] == "serve_decode"]
    assert decodes and all(e["tid"] == "engine" for e in decodes)
    served = {t for e in decodes for t in e["args"]["trace_ids"]}
    assert served and served <= set(rids)


def test_a_standalone_scheduler_uses_its_local_id():
    tel = _tel()
    sched = Scheduler(_FakeEngine(), telemetry=tel)
    sched.submit(Request(prompt=[3], max_new=1))
    rid = sched.submit(Request(prompt=[4], max_new=1))
    sched.run_until_idle()
    assert ("request", rid) in {(e["name"], e["tid"])
                                for e in tel.tracer.events}


def test_an_explicit_trace_id_wins(tmp_path):
    tel = _tel()
    sink = LogSink(str(tmp_path / "sink"), rotate_bytes=0)
    sched = Scheduler(_FakeEngine(), telemetry=tel, log_sink=sink)
    sched.submit(Request(prompt=[3], max_new=1), trace_id=777)
    sched.run_until_idle()
    sink.close()
    assert {e["tid"] for e in tel.tracer.events} >= {777}
    with open(tmp_path / "sink" / "shard-00000.jsonl") as f:
        assert json.loads(f.read().partition(" ")[2])["rid"] == 777


def test_the_engine_gets_trace_ids_only_when_annotating():
    seen = {}

    class _Probe(_FakeEngine):
        annotate_traces = False

        def prefill_chunk_into(self, slot, prompt, chunk_i, *, start=0,
                               **kw):
            seen.setdefault("prefill", []).append(kw.get("trace_id"))
            return 1, False

        def decode(self, **kw):
            seen.setdefault("decode", []).append(kw.get("trace_ids"))
            return super().decode()

    for annotate in (False, True):
        seen.clear()
        eng = _Probe()
        eng.annotate_traces = annotate
        sched = Scheduler(eng, telemetry=_tel())
        sched.submit(Request(prompt=[3], max_new=2), trace_id=42)
        sched.run_until_idle()
        if annotate:
            assert seen == {"prefill": [42], "decode": [[42]]}
        else:
            assert seen == {"prefill": [None], "decode": [None]}


def _tiny_engine(**kw):
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    sd = convert.params_from_flax(convert.init_params(cfg, 0))
    return DecodeEngine(cfg, sd, n_slots=2, max_len=MAX_LEN,
                        prefill_chunk=4, device="cpu", **kw)


def test_annotated_steps_carry_the_ids_in_profiler_ranges():
    """``annotate_traces`` wraps each prefill chunk and decode step in a
    ``record_function`` range named as the JAX engine's annotation, with
    the trace ids in it; the tokens equal the unannotated engine's."""
    rows = {}
    for annotate in (False, True):
        eng = _tiny_engine()
        eng.annotate_traces = annotate
        sched = Scheduler(eng)
        rids = [sched.submit(Request(prompt=[5, 9, 2, 7, 1], max_new=4)),
                sched.submit(Request(prompt=[8], max_new=3), trace_id=31)]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            sched.run_until_idle()
        rows[annotate] = [sched.poll(r)["tokens"] for r in rids]
        names = {e.name for e in prof.events()}
        ranges = {n for n in names if n.startswith("dtf.serve.")}
        if annotate:
            assert "dtf.serve.prefill_chunk#slot=0,chunk=0,trace_id=0#" \
                in ranges
            assert "dtf.serve.prefill_chunk#slot=1,chunk=0,trace_id=31#" \
                in ranges
            assert "dtf.serve.decode#trace_ids=0,31#" in ranges
        else:
            assert not ranges
    assert rows[True] == rows[False]


# ---------------------------------------------------------------------------
# the chrome-trace export
# ---------------------------------------------------------------------------

def test_export_writes_the_reference_document(tmp_path):
    tel = _tel()
    sched = Scheduler(_FakeEngine(), telemetry=tel)
    sched.submit(Request(prompt=[5], max_new=2))
    sched.run_until_idle()
    events = tel.tracer.events
    meta = {"source": "test", "replicas": 1}
    got = export_chrome_trace(str(tmp_path / "port.json"),
                              request_events=events, meta=meta)
    want = jexport(str(tmp_path / "jax.json"), request_events=events,
                   meta=meta)
    assert got == want
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert f.read() == g.read()
    assert {"request", "queue_wait", "serve_prefill_chunk",
            "serve_decode"} <= {e["name"] for e in got["traceEvents"]}
    assert export_chrome_trace(str(tmp_path / "empty.json")) == \
        jexport(str(tmp_path / "jempty.json"))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        export_chrome_trace(str(tmp_path / "x.json"), trace=object())


def test_the_trace_ring_is_bounded_and_counts_drops():
    t = TraceCollector(keep=3, clock=_Clock())
    j = JTraceCollector(keep=3, clock=_Clock())
    for tc in (t, j):
        clock = tc.clock
        for i in range(5):
            clock.advance(0.5)
            with tc.span("s", cat="c", tid=i, args={"i": i}):
                clock.advance(0.25)
        tc.instant("mark", cat="c", tid="x")
    assert t.events == j.events and len(t) == 3
    assert t.dropped == j.dropped == 3


# ---------------------------------------------------------------------------
# the heartbeat's records
# ---------------------------------------------------------------------------

class _FleetStats:
    def __init__(self):
        self.ok = 1.0
        self.r0 = 1.0

    def stats(self):
        return {"serve_completed": 1.0, "router_version": 2.0,
                "router_ttft_slo_ok_frac": self.ok,
                "replica0_serve_ttft_slo_ok_frac": self.r0,
                "replica0_version": 2.0}


def test_heartbeat_excursions_and_heartbeat_file_as_the_reference(tmp_path,
                                                                   caplog):
    """The same SLO story through both packages' heartbeats: one WARN an
    episode a key, ``slo_excursion`` enter / exit records with their
    ticks, and the heartbeat file with the serve panel."""
    seen = {}
    for api, HB, EL, FR in (("jax", JHeartbeat, jevents.EventLog,
                             JFlightRecorder),
                            ("port", Heartbeat, tevents.EventLog,
                             FlightRecorder)):
        d = str(tmp_path / api / "events")
        ev = EL(d, wall=lambda: 1.0)
        hb_path = str(tmp_path / api / "heartbeat.json")
        flight = FR(heartbeat_path=hb_path, wall=lambda: 2.0)
        sched = _FleetStats()
        hb = HB(sched, every_ticks=1, slo_floor=0.9, clock=_Clock(),
                emit=lambda line: None, events=ev, flight=flight)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            hb.maybe_emit()
            sched.r0 = 0.5
            hb.maybe_emit()             # replica0 enters
            hb.maybe_emit()             # sustained: no second WARN
            sched.r0 = 0.95
            hb.maybe_emit()             # replica0 exits
            sched.ok = 0.5
            hb.maybe_emit()             # the fleet enters
        warns = [r.getMessage() for r in caplog.records
                 if "SLO" in r.getMessage()]
        ev.close()
        with open(hb_path) as f:
            seen[api] = (jevents.read_events(d), json.load(f), hb.stats(),
                         len(warns))
    assert seen["port"] == seen["jax"]
    events, beat, stats, n_warns = seen["port"]
    assert [(e["key"], e["edge"]) for e in events] == [
        ("replica0", "enter"), ("replica0", "exit"), ("fleet", "enter")]
    assert events[1]["entered_tick"] == 2 and events[1]["ticks"] == 2
    assert beat["serve"]["replica_versions"] == {"replica0_version": 2.0}
    assert stats["replica_slo_excursions"] == 1.0 and n_warns == 2


# ---------------------------------------------------------------------------
# the postmortem
# ---------------------------------------------------------------------------

def test_a_postmortem_names_the_fleets_requests_as_the_reference(tmp_path):
    """A dump carries the router's provider — every replica's in-flight
    ids and slot ages, the health verdicts — as the JAX package's does,
    appended to ``postmortem.json``."""
    seen = {}
    for api, R, Req, Tel in (("jax", JRouter, JRequest, JTelemetry),
                             ("port", Router, Request, Telemetry)):
        clock = _Clock()
        tel = Tel(out_dir=str(tmp_path / api), watchdog=False)
        router = R([_FakeEngine(), _FakeEngine()], telemetry=tel,
                   clock=clock)
        for i in range(5):
            router.submit(Req(prompt=[i + 1], max_new=50))
        router.tick()
        clock.advance(2.5)
        post = tel.dump_postmortem("stall", {"stalled_for_s": 99.0})
        with open(tmp_path / api / "postmortem.json") as f:
            assert json.loads(f.read().splitlines()[-1]) == post
        seen[api] = post
    assert seen["port"]["context"] == seen["jax"]["context"]
    assert set(seen["port"]) == set(seen["jax"])
    ctx = seen["port"]["context"]["serve_router"]
    flights = [r for k, rep in ctx.items() if k.startswith("replica")
               for r in rep["in_flight"]]
    assert {f["trace_id"] for f in flights} == set(range(5))
    assert ctx["router"]["health"] == ["healthy", "healthy"]


def test_a_provider_error_never_masks_the_dump(tmp_path):
    tel = Telemetry(out_dir=str(tmp_path), watchdog=False)
    tel.add_postmortem_provider("bad", lambda: 1 / 0)
    tel.add_postmortem_provider("good", lambda: {"x": 1})
    post = tel.dump_postmortem("crash")
    assert post["reason"] == "crash" and post["context"]["good"] == {"x": 1}
    assert "ZeroDivisionError" in post["context"]["bad"]["provider_error"]
    tel.add_postmortem_provider("bad", None)
    assert "bad" not in tel.dump_postmortem("again")["context"]
    with open(tmp_path / "postmortem.json") as f:
        assert [json.loads(ln)["reason"] for ln in f] == ["crash", "again"]


def test_a_standalone_scheduler_registers_its_own_provider():
    tel = Telemetry(watchdog=False)
    sched = Scheduler(_FakeEngine(), telemetry=tel)
    sched.submit(Request(prompt=[1], max_new=5))
    post = tel.dump_postmortem("sigterm")
    assert post["context"]["serve_scheduler"]["queue_depth"] == 1


def test_sigterm_dumps_then_chains_the_previous_handler(tmp_path):
    calls = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: calls.append(s))
    try:
        tel = Telemetry(out_dir=str(tmp_path), watchdog=False)
        tel.start()
        os.kill(os.getpid(), signal.SIGTERM)
        tel.stop()
        assert calls == [signal.SIGTERM] and tel.flight.dumps == 1
        with open(tmp_path / "postmortem.json") as f:
            assert json.loads(f.read())["reason"] == "sigterm"
        assert signal.getsignal(signal.SIGTERM) is not tel._on_sigterm
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_the_unported_telemetry_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Telemetry()
    tel = Telemetry(watchdog=False)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tel.account("compile", 1.0)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tel.count_traces("step", lambda: None)
    tel.tracer = TraceCollector()
    rep = tel.report({"source": "test"})
    assert rep["telemetry"] == "run_report" and rep["trace_events"] == 0
    assert "compile_events" not in rep
    path = str(tmp_path / "TELEMETRY.json")
    with open(path, "w") as f:
        f.write("{torn")
    for i in range(3):
        merge_artifact(path, rep, keep_runs=2, meta={"i": i})
    with open(path) as f:
        assert [r["i"] for r in json.load(f)["runs"]] == [1, 2]


# ---------------------------------------------------------------------------
# no device readback, no token changed
# ---------------------------------------------------------------------------

_READBACKS = ("item", "cpu", "tolist", "numpy")


def test_the_plane_adds_no_readback_and_changes_no_token(tmp_path,
                                                         monkeypatch):
    """A fleet of two tiny engines serves the same requests with the plane
    off, then with telemetry, a tracer, annotations, the sink and the
    event log on: the tensors' ``.item()``, ``.cpu()``, ``.tolist()`` and
    ``.numpy()`` calls are as many, and the tokens equal."""
    counts = {}

    def counted(name):
        orig = getattr(torch.Tensor, name)

        def call(self, *a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return orig(self, *a, **kw)
        return call

    rng = np.random.default_rng(0)
    reqs = [dict(prompt=rng.integers(0, 128, int(rng.integers(1, 9))
                                     ).tolist(),
                 max_new=int(rng.integers(2, 7))) for _ in range(6)]

    def serve(on):
        cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
        sd = convert.params_from_flax(convert.init_params(cfg, 0))
        kw = {}
        if on:
            tel = Telemetry(watchdog=False)
            tel.tracer = TraceCollector()
            ev = tevents.EventLog(str(tmp_path / "events"))
            kw = dict(telemetry=tel, events=ev,
                      log_sink=LogSink(str(tmp_path / "sink"),
                                       rotate_bytes=200, events=ev))
        router = Router.build(cfg, sd, n_replicas=2, n_slots=2,
                              max_len=MAX_LEN, prefill_chunk=4,
                              device="cpu", **kw)
        for s in router.schedulers:
            s.engine.annotate_traces = on
        counts.clear()
        with monkeypatch.context() as m:
            for name in _READBACKS:
                m.setattr(torch.Tensor, name, counted(name))
            rids = [router.submit(Request(**r)) for r in reqs]
            router.drain()
            router.stats()
            seen = dict(counts)
        return [router.poll(r)["tokens"] for r in rids], seen, router

    off_rows, off, _ = serve(False)
    on_rows, on, router = serve(True)
    assert on == off and sum(off.values()) > 0
    assert on_rows == off_rows
    st = router.stats()
    assert st["router_log_sink_records"] == 6.0 and st["router_events"] > 0
