"""The run's event log on the port (``dtf_tpu_torch.telemetry.events``)
against the JAX package's (``dtf_tpu.telemetry.events``), on the CPU.

The record codec (``crc32c``, ``encode_record``) equals the reference's
byte for byte; a directory either package writes reads, record for
record, through the other's ``read_events`` (and a second writer of the
other package appends to it); the same emits, rotations, second writers,
``crash_in_event_rotate`` crashes with their adoption, and ``arm_corrupt``
damages leave the same bytes on disk in both packages. A JAX ``Router``
and the port's, on the same tiny float32 weights under one injected
clock, emit the same sequence of events through a rolling swap and a
wedge that quarantines, requeues and recovers. The trainer's side:
``publish_version`` only after the manifest commits, and a checkpoint's
save, fallback and restore events as the reference's. End to end, the
port's ``serve_gpt`` with the whole plane on equals the JAX launcher on
the same published weights: rows, sink records and event kinds.
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.data import tfrecord as jtfrecord
from dtf_tpu.data.stream import servelog as jservelog
from dtf_tpu.fault import inject as jinject
from dtf_tpu.models import gpt as jgpt
from dtf_tpu.serve import HealthConfig as JHealthConfig
from dtf_tpu.serve import Request as JRequest
from dtf_tpu.serve import Router as JRouter
from dtf_tpu.serve import SwapConfig as JSwapConfig
from dtf_tpu.serve import install_serve_fault as jinstall
from dtf_tpu.serve.logsink import LogSink as JLogSink
from dtf_tpu.telemetry import events as jevents
from dtf_tpu_torch import convert, serve_gpt
from dtf_tpu_torch.core.train import TrainState
from dtf_tpu_torch.data import tfrecord as ttfrecord
from dtf_tpu_torch.data.stream import servelog as tservelog
from dtf_tpu_torch.fault import inject as tinject
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.serve import HealthConfig, Request, Router, SwapConfig
from dtf_tpu_torch.serve import install_serve_fault
from dtf_tpu_torch.serve.logsink import LogSink
from dtf_tpu_torch.telemetry import events as tevents

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

J = types.SimpleNamespace(
    EventLog=jevents.EventLog, read_events=jevents.read_events,
    manifest=jevents.read_events_manifest, Router=JRouter, Request=JRequest,
    HealthConfig=JHealthConfig, SwapConfig=JSwapConfig, install=jinstall,
    Plan=jinject.ServeFaultPlan, InjectedCrash=jinject.InjectedCrash,
    LogSink=JLogSink)
T = types.SimpleNamespace(
    EventLog=tevents.EventLog, read_events=tevents.read_events,
    manifest=tevents.read_events_manifest, Router=Router, Request=Request,
    HealthConfig=HealthConfig, SwapConfig=SwapConfig,
    install=install_serve_fault, Plan=tinject.ServeFaultPlan,
    InjectedCrash=tinject.InjectedCrash, LogSink=LogSink)
APIS = {"jax": J, "port": T}

#: fields of an event that depend on the wall clock, left out where the
#: two packages' logs run on the real wall clock: the log's own stamp
WALL_FIELDS = ("t",)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


class _FakeEngine:
    """Host-only engine with the probe surface probation needs."""

    n_slots = 2
    max_len = 64
    prefill_chunk = 64
    spec_k = 0

    def prefill_chunk_into(self, slot, prompt, chunk_i, *, start=0, **kw):
        return int(prompt[0]) % 7, False

    def decode(self, **kw):
        return [1] * self.n_slots, [False] * self.n_slots

    def probe(self):
        pass


def _files(d):
    """{name: bytes} of every file under ``d``."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _records(seed, n=12):
    rng = np.random.default_rng(seed)
    words = ["done", "ünïcode", "a b", "", "x" * 40, "\"q\"", "tab\t"]
    out = []
    for i in range(n):
        out.append({
            "rid": int(rng.integers(0, 10 ** 6)),
            "prompt": rng.integers(0, 50304, int(rng.integers(1, 64))
                                   ).tolist(),
            "ttft_s": round(float(rng.random()), 6),
            "status": words[i % len(words)],
            "nested": {"b": [True, None, 1.5], "a": i},
            "version": None if i % 3 else i})
    return out


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc32c_and_encode_record_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 7, 64, 1000):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert ttfrecord.crc32c(data) == jtfrecord.crc32c(data)
        assert ttfrecord.masked_crc32c(data) == jtfrecord.masked_crc32c(data)
    assert ttfrecord.crc32c(b"123456789") == 0xE3069283   # the check value
    for rec in _records(seed):
        line = tservelog.encode_record(rec)
        assert line == jservelog.encode_record(rec)
        assert tservelog.decode_record(line) == rec
        assert jservelog.decode_record(line) == rec
        # one flipped body byte: both frames fail
        bad = line[:-2] + ("0" if line[-2] != "0" else "1") + line[-1]
        assert tservelog.decode_record(bad) is None
        assert jservelog.decode_record(bad) is None
    for junk in ("", "zz", "0000000g {}", "00000000", "00000000 [1]"):
        assert tservelog.decode_record(junk) == jservelog.decode_record(junk)


# ---------------------------------------------------------------------------
# EventLog: formats read across the packages, rotation, second writers
# ---------------------------------------------------------------------------

def _emit_script(api, d, wall):
    ev = api.EventLog(d, rotate_bytes=150, wall=wall)
    got = []
    for i, rec in enumerate(_records(5, n=20)):
        fields = {k: v for k, v in rec.items() if k not in ("event", "seq")}
        if i == 3:
            fields["t"] = 7.25        # the caller's own stamp wins
        got.append(ev.emit("tick" if i % 2 else "ckpt_save", **fields))
    ev.close()
    return got, ev.stats()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_event_dirs_read_through_either_package(tmp_path, writer):
    """One package writes (rotating), both read the same records; a
    writer of the other package appends, and both read again."""
    other = "port" if writer == "jax" else "jax"
    d = str(tmp_path / "events")
    emitted, stats = _emit_script(APIS[writer], d, wall=lambda: 3.5)
    assert stats["rotations"] > 1 and stats["events"] == 20
    assert emitted[3]["t"] == 7.25 and emitted[4]["t"] == 3.5
    for api in (J, T):
        assert api.read_events(d) == emitted
        assert api.manifest(d)["records"] == 20
    ev2 = APIS[other].EventLog(d, wall=lambda: 4.0)
    assert ev2.stats()["adopted_shards"] == 0
    last = ev2.emit("resume", i=20)
    ev2.close()
    assert last["seq"] == 0                   # seq is the writer's own
    for api in (J, T):
        assert api.read_events(d) == emitted + [last]
    names = [s["name"] for s in T.manifest(d)["shards"]]
    assert names == sorted(names) and len(set(names)) == len(names)


def test_rotation_and_second_writer_leave_the_reference_bytes(tmp_path):
    """The same emits, rotations and a second writer leave byte-equal
    directories; shard names continue past everything on disk."""
    dirs = {}
    for name, api in APIS.items():
        d = dirs[name] = str(tmp_path / name)
        _emit_script(api, d, wall=lambda: 1.0)
        ev2 = api.EventLog(d, rotate_bytes=120, wall=lambda: 2.0)
        for i in range(5):
            ev2.emit("resume", i=i)
        ev2.close()
    assert _files(dirs["port"]) == _files(dirs["jax"])
    names = [s["name"] for s in T.manifest(dirs["port"])["shards"]]
    assert len(set(names)) == len(names) > 3


def test_crash_in_event_rotate_adopts_as_the_reference(tmp_path):
    """The ``crash_in_event_rotate@1`` verb, armed through
    ``install_serve_fault`` on a fleet's shared event log: the crash lands
    after the shard is durable and before the manifest commits; readers
    see the orphan without adopting it; the next log adopts it and never
    reuses its name. Both packages leave the same bytes."""
    seen = {}
    for name, api in APIS.items():
        d = str(tmp_path / name)
        clk = _Clock()
        ev = api.EventLog(d, rotate_bytes=1, wall=clk)   # rotate every emit
        fleet = api.Router([_FakeEngine(), _FakeEngine()], clock=clk,
                           events=ev, health=False)
        lines = []
        state = api.install(api.Plan.parse("crash_in_event_rotate@1"),
                            fleet, emit=lines.append)
        ev.emit("a", i=0)
        with pytest.raises(api.InjectedCrash, match="mid-rotation"):
            ev.emit("b", i=1)
        assert state.fired
        assert json.loads(lines[-1])["fault_inject"] == \
            "crash_in_event_rotate"
        assert [r["i"] for r in api.read_events(d)] == [0, 1]
        assert len(api.manifest(d)["shards"]) == 1
        ev2 = api.EventLog(d, wall=clk)
        assert ev2.stats()["adopted_shards"] == 1
        ev2.emit("c", i=2)
        ev2.close()
        assert [r["i"] for r in api.read_events(d)] == [0, 1, 2]
        seen[name] = _files(d)
    assert seen["port"] == seen["jax"]
    assert len(json.loads(seen["port"]["EVENTS_MANIFEST.json"])
               ["shards"]) == 3


def test_arm_corrupt_drops_the_same_record(tmp_path):
    seen = {}
    for name, api in APIS.items():
        d = str(tmp_path / name)
        ev = api.EventLog(d, wall=lambda: 1.0)
        ev.arm_corrupt(2)
        for i in range(5):
            ev.emit("tick", i=i)
        ev.close()
        assert ev.stats()["injected_corrupt"] == 1
        seen[name] = _files(d)
        for reader in (J, T):
            assert [r["i"] for r in reader.read_events(d)] == [0, 1, 3, 4]
    assert seen["port"] == seen["jax"]


def test_emit_swallows_io_errors_and_counts_them(tmp_path):
    """An observability log never takes the run down: a shard it cannot
    append to (here a directory in its place) counts an IO error and the
    emit returns, as the reference's does."""
    for name, api in APIS.items():
        d = tmp_path / name
        ev = api.EventLog(str(d), wall=lambda: 1.0)
        (d / "events-00000.jsonl").mkdir(parents=True)
        rec = ev.emit("tick", i=0)
        assert rec["seq"] == 0 and ev.stats()["io_errors"] == 1
        assert ev.stats()["events"] == 1


# ---------------------------------------------------------------------------
# a JAX fleet and the port's emit the same events
# ---------------------------------------------------------------------------

MAX_LEN = 48
HEALTH = dict(min_slow_s=1.0, wedge_s=5.0, probation_delay_s=50.0,
              probation_ticks=2)


def _tree(cfg, seed):
    tree = convert.init_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), tree)


def _greedy(seed, n):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, 128, int(rng.integers(1, 12))
                                     ).tolist(),
                 max_new=int(rng.integers(3, 8))) for _ in range(n)]


def _fleet_story(api, cfg, v1, v2, root, **build_kw):
    """A rolling swap under traffic, then a wedge that quarantines and
    requeues; healed, the replica passes probation and recovers. One
    event log and one sink."""
    clock = _Clock()
    ev = api.EventLog(os.path.join(root, "events"))      # the real wall
    sink = api.LogSink(os.path.join(root, "sink"), rotate_bytes=600,
                       events=ev)
    router = api.Router.build(
        cfg, v1, n_replicas=2, n_slots=2, max_len=MAX_LEN, prefill_chunk=5,
        clock=clock, health=api.HealthConfig(**HEALTH), events=ev,
        log_sink=sink, **build_kw)
    router.CP_PROFILE_EVERY = 8

    def pump():
        for _ in range(500):
            if not (router.pending or router.swap_in_progress):
                return
            router.tick()
            clock.advance(0.01)
        raise RuntimeError("fleet did not drain")

    for r in _greedy(1, 4):
        router.submit(api.Request(**r))
    pump()
    for r in _greedy(2, 6):
        router.submit(api.Request(**r))
    for _ in range(2):
        router.tick()
        clock.advance(0.01)
    assert router.start_swap(v2, version=2,
                             config=api.SwapConfig(canary_ticks=2)) == 2
    pump()
    api.install(api.Plan("wedge_replica", 2, replica=1), router,
                sleep=clock.advance, wedge_s=6.0, emit=lambda line: None)
    for r in _greedy(3, 6):
        router.submit(api.Request(**r))
    pump()
    del router.schedulers[1].engine.decode       # the wedge heals
    clock.advance(60.0)
    for _ in range(3):
        router.tick()
    sink.close()
    ev.close()
    return router, ev


def test_router_events_equal_the_reference(tmp_path):
    """Every event the JAX fleet writes, the port's writes, in the same
    order with equal fields — all but :data:`WALL_FIELDS`: the router,
    the health tracker and the wedge run on one injected clock, the logs
    on the real wall clock."""
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    t1, t2 = _tree(tcfg, 0), _tree(tcfg, 1)
    jr, jev = _fleet_story(J, jcfg, jax.tree.map(jnp.asarray, t1),
                           jax.tree.map(jnp.asarray, t2),
                           str(tmp_path / "jax"))
    tr, tev = _fleet_story(T, tcfg, convert.params_from_flax(t1),
                           convert.params_from_flax(t2),
                           str(tmp_path / "port"), device="cpu")
    want = [{k: v for k, v in e.items() if k not in WALL_FIELDS}
            for e in J.read_events(str(tmp_path / "jax" / "events"))]
    got = [{k: v for k, v in e.items() if k not in WALL_FIELDS}
           for e in T.read_events(str(tmp_path / "port" / "events"))]
    assert got == want
    kinds = [e["event"] for e in got]
    for kind in ("swap_start", "swap_canary", "swap_commit",
                 "requeue_drain", "health_transition", "cp_profile",
                 "logsink_rotate"):
        assert kind in kinds, (kind, kinds)
    assert "swap_rollback" not in kinds
    states = [(e["state_from"], e["state_to"]) for e in got
              if e["event"] == "health_transition"]
    assert ("healthy", "quarantined") in states
    assert ("probation", "healthy") in states
    assert tr.stats()["router_events"] == jr.stats()["router_events"] \
        == float(len(got))
    assert tr.stats()["router_log_sink_records"] == 16.0


# ---------------------------------------------------------------------------
# the trainer's side: publishes and checkpoints
# ---------------------------------------------------------------------------

class _ManifestAtEmit:
    """An event log that notes the publish manifest's version at each
    emit: ``publish_version`` must come after its commit."""

    def __init__(self, log, pub_dir):
        self.log, self.pub_dir, self.seen = log, pub_dir, []

    def emit(self, kind, **fields):
        from dtf_tpu_torch.publish import read_manifest

        self.seen.append((kind, (read_manifest(self.pub_dir) or {})
                          .get("version")))
        return self.log.emit(kind, **fields)


def test_publish_version_after_the_commit_only(tmp_path):
    """A publish that crashes before its manifest commit emits nothing;
    each committed one emits ``publish_version`` after the manifest names
    it, with the fields the reference's carries."""
    from dtf_tpu.publish import ParamPublisher as JPublisher
    from dtf_tpu_torch.publish import ParamPublisher

    d = str(tmp_path / "events")
    ev = tevents.EventLog(d, wall=lambda: 1.0)
    pub = ParamPublisher(str(tmp_path / "pub"))
    watch = _ManifestAtEmit(ev, pub.directory)
    pub.event_log = watch

    def crash(version, step):
        raise tinject.InjectedCrash("mid-publish")

    pub._pre_commit = crash
    with pytest.raises(tinject.InjectedCrash):
        pub.publish(1, {"w": torch.arange(4.0)})
    pub._pre_commit = None
    assert pub.publish(2, {"w": torch.arange(4.0)}) == 2
    assert pub.publish(3, {"w": torch.ones(4)}) == 3
    ev.close()
    assert watch.seen == [("publish_version", 2), ("publish_version", 3)]
    got = tevents.read_events(d)
    jd = str(tmp_path / "jevents")
    jev = jevents.EventLog(jd, wall=lambda: 1.0)
    jpub = JPublisher(str(tmp_path / "jpub"))
    jpub.event_log = jev
    jpub.publish(2, {"w": jnp.arange(4.0)})
    jev.close()
    want = jevents.read_events(jd)
    assert [e["event"] for e in got] == ["publish_version"] * 2
    assert sorted(got[0]) == sorted(want[0])
    assert (got[0]["step"], got[1]["step"]) == (2, 3)
    assert [e["version"] for e in got] == [2, 3]   # 1 crashed, not reused
    assert got[0]["digest"].startswith("sha256:")


def _truncate_step(ckpt_dir, step):
    for root, _, files in os.walk(os.path.join(ckpt_dir, str(step))):
        for f in files:
            path = os.path.join(root, f)
            size = os.path.getsize(path)
            if size:
                with open(path, "r+b") as fh:
                    fh.truncate(size // 2)


def test_checkpoint_save_and_fallback_events_as_the_reference(tmp_path):
    """Two saves, the newest step truncated, a latest-step restore: both
    packages emit ``ckpt_save`` × 2, ``ckpt_fallback`` past step 2 and
    ``ckpt_restore`` of step 1. Left out of the comparison: the
    directory (each its own) and ``error``, the exception class of the
    unreadable step (Orbax's and ``torch.load``'s differ)."""
    from dtf_tpu.checkpoint import Checkpointer as JCheckpointer
    from dtf_tpu_torch.checkpoint import Checkpointer

    def story(make, save, restore, name):
        d = str(tmp_path / f"{name}_events")
        ev = (jevents if name == "jax" else tevents).EventLog(
            d, wall=lambda: 1.0)
        ck = make(str(tmp_path / f"{name}_ckpt"))
        ck.attach_event_log(ev)
        for step in (1, 2):
            save(ck, step)
        _truncate_step(ck.directory, 2)
        restore(ck)
        ev.close()
        events = (jevents if name == "jax" else tevents).read_events(d)
        assert all(e["directory"] == ck.directory for e in events)
        return [{k: v for k, v in e.items()
                 if k not in ("t", "directory", "error")} for e in events]

    def jsave(ck, step):
        ck.save(step, {"params": {"w": jnp.arange(4.0) + step}})
        ck.wait()

    want = story(lambda d: JCheckpointer(d, async_save=False), jsave,
                 lambda ck: ck.restore({"params": {"w": jnp.zeros(4)}}),
                 "jax")

    def tsave(ck, step):
        ck.save(step, TrainState(step=step, params={"w": torch.arange(4.0)},
                                 opt_state={}, rng=0))

    target = TrainState(step=0, params={"w": torch.zeros(4)}, opt_state={},
                        rng=0)
    got = story(Checkpointer, tsave, lambda ck: ck.restore(target), "port")
    assert got == want
    assert [e["event"] for e in got] == ["ckpt_save", "ckpt_save",
                                         "ckpt_fallback", "ckpt_restore"]
    assert got[2]["bad_step"] == 2 and got[3]["step"] == 1


def test_train_gpt_event_log_publishes_after_commits(tmp_path):
    """``train_gpt --event_log_dir`` with ``--publish_dir``: a
    ``ckpt_save`` a save, one ``publish_version`` a version in order,
    ``train_end`` last, seq strictly increasing."""
    from dtf_tpu_torch import train_gpt
    from dtf_tpu_torch.publish import read_manifest

    d, pub = str(tmp_path / "events"), str(tmp_path / "pub")
    train_gpt.run(["--device=cpu", "--size=tiny", "--batch_size=2",
                   "--seq_len=16", "--train_steps=4", "--checkpoint_every=2",
                   f"--logdir={tmp_path / 'run'}", f"--publish_dir={pub}",
                   "--publish_every=2", f"--event_log_dir={d}"])
    events = tevents.read_events(d, include_orphans=False)
    kinds = [e["event"] for e in events]
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert kinds[-1] == "train_end" and events[-1]["step"] == 4
    pubs = [e for e in events if e["event"] == "publish_version"]
    assert [(e["version"], e["step"]) for e in pubs] == [(1, 2), (2, 4)]
    hist = read_manifest(pub)["history"]
    assert [e["digest"] for e in pubs] == [hist["1"]["digest"],
                                           hist["2"]["digest"]]
    saves = [e["step"] for e in events if e["event"] == "ckpt_save"]
    assert saves == [2, 4]


# ---------------------------------------------------------------------------
# end to end: the launchers with the whole plane on
# ---------------------------------------------------------------------------

def test_serve_gpt_plane_equals_the_reference_launcher(tmp_path,
                                                       cpu_sim_subprocess_env):
    """The JAX publisher publishes the tiny model's seeded weights; the
    port republishes them. The JAX ``scripts/serve_gpt.py`` and the
    port's ``serve_gpt`` serve them on 2 replicas with ``--event_log_dir
    --log_sink_dir --trace_out --telemetry``: equal rows, equal sink
    records (all but ``ttft_s`` and ``latency_s``, wall-clock), equal
    event kinds, and the port's line carries the reference's plane keys
    but ``compile_events`` and ``monitoring_available``."""
    from dtf_tpu.publish import ParamPublisher as JPublisher
    from dtf_tpu.publish import load_published as jload
    from dtf_tpu_torch.publish import ParamPublisher

    cfg = tgpt.GPTConfig.tiny()
    jdir, tdir = str(tmp_path / "jpub"), str(tmp_path / "tpub")
    JPublisher(jdir, wall=lambda: 5.0).publish(
        3, jax.tree.map(jnp.asarray, convert.init_params(cfg, 0)))
    _, step, tree = jload(jdir, version=1)
    ParamPublisher(tdir, wall=lambda: 5.0).publish(
        step, convert.params_from_flax(jax.tree.map(np.asarray, tree)))
    common = ["--size=tiny", "--replicas=2", "--n_slots=2", "--max_len=48",
              "--prefill_chunk=4", "--n_new=6", "--emit_tokens",
              "--telemetry",
              "--requests=5,9,2;5,9,2,7,1,3;1,2,3,4,5;8,8;2,4,6,8"]

    def plane(tag):
        return [f"--logdir={tmp_path / tag}",
                f"--event_log_dir={tmp_path / tag / 'events'}",
                f"--log_sink_dir={tmp_path / tag / 'sink'}",
                f"--trace_out={tmp_path / tag / 'trace.json'}"]

    env = dict(cpu_sim_subprocess_env)
    env["PYTHONPATH"] = ROOT
    env.pop("DTF_FAULT_INJECT", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "serve_gpt.py"),
         f"--publish_dir={jdir}", *plane("j"), *common], env=env,
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    want_rows = [ln for ln in lines if ln[:1].isdigit()]
    want = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    out, rows, _ = serve_gpt.run(["--device=cpu", f"--publish_dir={tdir}",
                                  *plane("t"), *common])
    assert rows == want_rows and len(rows) == 5

    def sink_records(tag):
        d = str(tmp_path / tag / "sink")
        m = jservelog.read_manifest(d)
        recs = []
        for s in m["shards"]:
            with open(os.path.join(d, s["name"])) as f:
                recs += [jservelog.decode_record(ln)
                         for ln in f.read().splitlines()]
        return sorted(({k: v for k, v in r.items()
                        if k not in ("ttft_s", "latency_s")} for r in recs),
                      key=lambda r: r["rid"])

    assert sink_records("t") == sink_records("j")
    assert len(sink_records("t")) == 5
    kinds = {tag: [e["event"] for e in jevents.read_events(
        str(tmp_path / tag / "events"))] for tag in ("j", "t")}
    assert kinds["t"] == kinds["j"]
    assert kinds["t"][0] == "serve_start" and kinds["t"][-1] == \
        "serve_summary"
    plane_keys = {"log_sink", "log_sink_dir", "event_log", "event_log_dir",
                  "trace_out", "trace_events", "trace_counts",
                  "router_log_sink_records", "router_events"}
    assert plane_keys <= set(want) and plane_keys <= set(out)
    assert {"compile_events", "monitoring_available"} <= set(want)
    assert not {"compile_events", "monitoring_available"} & set(out)
    assert out["log_sink"] == want["log_sink"]
    assert out["event_log"] == want["event_log"]
    assert out["trace_counts"] == [{"prefill": 1, "decode": 1}] * 2
    with open(tmp_path / "t" / "trace.json") as f:
        doc = json.load(f)
    assert doc["metadata"] == {"source": "serve_gpt", "replicas": 2}
    assert len(doc["traceEvents"]) == out["trace_events"]
    with open(tmp_path / "t" / "telemetry" / "TELEMETRY.json") as f:
        runs = json.load(f)["runs"]
    assert runs[-1]["source"] == "serve_gpt" and runs[-1]["log_sink"] == \
        out["log_sink"]
