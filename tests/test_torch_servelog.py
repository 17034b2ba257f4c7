"""The serve-log sink on the port (``dtf_tpu_torch.serve.logsink``)
against the JAX package's (``dtf_tpu.serve.logsink``), on the CPU.

The same records, rotations, flushes, closes, second sinks and crashes
mid-rotation (with the next sink's adoption) leave the same bytes on
disk in both packages; ``corrupt_log_record@N`` and
``crash_in_log_rotate@N``, armed through ``install_serve_fault`` on a
fleet that shares one sink, damage exactly one record / crash exactly
one rotation in both. A port fleet's sink directory on converted tiny
weights decodes, through the reference's ``read_manifest`` and
``decode_record``, to the records the JAX fleet sinks for the same
greedy requests, all but the wall-clock ``ttft_s`` and ``latency_s``.
What stays unported (the serve log as a stream source, the stream and
distillation flags) still raises.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.data.stream import servelog as jservelog
from dtf_tpu.fault import inject as jinject
from dtf_tpu.models import gpt as jgpt
from dtf_tpu.serve import Request as JRequest
from dtf_tpu.serve import Router as JRouter
from dtf_tpu.serve import install_serve_fault as jinstall
from dtf_tpu.serve.logsink import LogSink as JLogSink
from dtf_tpu.telemetry import events as jevents
from dtf_tpu_torch import convert, serve_gpt, train_gpt
from dtf_tpu_torch.data.stream import servelog as tservelog
from dtf_tpu_torch.fault import inject as tinject
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.serve import Request, Router, install_serve_fault
from dtf_tpu_torch.serve.logsink import LogSink
from dtf_tpu_torch.telemetry import events as tevents

J = types.SimpleNamespace(LogSink=JLogSink, Router=JRouter, Request=JRequest,
                          install=jinstall, Plan=jinject.ServeFaultPlan,
                          InjectedCrash=jinject.InjectedCrash,
                          EventLog=jevents.EventLog,
                          read_events=jevents.read_events,
                          read_manifest=jservelog.read_manifest)
T = types.SimpleNamespace(LogSink=LogSink, Router=Router, Request=Request,
                          install=install_serve_fault,
                          Plan=tinject.ServeFaultPlan,
                          InjectedCrash=tinject.InjectedCrash,
                          EventLog=tevents.EventLog,
                          read_events=tevents.read_events,
                          read_manifest=tservelog.read_manifest)
APIS = {"jax": J, "port": T}

#: the sink record's fields that depend on the wall clock
WALL_FIELDS = ("ttft_s", "latency_s")


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


class _FakeSpecEngine:
    """Host-only speculative engine: (k+1)-wide tokens, one of two
    proposals accepted a tick, so the records carry nonzero counts."""

    n_slots = 2
    max_len = 64
    prefill_chunk = 64
    spec_k = 2
    param_version = 0

    def prefill_chunk_into(self, slot, prompt, chunk_i, *, start=0, **kw):
        return int(prompt[0]) % 7, False

    def decode(self, **kw):
        n = self.n_slots
        toks = np.arange(n * (self.spec_k + 1),
                         dtype=np.int32).reshape(n, -1) % 7 + 1
        return toks, np.zeros((n, self.spec_k + 1), bool), \
            np.full((n,), 2, np.int32)


def _rec(i, n_prompt=3, n_tokens=4):
    return {"rid": i, "replica": i % 2, "version": i // 2, "status": "done",
            "prompt": [(i + j) % 97 for j in range(n_prompt)],
            "tokens": [(3 * i + j) % 97 for j in range(n_tokens)],
            "ttft_s": 0.01 * i, "latency_s": 0.1 * i, "proposed": 2 * i,
            "accepted": i}


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _decoded(d, reader=jservelog):
    """Every line of every shard on disk, decoded (None: damaged)."""
    out = []
    for name in sorted(n for n in os.listdir(d) if n.startswith("shard-")):
        with open(os.path.join(d, name)) as f:
            out += [reader.decode_record(ln) for ln in f.read().split("\n")
                    if ln]
    return out


def test_sink_rotation_and_a_second_sink_as_the_reference(tmp_path):
    seen = {}
    for name, api in APIS.items():
        d = str(tmp_path / name)
        sink = api.LogSink(d, rotate_bytes=1)      # every record rotates
        for i in range(3):
            sink.record(_rec(i))
        st = sink.stats()
        assert st["records"] == 3 and st["rotations"] == 3
        again = api.LogSink(d, rotate_bytes=1)
        assert again.stats()["adopted_shards"] == 0
        again.record(_rec(9))
        again.close()
        man = api.read_manifest(d)
        assert [s["name"] for s in man["shards"]] == [
            tservelog.shard_name(i) for i in range(4)]
        seen[name] = (st, _files(d))
    assert seen["port"] == seen["jax"]
    assert _decoded(str(tmp_path / "port")) == [_rec(0), _rec(1), _rec(2),
                                                _rec(9)]


def test_sink_flush_and_close_commit_the_open_shard(tmp_path):
    seen = {}
    for name, api in APIS.items():
        d = str(tmp_path / name)
        sink = api.LogSink(d, rotate_bytes=0)      # no rotation
        for i in range(3):
            sink.record(_rec(i))
        assert api.read_manifest(d) is None        # nothing committed yet
        sink.flush()
        assert api.read_manifest(d)["records"] == 3
        sink.record(_rec(5))
        sink.close()
        sink.close()                               # no empty shard
        assert len(api.read_manifest(d)["shards"]) == 2
        seen[name] = (sink.stats(), _files(d))
    assert seen["port"] == seen["jax"]


def test_sink_crash_mid_rotation_then_adoption_as_the_reference(tmp_path):
    """The crash lands after the shard is durable and before the manifest
    commits; the next sink adopts the orphan (``logsink_adopt`` on the
    event log) and never reuses its name. Both packages leave the same
    bytes and the same events."""
    seen = {}
    for name, api in APIS.items():
        d, ed = str(tmp_path / name / "sink"), str(tmp_path / name / "ev")
        ev = api.EventLog(ed, wall=lambda: 1.0)
        sink = api.LogSink(d, rotate_bytes=1, events=ev)
        fired = []
        sink.arm_crash_rotate(1, note=fired.append)
        sink.record(_rec(0))
        with pytest.raises(api.InjectedCrash, match="adoption must recover"):
            sink.record(_rec(1))
        assert fired == ["crash_in_log_rotate"]
        assert [s["name"] for s in api.read_manifest(d)["shards"]] == [
            tservelog.shard_name(0)]
        healed = api.LogSink(d, rotate_bytes=1, events=ev)
        assert healed.stats()["adopted_shards"] == 1
        healed.record(_rec(2))
        healed.close()
        ev.close()
        assert api.read_manifest(d)["records"] == 3
        seen[name] = (_files(d), api.read_events(ed))
    assert seen["port"] == seen["jax"]
    assert [e["event"] for e in seen["port"][1]] == [
        "logsink_rotate", "logsink_adopt", "logsink_rotate"]


def _fleet(api, d, **kw):
    clk = _Clock()
    sink = api.LogSink(d, **kw)
    router = api.Router([_FakeSpecEngine(), _FakeSpecEngine()], clock=clk,
                        health=False, log_sink=sink)
    return router, sink, clk


def test_corrupt_log_record_damages_exactly_one_record(tmp_path):
    """``corrupt_log_record@2`` on a fleet of two replicas sharing one
    sink: the sink is armed once; the third record written fails its CRC
    (its body intact) and every other decodes, in both packages, with the
    same bytes."""
    seen = {}
    for name, api in APIS.items():
        d = str(tmp_path / name)
        router, sink, clk = _fleet(api, d, rotate_bytes=0)
        lines = []
        state = api.install(api.Plan.parse("corrupt_log_record@2"), router,
                            sleep=clk.advance, emit=lines.append)
        rids = [router.submit(api.Request(prompt=[i + 1], max_new=3))
                for i in range(5)]
        router.drain()
        sink.close()
        assert state.fired and sink.stats()["injected_corrupt"] == 1
        assert json.loads(lines[-1])["fault_inject"] == "corrupt_log_record"
        assert all(router.poll(r)["status"] == "done" for r in rids)
        seen[name] = _files(d)
    assert seen["port"] == seen["jax"]
    recs = _decoded(str(tmp_path / "port"))
    assert len(recs) == 5 and [r is None for r in recs] == [
        False, False, True, False, False]
    with open(tmp_path / "port" / tservelog.shard_name(0)) as f:
        body = f.read().split("\n")[2].partition(" ")[2]
    assert json.loads(body)["status"] == "done"


def test_crash_in_log_rotate_through_a_fleet_then_adopt(tmp_path):
    """``crash_in_log_rotate@1``: the second rotation raises out of the
    fleet's tick (health off: no replica to blame); a new sink adopts the
    orphan with every record written so far. Same bytes in both."""
    seen = {}
    for name, api in APIS.items():
        d = str(tmp_path / name)
        router, sink, clk = _fleet(api, d, rotate_bytes=1)
        api.install(api.Plan.parse("crash_in_log_rotate@1"), router,
                    sleep=clk.advance, emit=lambda line: None)
        for i in range(4):
            router.submit(api.Request(prompt=[i + 1], max_new=3))
        with pytest.raises(api.InjectedCrash):
            router.drain()
        written = sink.stats()["records"]
        healed = api.LogSink(d, rotate_bytes=1)
        assert healed.stats()["adopted_shards"] == 1
        assert api.read_manifest(d)["records"] == written == 2
        seen[name] = _files(d)
    assert seen["port"] == seen["jax"]


MAX_LEN = 48


def _tree(cfg, seed):
    tree = convert.init_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), tree)


def test_fleet_sink_records_equal_the_reference(tmp_path):
    """Two replicas of the tiny model in float32, one sink each fleet,
    the same greedy requests: the port's directory decodes through the
    reference's reader to the JAX fleet's records (fleet id, replica,
    version, prompt, tokens, counts), all but :data:`WALL_FIELDS`."""
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    tree = _tree(tcfg, 0)
    rng = np.random.default_rng(3)
    reqs = [dict(prompt=rng.integers(0, 128, int(rng.integers(1, 12))
                                     ).tolist(),
                 max_new=int(rng.integers(3, 9))) for _ in range(7)]

    def serve(api, cfg, params, d, **kw):
        sink = api.LogSink(d, rotate_bytes=300)
        router = api.Router.build(cfg, params, n_replicas=2, n_slots=2,
                                  max_len=MAX_LEN, prefill_chunk=5,
                                  log_sink=sink, health=False, **kw)
        router.stamp_version(3)
        rids = [router.submit(api.Request(**r)) for r in reqs]
        router.drain()
        sink.close()
        assert router.stats()["router_log_sink_records"] == 7.0
        return {rid: router.poll(rid)["tokens"] for rid in rids}

    want_rows = serve(J, jcfg, jax.tree.map(jnp.asarray, tree),
                      str(tmp_path / "jax"))
    got_rows = serve(T, tcfg, convert.params_from_flax(tree),
                     str(tmp_path / "port"), device="cpu")
    assert {k: [int(t) for t in v] for k, v in got_rows.items()} == \
        {k: [int(t) for t in v] for k, v in want_rows.items()}

    def records(d):
        m = jservelog.read_manifest(d)
        assert m["records"] == 7 and len(m["shards"]) > 1
        out = []
        for s in m["shards"]:
            with open(os.path.join(d, s["name"])) as f:
                out += [jservelog.decode_record(ln)
                        for ln in f.read().splitlines()]
        assert all(r is not None for r in out)
        return [{k: v for k, v in r.items() if k not in WALL_FIELDS}
                for r in out]

    got, want = records(str(tmp_path / "port")), records(str(tmp_path / "jax"))
    assert got == want
    assert {r["replica"] for r in got} == {0, 1}
    assert all(r["version"] == 3 and r["status"] == "done" for r in got)
    assert sorted(r["rid"] for r in got) == list(range(7))
    for r in got:
        assert r["tokens"] == [int(t) for t in got_rows[r["rid"]]]


@pytest.mark.parametrize("what", ["stream_spec", "distill_draft",
                                  "distill_from", "servelog_source",
                                  "draft_publish_dir"])
def test_the_stream_and_distillation_still_raise(tmp_path, what):
    """The serve log is written now; what reads it is not ported yet and
    says so: the stream source, ``--stream_spec``, ``--distill_*`` and
    the draft-only swap's ``--draft_publish_dir``."""
    base = ["--device=cpu", "--size=tiny", "--batch_size=2",
            "--seq_len=16", "--train_steps=1", f"--logdir={tmp_path}"]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        if what == "servelog_source":
            tservelog.ServeLogSource(str(tmp_path), 8)
        elif what == "draft_publish_dir":
            serve_gpt.run(["--size=tiny", "--device=cpu", "--init_seed=0",
                           "--requests=1,2", f"--draft_publish_dir={tmp_path}"])
        else:
            value = {"stream_spec": "spec.json", "distill_draft": "1",
                     "distill_from": str(tmp_path)}[what]
            train_gpt.run(base + [f"--{what}={value}"])
