"""The weight hot-swap on the port: ``DecodeEngine.swap_params`` and the
router's rolling swap (``dtf_tpu_torch.serve.router``), their fault verbs
and ``serve_gpt --publish_dir --swap_poll_ticks``.

Ported one for one from ``tests/test_serve_swap.py`` (the same scenarios
and assertions, on the port): the page epochs (a cached stem never
serves other weights' KV); the rolling swap on fake engines — versions
stamped while serving, the canary's health and SLO gates rolling back
fleet-wide, a failed probe rolled back too, a failed rollback repaired
before readmission, a forward swap clearing a pending repair, repair
retries backed off without health, the canary's gate past a full TTFT
deque, ``wedge_in_swap`` rolling a partial fleet back onto one version,
the version-skew tripwire, ``start_swap``'s checks; on tiny real engines
— ``swap_params`` bit-equal to fresh weights with ``trace_counts``
pinned, a request spanning the swap finishing on exactly one version,
pages never crossing versions, and the smoke: a tiny ``Trainer``
publishes two versions and a 2-replica fleet rolls twice. From
``tests/test_serve_chaos.py`` (:275, :367, :410): the roll under
speculation with shared pages, a corrupt publish skipped with the fleet
serving on, and the launchers' publish serving with its guarded
fallback.

New here: a swap rebinds one replica's tensors and leaves the others',
and after it the fleet, a self-draft and an early-exit draft hold one set
(``data_ptr``); the version parity: greedy tokens after a roll to a
version the JAX publisher wrote equal the JAX fleet's after the same
roll.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu_torch import convert, serve_gpt, train_gpt
from dtf_tpu_torch.core import train as tr
from dtf_tpu_torch.fault.inject import (FaultPlan, ServeFaultPlan,
                                        corrupt_publish_version)
from dtf_tpu_torch.hooks import PublishHook, StopAtStepHook
from dtf_tpu_torch.loop import Trainer
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch import optim
from dtf_tpu_torch.publish import (ParamPublisher, PublishWatcher,
                                   load_published, read_manifest)
from dtf_tpu_torch.serve import (DecodeEngine, Request, Router, ServeClient,
                                 SwapConfig, install_serve_fault)
from dtf_tpu_torch.serve.health import HealthConfig
from dtf_tpu_torch.serve.pages import PrefixIndex

MAX_LEN = 48
CHAOS_HEALTH = dict(min_slow_s=1000.0, wedge_s=1000.0)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


class _FakeEngine:
    """Host-only engine with the hot-swap surface: tokens depend on the
    param version, so a swap shows in the stream and the stamps are
    checkable without a model."""

    n_slots = 2
    max_len = 64
    prefill_chunk = 64
    spec_k = 0

    def __init__(self):
        self.param_version = 0
        self.counters = {"param_swaps": 0}
        self.params = {"w": 0}
        self.probes = 0

    def prefill_chunk_into(self, slot, prompt, chunk_i, *, start=0, **kw):
        return (int(prompt[0]) + 100 * self.param_version) % 997, False

    def decode(self, **kw):
        return ([1 + self.param_version] * self.n_slots,
                [False] * self.n_slots)

    def probe(self):
        self.probes += 1

    def set_param_version(self, v):
        self.param_version = int(v)

    def swap_params(self, params, *, draft_params=None, version=None):
        self.params = params
        self.param_version = (int(version) if version is not None
                              else self.param_version + 1)
        self.counters["param_swaps"] += 1
        return self.param_version


# ---------------------------------------------------------------------------
# ported: page epochs
# ---------------------------------------------------------------------------

def test_prefix_epoch_gates_lookup_and_invalidate_stale():
    idx = PrefixIndex(4, 2, save_after=1)
    a = idx.reserve((1, 2), None, epoch=0)
    idx.reserve((1, 2, 3, 4), a, epoch=0)
    h0 = idx.acquire((1, 2, 3, 4, 9), epoch=0)
    assert h0 is not None
    idx.release(h0)
    # the same tokens at a new version: a miss — other weights' KV
    assert idx.acquire((1, 2, 3, 4, 9), epoch=1) is None
    assert idx.longest((1, 2, 9), epoch=1) == (0, None)
    b = idx.reserve((1, 2), None, epoch=1)
    assert b is not None and b.epoch == 1
    with pytest.raises(ValueError, match="mix KV"):
        idx.reserve((1, 2, 3, 4), b, epoch=0)
    freed = idx.invalidate_stale(1)
    assert freed == 2
    assert idx.acquire((1, 2, 9), epoch=0) is None
    assert idx.acquire((1, 2, 9), epoch=1) is not None
    assert idx.n_entries == 1
    idx2 = PrefixIndex(4, 2, save_after=2)
    assert idx2.save_eligible((7, 8), 0, 1, epoch=0) == 0
    assert idx2.save_eligible((7, 8), 0, 1, epoch=1) == 0
    assert idx2.save_eligible((7, 8), 0, 1, epoch=1) == 1


# ---------------------------------------------------------------------------
# ported: the rolling swap on fakes
# ---------------------------------------------------------------------------

def _fake_fleet(clk, n=3, **hc):
    cfg = dict(min_slow_s=1.0, wedge_s=5.0, probation_delay_s=1000.0)
    cfg.update(hc)
    return Router([_FakeEngine() for _ in range(n)], clock=clk,
                  health=HealthConfig(**cfg))


def test_rolling_swap_stamps_versions_and_never_stops_serving():
    clk = _Clock()
    r = _fake_fleet(clk)
    rids = [r.submit(Request(prompt=[i + 1], max_new=6)) for i in range(5)]
    for _ in range(2):
        r.tick()
    r.start_swap({"w": 2}, config=SwapConfig(canary_ticks=3))
    assert r.swap_in_progress
    r.drain()
    r.finish_swap()
    st = r.stats()
    assert st["router_version"] == 1.0 and st["router_swaps"] == 1.0
    assert st["router_swap_rollbacks"] == 0.0
    assert all(st[f"replica{i}_version"] == 1.0 for i in range(3))
    for rid in rids:
        p = r.poll(rid)
        assert p["status"] == "done" and p["version"] in (0, 1)
    assert all(s.engine.probes >= 1 for s in r.schedulers)
    rid = r.submit(Request(prompt=[9], max_new=3))
    r.drain()
    assert r.poll(rid)["version"] == 1
    pm = r.postmortem_state()["router"]
    assert pm["version"] == 1 and pm["replica_versions"] == [1, 1, 1]
    assert pm["last_swap"]["outcome"] == "done"
    # the port's timings of each step, on the router's clock
    prof = r.swap_profile()
    assert prof["serve_swap"]["count"] == prof["swap_probe"]["count"] == 3
    assert prof["swap_roll"]["count"] == prof["swap_canary"]["count"] == 1


def test_canary_health_breach_rolls_back_fleet_wide():
    clk = _Clock()
    r = _fake_fleet(clk, n=2)
    r.start_swap({"w": 2}, config=SwapConfig(canary_ticks=4))
    r.tick()
    eng = r.schedulers[0].engine
    orig = eng.decode

    def wedged(**kw):
        clk.advance(9.0)
        return orig(**kw)

    eng.decode = wedged
    rids = [r.submit(Request(prompt=[i + 1], max_new=4)) for i in range(4)]
    r.drain()
    r.finish_swap()
    st = r.stats()
    assert st["router_swap_rollbacks"] == 1.0 and st["router_swaps"] == 0.0
    assert st["router_version"] == 0.0
    assert {st[f"replica{i}_version"] for i in range(2)} == {0.0}
    for rid in rids:
        assert r.poll(rid)["status"] == "done"
    assert "canary" in r._last_swap["cause"]


def test_canary_slo_breach_rolls_back():
    clk = _Clock()
    r = Router([_FakeEngine(), _FakeEngine()], clock=clk,
               health=HealthConfig(min_slow_s=1000.0, wedge_s=1000.0),
               ttft_slo_s=1.0)
    r.start_swap({"w": 2}, config=SwapConfig(canary_ticks=6,
                                             slo_floor=0.9,
                                             slo_min_samples=1))
    r.tick()
    rids = [r.submit(Request(prompt=[i + 1], max_new=3)) for i in range(4)]
    clk.advance(5.0)
    r.drain()
    r.finish_swap()
    st = r.stats()
    assert st["router_swap_rollbacks"] == 1.0
    assert st["router_version"] == 0.0
    assert "SLO" in r._last_swap["cause"]
    for rid in rids:
        assert r.poll(rid)["status"] == "done"


def test_probe_failure_after_swap_rolls_that_replica_back_too():
    clk = _Clock()
    r = _fake_fleet(clk, n=3)
    eng = r.schedulers[2].engine

    def bad_probe():
        if eng.param_version == 1:
            raise RuntimeError("probe wedged after the weights flipped")

    eng.probe = bad_probe
    r.start_swap({"w": 2}, config=SwapConfig(canary_ticks=1))
    r.finish_swap()
    st = r.stats()
    assert st["router_swap_rollbacks"] == 1.0
    assert {st[f"replica{i}_version"] for i in range(3)} == {0.0}, st
    rid = r.submit(Request(prompt=[4], max_new=2))
    r.drain()
    assert r.poll(rid)["status"] == "done"


def test_failed_rollback_replica_repaired_before_readmission():
    clk = _Clock()
    r = _fake_fleet(clk, n=2, probation_delay_s=50.0)
    r.start_swap({"w": 2}, config=SwapConfig(canary_ticks=4))
    r.tick()
    eng = r.schedulers[0].engine
    orig_swap = eng.swap_params
    fails = [1]

    def flaky_swap(params, **kw):
        if fails[0] and kw.get("version") == 0:
            fails[0] -= 1
            raise RuntimeError("reverse swap wedged")
        return orig_swap(params, **kw)

    eng.swap_params = flaky_swap
    orig_decode = eng.decode

    def wedged(**kw):
        clk.advance(9.0)
        return orig_decode(**kw)

    eng.decode = wedged
    rids = [r.submit(Request(prompt=[i + 1], max_new=3)) for i in range(4)]
    r.drain()
    r.finish_swap()
    st = r.stats()
    assert st["router_swap_rollbacks"] == 1.0
    assert st["replica0_version"] == 1.0
    pm = r.postmortem_state()["router"]
    assert pm["version_repair_pending"] == [0]
    for rid in rids:
        assert r.poll(rid)["status"] == "done"
    rid = r.submit(Request(prompt=[7], max_new=2))
    r.drain()
    assert r.poll(rid)["version"] == 0
    eng.decode = orig_decode
    clk.advance(60.0)
    for _ in range(4):
        r.tick()
    st = r.stats()
    assert {st[f"replica{i}_version"] for i in range(2)} == {0.0}, st
    assert r.postmortem_state()["router"]["version_repair_pending"] == []


def test_forward_swap_clears_pending_repair():
    clk = _Clock()
    r = _fake_fleet(clk, n=2, probation_delay_s=50.0)
    r.schedulers[1].engine.param_version = 1
    r._version_repair[1] = ({"w": 0}, None, 0)
    r.start_swap({"w": 3}, version=2, config=SwapConfig(canary_ticks=1))
    r.finish_swap()
    st = r.stats()
    assert st["router_version"] == 2.0
    assert {st[f"replica{i}_version"] for i in range(2)} == {2.0}
    assert r.postmortem_state()["router"]["version_repair_pending"] == []
    for _ in range(3):
        r.tick()
    assert {s.engine.param_version for s in r.schedulers} == {2}


def test_repair_retries_are_backed_off_without_health():
    r = Router([_FakeEngine(), _FakeEngine()], clock=_Clock(),
               health=False)
    eng = r.schedulers[1].engine
    calls = [0]

    def bad_swap(params, **kw):
        calls[0] += 1
        raise RuntimeError("still broken")

    eng.swap_params = bad_swap
    r._version_repair[1] = ({"w": 0}, None, 0)
    for _ in range(64):
        r.tick()
    assert 0 < calls[0] <= 8, calls[0]
    assert not r._routable(1)


def test_canary_slo_gate_survives_bounded_ttft_deque():
    clk = _Clock()
    r = Router([_FakeEngine(), _FakeEngine()], clock=clk,
               health=HealthConfig(min_slow_s=1000.0, wedge_s=1000.0),
               ttft_slo_s=1.0, completed_cap=4)
    for i in range(10):
        r.submit(Request(prompt=[i + 1], max_new=1))
    r.drain()
    assert all(len(s._ttfts) == 4 and s.ttft_count >= 4
               for s in r.schedulers)
    r.start_swap({"w": 2}, config=SwapConfig(canary_ticks=6,
                                             slo_floor=0.9,
                                             slo_min_samples=1))
    r.tick()
    rids = [r.submit(Request(prompt=[i + 1], max_new=2)) for i in range(4)]
    clk.advance(5.0)
    r.drain()
    r.finish_swap()
    st = r.stats()
    assert st["router_swap_rollbacks"] == 1.0, st
    assert st["router_version"] == 0.0
    for rid in rids:
        assert r.poll(rid)["status"] == "done"


def test_wedge_in_swap_rolls_partial_fleet_back_to_one_version():
    clk = _Clock()
    r = _fake_fleet(clk, n=3)
    plan = ServeFaultPlan.parse("wedge_in_swap@0:replica=2")
    state = install_serve_fault(plan, r, sleep=clk.advance, wedge_s=0.5,
                                emit=lambda line: None)
    r.start_swap({"w": 2}, config=SwapConfig(canary_ticks=1))
    rids = [r.submit(Request(prompt=[i + 1], max_new=4)) for i in range(4)]
    r.drain()
    r.finish_swap()
    assert state.fired
    st = r.stats()
    assert st["router_swap_rollbacks"] == 1.0
    assert {st[f"replica{i}_version"] for i in range(3)} == {0.0}
    assert st["router_version"] == 0.0
    for rid in rids:
        assert r.poll(rid)["status"] == "done"
    r.start_swap({"w": 3}, config=SwapConfig(canary_ticks=1))
    r.finish_swap()
    assert r.stats()["router_version"] == 1.0


def test_version_skew_tripwire_warns_once_rearmed(caplog):
    r = Router([_FakeEngine(), _FakeEngine()], clock=_Clock(),
               health=HealthConfig())
    with caplog.at_level(logging.WARNING, logger="dtf_tpu_torch"):
        r.stats()
        assert not [m for m in caplog.messages if "skew" in m]
        r.schedulers[1].engine.param_version = 7
        r.stats()
        r.stats()
        assert len([m for m in caplog.messages
                    if "spans param versions" in m]) == 1
        r.schedulers[0].engine.param_version = 7
        r.stats()
        r.schedulers[1].engine.param_version = 8
        r.stats()
        assert len([m for m in caplog.messages
                    if "spans param versions" in m]) == 2
    r.schedulers[1].engine.param_version = 7
    r._swap = {"version": 9}
    with caplog.at_level(logging.WARNING, logger="dtf_tpu_torch"):
        caplog.clear()
        r._skew_check()
        assert not caplog.messages
    r._swap = None


def test_start_swap_validation():
    r = Router([_FakeEngine(), _FakeEngine()], clock=_Clock(),
               health=HealthConfig())
    r.stamp_version(5)
    with pytest.raises(ValueError, match="monotone"):
        r.start_swap({"w": 1}, version=5)
    single = Router([_FakeEngine()])
    with pytest.raises(ValueError, match=">= 2 replicas"):
        single.start_swap({"w": 1})
    r.start_swap({"w": 1})
    with pytest.raises(RuntimeError, match="already in progress"):
        r.start_swap({"w": 2})
    with pytest.raises(ValueError, match="canary_ticks"):
        SwapConfig(canary_ticks=0)
    with pytest.raises(ValueError, match="slo_floor"):
        SwapConfig(slo_floor=1.5)
    env = {"DTF_FAULT_INJECT": "wedge_in_swap@0:replica=1"}
    assert FaultPlan.from_env(env=env) is None
    assert ServeFaultPlan.from_env(env=env).kind == "wedge_in_swap"
    env = {"DTF_FAULT_INJECT": "crash_in_publish@4"}
    assert FaultPlan.from_env(env=env).kind == "crash_in_publish"
    assert ServeFaultPlan.from_env(env=env) is None


# ---------------------------------------------------------------------------
# real tiny engines
# ---------------------------------------------------------------------------

def _flax_tree(cfg, seed):
    tree = convert.init_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def tiny():
    """The tiny f32 config, three state dicts (seeds 0-2), and a batch-1
    reference model for each (``generate`` with the engine's sampler)."""
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    sds, models = [], []
    for seed in range(3):
        sd = convert.params_from_flax(_flax_tree(cfg, seed))
        model = tgpt.GPT(dataclasses.replace(cfg, decode_len=MAX_LEN),
                         device="cpu")
        model.load_state_dict(sd)
        sds.append(sd)
        models.append(model.eval())
    return cfg, sds, models


def _offline(model, req):
    out = tgpt.generate(
        model, torch.tensor([req["prompt"]]), req["max_new"],
        seed=req.get("seed", 0), temperature=req.get("temperature", 0.0))
    return out[0, len(req["prompt"]):].tolist()


def _build(cfg, sd, n=2, **kw):
    return Router.build(cfg, sd, n_replicas=n, n_slots=2, max_len=MAX_LEN,
                        prefill_chunk=5, clock=_Clock(),
                        health=HealthConfig(**CHAOS_HEALTH), device="cpu",
                        **kw)


def _ptrs(module) -> dict:
    return {n: p.data_ptr() for n, p in module.named_parameters()}


def test_engine_swap_params_bitwise_and_trace_counts_pinned(tiny):
    cfg, (p0, p1, _), (m0, m1, _) = tiny
    eng = DecodeEngine(cfg, p0, n_slots=2, max_len=MAX_LEN, prefill_chunk=5,
                       device="cpu")
    client = ServeClient(eng)
    req = dict(prompt=[3, 1, 4, 1, 5], max_new=6, seed=7, temperature=0.8)
    assert client.result(client.submit(**req)) == _offline(m0, req)
    eng.swap_params(p1, version=1)
    assert eng.param_version == 1
    assert client.result(client.submit(**req)) == _offline(m1, req)
    greedy = dict(prompt=[2, 7, 2], max_new=5)
    assert client.result(client.submit(**greedy)) == _offline(m1, greedy)
    assert eng.trace_counts == {"prefill": 1, "decode": 1}
    assert eng.counters["param_swaps"] == 1
    bad = dict(p1)
    bad.pop(next(iter(p1)))
    with pytest.raises(ValueError, match="tree structure"):
        eng.swap_params(bad)
    with pytest.raises(ValueError, match="leaf"):
        eng.swap_params({n: x[..., None] for n, x in p1.items()})
    with pytest.raises(ValueError, match="leaf"):
        eng.swap_params({n: x.double() for n, x in p1.items()})
    assert eng.param_version == 1 and eng.counters["param_swaps"] == 1


def test_a_swap_rebinds_one_replica_and_drafts_share_the_new_set(tiny):
    """The fleet shares one set of tensors: swapping replica 0 must
    rebind ITS module and leave replica 1 on the old set (a copy into the
    shared tensors would flip both). After the roll the replicas, a
    self-draft and an early-exit draft's shared layers hold ONE set
    again, the new one; a distinct draft keeps its own."""
    cfg, (p0, p1, p2), _ = tiny
    r = _build(cfg, p0, draft_cfg=cfg, draft_params=p0, spec_k=2)
    engs = [s.engine for s in r.schedulers]
    old = _ptrs(engs[1]._model)
    assert _ptrs(engs[0]._model) == old == _ptrs(engs[0]._draft_model)
    placed, _ = engs[0].place(p1)
    engs[0].swap_params(placed, version=1)
    assert _ptrs(engs[1]._model) == old == _ptrs(engs[1]._draft_model)
    new = _ptrs(engs[0]._model)
    assert all(new[n] != old[n] for n in new)
    assert _ptrs(engs[0]._draft_model) == new
    assert all(torch.equal(engs[0].params[n], p1[n]) for n in p1)
    engs[0].swap_params(engs[1].params, version=0)     # back
    r.start_swap(p2, config=SwapConfig(canary_ticks=1))
    r.finish_swap()
    ptrs = [_ptrs(e._model) for e in engs] + [_ptrs(e._draft_model)
                                              for e in engs]
    assert all(p == ptrs[0] for p in ptrs) and ptrs[0] != old
    assert r.trace_counts() == [{"prefill": 1, "decode": 1,
                                 "draft_prefill": 1, "draft": 1}] * 2

    dcfg, dsd = tgpt.draft_truncate(cfg, p0, 1)
    early = _build(cfg, p0, draft_cfg=dcfg, draft_params=dsd, spec_k=2)
    early.start_swap(p1, config=SwapConfig(canary_ticks=1))
    early.finish_swap()
    for s in early.schedulers:
        target = _ptrs(s.engine._model)
        assert _ptrs(s.engine._draft_model) == {
            n: target[n] for n in _ptrs(s.engine._draft_model)}
        assert torch.equal(s.engine.draft_params["lm_head.weight"],
                           p1["lm_head.weight"])

    distinct = _build(cfg, p0, draft_cfg=dcfg,
                      draft_params={n: x.clone() for n, x in dsd.items()},
                      spec_k=2)
    kept = _ptrs(distinct.schedulers[0].engine._draft_model)
    distinct.start_swap(p1, config=SwapConfig(canary_ticks=1))
    distinct.finish_swap()
    assert _ptrs(distinct.schedulers[0].engine._draft_model) == kept


def test_request_spanning_swap_completes_on_exactly_one_version(tiny):
    cfg, (p0, p1, _), (m0, m1, _) = tiny
    router = _build(cfg, p0)
    req = dict(prompt=[5, 3, 1], max_new=8, seed=11, temperature=0.6)
    rid = router.submit(Request(**req))
    for _ in range(3):
        router.tick()
    router.start_swap(p1, version=1, config=SwapConfig(canary_ticks=1))
    router.drain()
    router.finish_swap()
    p = router.poll(rid)
    assert p["status"] == "done" and p["version"] in (0, 1)
    assert p["tokens"] == _offline({0: m0, 1: m1}[p["version"]], req)
    assert router.trace_counts() == [{"prefill": 1, "decode": 1}] * 2


def test_pages_never_serve_stale_weight_kv(tiny):
    cfg, (p0, p1, _), (m0, m1, _) = tiny
    router = Router.build(cfg, p0, n_replicas=2, n_slots=2, max_len=MAX_LEN,
                          prefill_chunk=4, kv_page_size=4, prefix_pages=8,
                          page_save_after=1, clock=_Clock(),
                          health=HealthConfig(), device="cpu")
    req = dict(prompt=list(range(1, 13)), max_new=4, seed=3)
    for s in router.schedulers:
        warm = s.submit(Request(**req))
        s.run_until_idle()
        assert s.poll(warm)["status"] == "done"
    probe = router.schedulers[1].submit(Request(**req))
    router.schedulers[1].run_until_idle()
    assert router.schedulers[1].poll(probe)["tokens"] == _offline(m0, req)
    hits0 = sum(s.engine.counters["pages_loaded"]
                for s in router.schedulers)
    assert hits0 >= 2
    router.start_swap(p1, version=1, config=SwapConfig(canary_ticks=1))
    router.finish_swap()
    rid = router.submit(Request(**req))
    router.drain()
    p = router.poll(rid)
    assert p["version"] == 1
    assert p["tokens"] == _offline(m1, req)
    assert sum(s.engine.counters["pages_loaded"]
               for s in router.schedulers) == hits0
    for s in router.schedulers:
        assert s.engine.prefix_stats()["pinned"] == 0
    stats = router.schedulers[0].engine.prefix_stats()
    assert stats["pages"] <= 3


def test_swap_smoke_trainer_publishes_fleet_rolls_twice(tiny, tmp_path):
    """A tiny real Trainer publishes 2 versions through PublishHook; a
    2-replica fleet starts on the built weights and rolls twice to them
    while serving — no request ends shed, timed out or in error, every
    record is stamped, and the streams after the roll equal a fresh fleet
    on the published version."""
    cfg, (p0, _, _), _ = tiny
    pub_dir = str(tmp_path / "publish")
    model = tgpt.GPT(cfg, device="cpu")
    model.load_state_dict(p0)

    def loss_fn(params, batch, rng):
        s = sum((x.float() ** 2).mean() for x in params.values())
        return s * batch["x"][0], tr.LossAux()

    tx = optim.sgd(0.05)
    state = tr.create_train_state(model, tx, 0)
    step = tr.make_train_step(loss_fn, tx)
    publisher = ParamPublisher(pub_dir)

    def train_to(state, stop):
        trainer = Trainer(step, "cpu", [PublishHook(publisher, every_n=2),
                                        StopAtStepHook(stop)])
        batches = ({"x": np.ones((1,), np.float32)} for _ in iter(int, 1))
        return trainer.fit(state, batches, max_steps=stop)

    router = _build(cfg, p0)
    watcher = PublishWatcher(pub_dir, applied_version=0)
    swap_cfg = SwapConfig(canary_ticks=2)
    rng = np.random.default_rng(5)
    reqs = [dict(prompt=rng.integers(0, 128,
                                     int(rng.integers(1, 10))).tolist(),
                 max_new=int(rng.integers(2, 7)),
                 temperature=0.0 if i % 2 else 0.7, seed=60 + i)
            for i in range(8)]
    rids, rolled = [], 0
    for i, r in enumerate(reqs):
        rids.append(router.submit(Request(**r)))
        router.tick()
        if i in (1, 4):
            state = train_to(state, 2 * (rolled + 1))
            assert read_manifest(pub_dir)["version"] == rolled + 1
            assert router.maybe_swap_published(
                watcher, config=swap_cfg) == rolled + 1
            rolled += 1
            router.finish_swap()
    router.drain()
    st = router.stats()
    assert st["router_swaps"] == 2.0 and st["router_swap_rollbacks"] == 0.0
    assert st["router_version"] == 2.0
    assert watcher.applied_version == 2
    versions = []
    for rid in rids:
        p = router.poll(rid)
        assert p["status"] == "done", p
        versions.append(p["version"])
    assert set(versions) <= {0, 1, 2}
    assert versions[-1] == 2
    assert router.trace_counts() == [{"prefill": 1, "decode": 1}] * 2
    v2, _, params2 = load_published(pub_dir, version=2)
    fresh = _build(cfg, params2)
    fresh.stamp_version(v2)
    for r, rid, v in zip(reqs, rids, versions):
        if v != 2:
            continue
        frid = fresh.submit(Request(**r))
        fresh.drain()
        assert fresh.result(frid) == router.poll(rid)["tokens"], r


# ---------------------------------------------------------------------------
# ported from tests/test_serve_chaos.py: the roll under load and faults
# ---------------------------------------------------------------------------

def test_chaos_rolling_swap_spec_and_shared_pages_bitwise(tiny):
    """3 replicas with speculation (a self-draft) and a shared page store
    (one prefill replica), rolled to new weights mid-traffic: all done,
    the streams bit-equal to batch-1 generation at the stamped version
    and to a fresh fleet at the new one, no page pinned, every step
    function built once."""
    cfg, (p0, p1, _), (m0, m1, _) = tiny

    def fleet(p):
        return Router.build(cfg, p, n_replicas=3, n_slots=2,
                            max_len=MAX_LEN, prefill_chunk=4,
                            kv_page_size=4, prefix_pages=12,
                            prefill_replicas=1, draft_cfg=cfg,
                            draft_params=p, spec_k=2,
                            health=HealthConfig(**CHAOS_HEALTH),
                            device="cpu")

    router = fleet(p0)
    stem = list(range(1, 9))
    rng = np.random.default_rng(3)
    reqs = [dict(prompt=stem + rng.integers(0, 128, 4).tolist(),
                 max_new=int(rng.integers(3, 7)),
                 temperature=0.0 if i % 2 else 0.8, seed=40 + i)
            for i in range(8)]
    rids = []
    for r in reqs[:5]:
        rids.append(router.submit(Request(**r)))
        router.tick()
    router.start_swap(p1, version=1, config=SwapConfig(canary_ticks=2))
    for r in reqs[5:]:
        rids.append(router.submit(Request(**r)))
        router.tick()
    router.drain()
    router.finish_swap()
    st = router.stats()
    assert st["router_swaps"] == 1.0 and st["router_swap_rollbacks"] == 0.0
    assert all(st[f"replica{i}_version"] == 1.0 for i in range(3)), st
    polls = [router.poll(rid) for rid in rids]
    assert all(p["status"] == "done" for p in polls)
    for r, p in zip(reqs, polls):
        assert p["version"] in (0, 1)
        assert p["tokens"] == _offline({0: m0, 1: m1}[p["version"]], r), r
    for s in router.schedulers:
        assert s.engine.prefix_stats().get("pinned", 0) == 0
    want = {"prefill": 1, "decode": 1}
    for i, tc in enumerate(router.trace_counts()):
        base = {k: v for k, v in tc.items() if not k.startswith("page_")}
        assert base == (want if i == 0 else
                        {**want, "draft_prefill": 1, "draft": 1}), tc
    fresh = fleet(p1)
    fresh.stamp_version(1)
    for r, p in zip(reqs, polls):
        if p["version"] != 1:
            continue
        frid = fresh.submit(Request(**r))
        fresh.drain()
        assert fresh.result(frid) == p["tokens"], r


def test_chaos_corrupt_publish_fleet_keeps_serving(tiny, tmp_path, caplog):
    """corrupt_publish: the watcher's digest check skips a damaged publish
    with ONE warning; the fleet keeps its version and a later clean
    publish rolls normally."""
    cfg, (p0, _, p2), (m0, _, m2) = tiny
    pub = ParamPublisher(str(tmp_path))
    v1 = pub.publish(10, p0)
    router = _build(cfg, p0)
    router.stamp_version(v1)
    watcher = PublishWatcher(str(tmp_path), applied_version=v1)
    state = install_serve_fault(ServeFaultPlan.parse("corrupt_publish@0"),
                                router, watcher=watcher,
                                emit=lambda line: None)
    pub.publish(20, {n: x + 1.0 for n, x in p0.items()})   # v2, damaged
    with caplog.at_level(logging.WARNING, logger="dtf_tpu_torch"):
        assert router.maybe_swap_published(watcher) is None
        assert router.maybe_swap_published(watcher) is None
    assert state.fired and watcher.skipped == {2}
    assert len([r for r in caplog.records if "skipping" in r.message]) == 1
    reqs = [dict(prompt=[7, 1, 8], max_new=4), dict(prompt=[3], max_new=5)]
    rids = [router.submit(Request(**r)) for r in reqs]
    router.drain()
    for r, rid in zip(reqs, rids):
        p = router.poll(rid)
        assert p["version"] == v1 and p["tokens"] == _offline(m0, r)
    assert router.stats()["router_version"] == float(v1)
    v3 = pub.publish(30, p2)
    assert router.maybe_swap_published(
        watcher, config=SwapConfig(canary_ticks=1)) == v3
    router.finish_swap()
    assert router.stats()["router_version"] == float(v3)
    rid = router.submit(Request(**reqs[0]))
    router.drain()
    assert router.poll(rid)["tokens"] == _offline(m2, reqs[0])


_SERVE = ["--device=cpu", "--replicas=2", "--n_slots=2", "--max_len=48",
          "--prefill_chunk=5", "--requests=5,9,2;1,2,3,4;7;8,8;6,5,4",
          "--n_new=4", "--emit_tokens"]


def test_chaos_launcher_publish_serving_and_guarded_fallback(tmp_path,
                                                             monkeypatch):
    """``train_gpt --publish_dir`` publishes versions; ``serve_gpt
    --publish_dir`` serves the newest, rolls 1 → 2 live with
    ``--swap_poll_ticks``, serves the older one (guarded walk) when the
    newest is corrupt, and refuses a corrupt version named explicitly.
    ``crash_in_publish`` on the trainer leaves the manifest where it
    was."""
    pub = str(tmp_path / "publish")
    flags = ["--device=cpu", "--size=tiny", "--batch_size=4",
             "--seq_len=32", "--checkpoint_every=2", f"--logdir={tmp_path}",
             f"--publish_dir={pub}", "--publish_every=2"]
    train_gpt.run(flags + ["--train_steps=4"])
    assert read_manifest(pub)["version"] == 2

    out, rows, _ = serve_gpt.run(_SERVE + [f"--publish_dir={pub}"])
    assert out["served_version"] == 2 and out["final_version"] == 2
    assert out["request_statuses"] == {"done": 5}
    assert all(out[f"replica{i}_version"] == 2.0 for i in range(2))

    out, rolled, router = serve_gpt.run(
        _SERVE + [f"--publish_dir={pub}", "--publish_version=1",
                  "--swap_poll_ticks=2", "--canary_ticks=2"])
    assert out["served_version"] == 1 and out["final_version"] == 2
    assert out["router_swaps"] == 1.0
    assert out["request_statuses"] == {"done": 5}
    for rid, row in enumerate(rolled):
        if router.poll(rid)["version"] == 2:
            assert row == rows[rid]

    monkeypatch.setenv("DTF_FAULT_INJECT", "crash_in_publish@6")
    with pytest.raises(Exception, match="mid-publish"):
        train_gpt.run(flags + ["--train_steps=6"])
    monkeypatch.delenv("DTF_FAULT_INJECT")
    assert read_manifest(pub)["version"] == 2

    corrupt_publish_version(pub, 2)
    out, _, _ = serve_gpt.run(_SERVE + [f"--publish_dir={pub}"])
    assert out["served_version"] == 1
    assert out["request_statuses"] == {"done": 5}
    with pytest.raises(SystemExit):
        serve_gpt.run(_SERVE + [f"--publish_dir={pub}",
                                "--publish_version=2"])
    for bad in (["--publish_version=1"], ["--swap_poll_ticks=2"],
                [f"--publish_dir={pub}", "--swap_poll_ticks=2",
                 "--replicas=1"],
                [f"--publish_dir={pub}", "--init_seed=0"]):
        with pytest.raises(SystemExit):
            serve_gpt.run(_SERVE + bad)


# ---------------------------------------------------------------------------
# new: parity with the JAX fleet on a JAX-published version
# ---------------------------------------------------------------------------

def test_roll_to_a_jax_published_version_equals_the_jax_fleet(tmp_path):
    """The JAX publisher writes versions 1 and 2; the test loads them
    through ``dtf_tpu.publish.load_published``, converts them and
    republishes them with the port's publisher (their manifests laid out
    alike). A JAX fleet and a port fleet each start on version 1, roll to
    2 through their watchers, and serve the same greedy requests: equal
    tokens, every record stamped 2."""
    from dtf_tpu.models import gpt as jgpt
    from dtf_tpu.publish import ParamPublisher as JPublisher
    from dtf_tpu.publish import PublishWatcher as JWatcher
    from dtf_tpu.publish import load_published as jload
    from dtf_tpu.serve import Request as JRequest
    from dtf_tpu.serve import Router as JRouter
    from dtf_tpu.serve import SwapConfig as JSwapConfig
    from dtf_tpu.serve.health import HealthConfig as JHealthConfig

    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpub = JPublisher(jdir, wall=lambda: 5.0)
    tpub = ParamPublisher(tdir, wall=lambda: 5.0)
    for seed in (0, 1):
        jpub.publish(10 * (seed + 1),
                     jax.tree.map(jnp.asarray, _flax_tree(tcfg, seed)))
    for v in (1, 2):
        _, step, tree = jload(jdir, version=v)
        tpub.publish(step, convert.params_from_flax(
            jax.tree.map(np.asarray, tree)))
    jm, tm = read_manifest(jdir), read_manifest(tdir)
    assert sorted(tm) == sorted(jm)
    assert {k: tm[k] for k in ("schema", "version", "step", "published_t")} \
        == {k: jm[k] for k in ("schema", "version", "step", "published_t")}
    assert {v: sorted(h) for v, h in tm["history"].items()} == \
        {v: sorted(h) for v, h in jm["history"].items()}

    reqs = [dict(prompt=[5, 9, 2], max_new=6), dict(prompt=[1, 2, 3, 4],
                                                    max_new=5),
            dict(prompt=[7], max_new=7)]

    def roll(api, cfg, watcher, params, **kw):
        router = api["Router"].build(
            cfg, params, n_replicas=2, n_slots=2, max_len=MAX_LEN,
            prefill_chunk=5, clock=_Clock(),
            health=api["Health"](**CHAOS_HEALTH), **kw)
        router.stamp_version(1)
        assert router.maybe_swap_published(
            watcher, config=api["Swap"](canary_ticks=2)) == 2
        router.finish_swap()
        rids = [router.submit(api["Request"](**r)) for r in reqs]
        router.drain()
        polls = [router.poll(rid) for rid in rids]
        assert [p["version"] for p in polls] == [2] * len(reqs)
        return [[int(t) for t in p["tokens"]] for p in polls]

    want = roll({"Router": JRouter, "Health": JHealthConfig,
                 "Swap": JSwapConfig, "Request": JRequest}, jcfg,
                JWatcher(jdir, applied_version=1), jload(jdir, 1)[2])
    got = roll({"Router": Router, "Health": HealthConfig,
                "Swap": SwapConfig, "Request": Request}, tcfg,
               PublishWatcher(tdir, applied_version=1),
               load_published(tdir, 1)[2], device="cpu")
    assert got == want
