"""The port's serving fleet (``dtf_tpu_torch.serve.router.Router``)
against the JAX package's, on the CPU at ``GPTConfig.tiny`` in float32
(2 replicas of 2 slots of 48, chunk 5), with the same seeded numpy
weights and one injected clock.

ONE script runs on a router of each package (each built once for the
file): admission on an empty fleet and with a busy replica, mixed greedy
and sampled traffic, a forced quarantine mid-flight (requeue), probation
probes that readmit the replica, a ``wedge_replica`` plan that quarantines
the other replica through the watchdog, and a fleet with no routable
replica shedding at the front door. ``replica_of`` is equal request by
request, greedy tokens equal JAX's (sampled ones the port's batch-1
``generate``, whose sampler the engine shares), requeued streams equal
the fault-free ones, and ``stats()``, the health states, transitions and
the shed's ``retry_after_s`` equal JAX's. The replicas share one set of
weight tensors.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.fault import inject as jinject
from dtf_tpu.models import gpt as jgpt
from dtf_tpu.serve import Request as JRequest
from dtf_tpu.serve import Router as JRouter
from dtf_tpu.serve import router as jrouter
from dtf_tpu.serve import health as jhealth
from dtf_tpu_torch import convert
from dtf_tpu_torch.fault import inject as tinject
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.serve import Request, Router, SwapConfig
from dtf_tpu_torch.serve import health as thealth

MAX_LEN, SLOTS, CHUNK = 48, 2, 5
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
HEALTH = dict(min_slow_s=1.0, wedge_s=5.0, probation_delay_s=50.0,
              probation_ticks=2)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _tree(cfg, seed):
    tree = convert.init_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), tree)


def _traffic(seed, n=6):
    """Seeded requests: odd ones greedy, even ones sampled."""
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, 128, int(rng.integers(1, 14))
                                     ).tolist(),
                 max_new=int(rng.integers(3, 9)), seed=40 + i,
                 **({} if i % 2 else SAMPLED)) for i in range(n)]


def _pump(router, clock, max_ticks=500):
    for _ in range(max_ticks):
        if not router.pending:
            return
        router.tick()
        clock.advance(0.01)
    raise RuntimeError("fleet did not drain")


def _script(api, cfg, params, **build_kw):
    """The scenario, on one package's router; returns what it saw."""
    clock = _Clock()
    router = api.Router.build(
        cfg, params, n_replicas=2, n_slots=SLOTS, max_len=MAX_LEN,
        prefill_chunk=CHUNK, clock=clock, ttft_slo_s=0.05,
        health=api.health.HealthConfig(**HEALTH), **build_kw)
    seen = {"router": router}

    def run(reqs, *, mid=None):
        rids = [router.submit(api.Request(**r)) for r in reqs]
        if mid is not None:
            for _ in range(2):
                router.tick()
                clock.advance(0.01)
            mid()
        _pump(router, clock)
        return {"replica_of": [router.replica_of(r) for r in rids],
                "tokens": [router.result(r) for r in rids]}

    # admission: queue depth alternates an empty fleet; a busy replica
    # sends the next request to the other
    seen["empty"] = run([dict(prompt=[1 + i], max_new=4) for i in range(4)])
    busy = router.schedulers[0].submit(api.Request(prompt=[9], max_new=30))
    router.schedulers[0].tick()
    nxt = router.submit(api.Request(prompt=[5], max_new=2))
    seen["busy"] = router.replica_of(nxt)
    _pump(router, clock)
    assert router.schedulers[0].poll(busy)["status"] == "done"
    seen["traffic"] = run(_traffic(1))
    # a forced quarantine of replica 0 two ticks into the traffic
    seen["quarantine"] = run(
        _traffic(1), mid=lambda: router.quarantine(0, "test"))
    seen["after_quarantine"] = router.health.states()
    # past the delay: idle probation probes readmit replica 0
    clock.advance(60.0)
    for _ in range(3):
        router.tick()
    seen["after_probation"] = router.health.states()
    # replica 1 wedges from its 3rd decode from now: 6 s a call >= the
    # 5 s wedge bar quarantines it on the spot
    api.install(api.Plan("wedge_replica", 2, replica=1), router,
                sleep=clock.advance, wedge_s=6.0, emit=lambda line: None)
    seen["wedge"] = run(_traffic(2))
    seen["after_wedge"] = router.health.states()
    # nothing routable: shed at the door with the earliest probation ETA
    router.quarantine(0, "test")
    rid = router.submit(api.Request(prompt=[3, 4], max_new=2))
    seen["shed"] = router.poll(rid)
    seen["postmortem"] = router.postmortem_state()
    seen["stats"] = router.stats()
    seen["transitions"] = list(router.health.transitions)
    seen["trace_counts"] = router.trace_counts()
    return seen


@pytest.fixture(scope="module")
def runs():
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    tree = _tree(tcfg, 0)
    jax_api = types.SimpleNamespace(
        Router=JRouter, Request=JRequest, health=jhealth,
        install=jhealth.install_serve_fault, Plan=jinject.ServeFaultPlan)
    port_api = types.SimpleNamespace(
        Router=Router, Request=Request, health=thealth,
        install=thealth.install_serve_fault, Plan=tinject.ServeFaultPlan)
    want = _script(jax_api, jgpt.GPTConfig.tiny(dtype=jnp.float32), tree)
    state_dict = convert.params_from_flax(tree)
    got = _script(port_api, tcfg, state_dict, device="cpu")
    model = tgpt.GPT(tgpt.GPTConfig.tiny(dtype=torch.float32,
                                         decode_len=MAX_LEN), device="cpu")
    model.load_state_dict(state_dict)
    return want, got, model.eval()


PHASES = ("empty", "traffic", "quarantine", "wedge")


def test_replica_of_equals_jax(runs):
    want, got, _ = runs
    assert got["empty"]["replica_of"] == [0, 1, 0, 1]
    assert got["busy"] == want["busy"] == 1          # least occupancy
    for phase in PHASES:
        assert got[phase]["replica_of"] == want[phase]["replica_of"], phase
    # the forced quarantine moved all of replica 0's work to replica 1;
    # replica 1 finished some requests before its wedge
    assert set(got["quarantine"]["replica_of"]) == {1}
    assert 0 in got["wedge"]["replica_of"]


def _batch1(model, req):
    out = tgpt.generate(
        model, torch.tensor([req["prompt"]]), req["max_new"],
        seed=req["seed"], temperature=req.get("temperature", 0.0),
        top_k=req.get("top_k", 0), top_p=req.get("top_p", 1.0))
    return out[0, len(req["prompt"]):].tolist()


@pytest.mark.parametrize("phase", PHASES)
def test_greedy_tokens_equal_jax_sampled_equal_batch1(runs, phase):
    """Quarantined and wedged phases included: a requeued request's
    stream is the fault-free one."""
    want, got, model = runs
    reqs = ([dict(prompt=[1 + i], max_new=4, seed=0) for i in range(4)]
            if phase == "empty" else
            _traffic(2) if phase == "wedge" else _traffic(1))
    for req, a, b in zip(reqs, got[phase]["tokens"], want[phase]["tokens"]):
        if req.get("temperature", 0.0) == 0.0:
            assert a == b, (phase, req)
        assert a == _batch1(model, req), (phase, req)
    if phase == "quarantine":
        assert got[phase]["tokens"] == got["traffic"]["tokens"]


def test_requeue_counts_and_health_equal_jax(runs):
    want, got, _ = runs
    for key in ("after_quarantine", "after_probation", "after_wedge",
                "transitions"):
        assert got[key] == want[key], key
    assert got["after_probation"] == ["healthy", "healthy"]
    assert got["after_wedge"] == ["healthy", "quarantined"]
    st = got["stats"]
    assert st["replica1_serve_requeued_in"] > 0            # the forced one
    assert st["replica0_serve_requeued_in"] > 0            # the wedge
    assert st["router_requeued"] == (st["replica0_serve_requeued_in"]
                                     + st["replica1_serve_requeued_in"])
    assert st["router_probe_decodes"] >= HEALTH["probation_ticks"]


def test_stats_equal_jax(runs):
    """Every key and value of ``stats()`` under the injected clock: the
    counters, TTFTs, SLO fractions, per-replica panel and the zero
    control-plane profile of a clock that does not move inside a tick."""
    want, got, _ = runs
    assert got["stats"] == want["stats"]
    assert got["stats"]["router_quarantines"] == 3.0


def test_postmortem_state_equals_jax(runs):
    """The per-replica in-flight records and the router's counters and
    health panel (the reference adds its hot-swap keys)."""
    want, got, _ = runs
    for i in range(2):
        assert got["postmortem"][f"replica{i}"] == \
            want["postmortem"][f"replica{i}"]
    router = got["postmortem"]["router"]
    assert router == {k: want["postmortem"]["router"][k] for k in router}
    assert router["requeued"] > 0 and router["health"] == ["quarantined"] * 2


def test_front_door_shed_with_retry_after(runs):
    want, got, _ = runs
    assert got["shed"]["status"] == "shed"
    assert got["shed"] == want["shed"]
    assert 0 < got["shed"]["retry_after_s"] <= HEALTH["probation_delay_s"]


def test_trace_counts_equal_jax(runs):
    want, got, _ = runs
    assert got["trace_counts"] == want["trace_counts"] == [
        {"prefill": 1, "decode": 1}] * 2


def test_replicas_share_one_set_of_weights(runs):
    _, got, _ = runs
    a, b = (s.engine._model for s in got["router"].schedulers)
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys()
    assert all(pa[n].data_ptr() == pb[n].data_ptr() for n in pa)
    assert (got["router"].schedulers[0].engine.state["cache"][0]
            ["cached_key"].data_ptr()
            != got["router"].schedulers[1].engine.state["cache"][0]
            ["cached_key"].data_ptr())


def test_hot_swap_is_not_yet_ported(runs):
    """The rolling swap is ported since (tests/test_torch_serve_swap.py):
    its knobs default as the reference's and a swap that does not move
    forward raises as there; the draft-only swap is still not ported."""
    _, got, _ = runs
    with pytest.raises(NotImplementedError, match="not yet ported"):
        got["router"].maybe_swap_draft(None)
    with pytest.raises(ValueError, match="monotone"):
        got["router"].start_swap({}, version=0)
    assert dataclasses.asdict(SwapConfig()) == dataclasses.asdict(
        jrouter.SwapConfig())


def test_router_validation_as_jax():
    class _Stub:
        n_slots = 2
        page_store = None

    for make in (lambda m: m([]),
                 lambda m: m([_Stub(), _Stub()], prefill_replicas=1),
                 lambda m: m([_Stub(), _Stub()], prefill_replicas=2)):
        with pytest.raises(ValueError) as want:
            make(JRouter)
        with pytest.raises(ValueError) as got:
            make(Router)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="n_replicas=0"):
        Router.build(tgpt.GPTConfig.tiny(), {}, n_replicas=0, n_slots=1,
                     max_len=8)
