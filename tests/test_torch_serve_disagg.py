"""Prefill/decode disaggregation on the port's fleet (the counterparts of
``tests/test_serve_disagg.py``), on the CPU at ``GPTConfig.tiny`` in
float32 (slots of 64, chunk 5, pages of 8).

The page store as a KV transport between two engines; the shared
store's compatibility checks; ONE script on a 1-prefill + 1-decode fleet
of each package (each built once): routed tokens equal the JAX
disaggregated router's (greedy; sampled ones the port's batch-1
``generate``), ``poll`` reads ``"prefill"`` during a handoff, sub-page
and stem-cached prompts skip the prefill tier, the handoff counters and
roles equal JAX's; the long-prompt burst that the prefill tier keeps off
the short requests' first tokens; a quarantined prefill replica whose
prompts re-route; and the reference's validation errors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.models import gpt as jgpt
from dtf_tpu.serve import Request as JRequest
from dtf_tpu.serve import Router as JRouter
from dtf_tpu_torch import convert
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.serve import (DecodeEngine, HealthConfig, Request,
                                 Router)
from dtf_tpu_torch.serve import pages as pages_lib

MAX_LEN, PAGE, CHUNK = 64, 8, 5
FLEET = dict(n_slots=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
             kv_page_size=PAGE, prefix_pages=12)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32)


def _tree(cfg, seed):
    tree = convert.init_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def weights():
    tree = _tree(TCFG, 0)
    state_dict = convert.params_from_flax(tree)
    model = tgpt.GPT(dataclasses.replace(TCFG, decode_len=MAX_LEN),
                     device="cpu")
    model.load_state_dict(state_dict)
    return tree, state_dict, model.eval()


def _batch1(model, req):
    out = tgpt.generate(
        model, torch.tensor([req["prompt"]]), req["max_new"],
        seed=req.get("seed", 0), temperature=req.get("temperature", 0.0),
        top_k=req.get("top_k", 0), top_p=req.get("top_p", 1.0))
    return out[0, len(req["prompt"]):].tolist()


def _fleet(state_dict, *, n=2, prefill=1, health=False, **kw):
    return Router.build(TCFG, state_dict, n_replicas=n, device="cpu",
                        prefill_replicas=prefill, health=health, **FLEET,
                        **kw)


# ------------------------------------------------------ shared page store

def test_shared_page_store_is_a_transport(weights):
    """Pages one engine saved load into another engine mounting the same
    store, and the loaded stream is batch-1 ``generate``'s."""
    _, state_dict, model = weights
    a = DecodeEngine(TCFG, state_dict, device="cpu", page_save_after=1,
                     **{k: v for k, v in FLEET.items()})
    b = DecodeEngine(TCFG, state_dict, device="cpu", page_save_after=1,
                     shared_pages=a.page_store, weights_from=a,
                     **{k: v for k, v in FLEET.items()})
    assert b.page_store is a.page_store
    prompt = list(range(1, 22))                 # 2 full pages + tail
    a.prefill(0, prompt, seed=0)
    a.save_prefix_pages(0, prompt)
    h = b.prefix_match(prompt)
    assert h is not None and h.n_tokens == 16
    b.load_prefix(0, h)
    tok0, _ = b.prefill(0, prompt, start=h.n_tokens, seed=5)
    got = [tok0]
    for _ in range(7):
        toks, _ = b.decode()
        got.append(int(toks[0]))
    b.release_prefix(h)
    assert got == _batch1(model, dict(prompt=prompt, max_new=8, seed=5))
    assert b.counters["pages_loaded"] == 2
    assert a.prefix_stats()["pinned"] == 0


def test_shared_store_compat_checks(weights):
    _, state_dict, _ = weights
    int8 = DecodeEngine(dataclasses.replace(TCFG, kv_cache_dtype="int8"),
                        state_dict, device="cpu", **FLEET)
    with pytest.raises(ValueError, match="shared page pool"):
        DecodeEngine(TCFG, state_dict, device="cpu",
                     shared_pages=int8.page_store, **FLEET)
    with pytest.raises(ValueError, match="shared_pages needs"):
        DecodeEngine(TCFG, state_dict, device="cpu", n_slots=2,
                     max_len=MAX_LEN, prefill_chunk=CHUNK,
                     shared_pages=int8.page_store)
    assert isinstance(int8.page_store, pages_lib.PageStore)


# ------------------------------------------------------ the routed script

def _identity_requests():
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(5):
        t_p = int(rng.integers(3, 40))
        reqs.append(dict(prompt=rng.integers(0, 128, t_p).tolist(),
                         max_new=int(rng.integers(2, 10)), seed=40 + i,
                         **({} if i % 2 else dict(temperature=0.8))))
    return reqs


def _script(router, Req):
    seen = {}
    rids = [router.submit(Req(**r)) for r in _identity_requests()]
    seen["first_poll"] = [router.poll(r)["status"] for r in rids]
    router.drain()
    seen["identity"] = [router.poll(r) for r in rids]
    seen["identity_replica"] = [router.replica_of(r) for r in rids]
    # a prompt mid-handoff reads "prefill"
    rid = router.submit(Req(prompt=list(range(1, 30)), max_new=4))
    seen["handoff_poll"] = router.poll(rid)["status"]
    router.tick()
    seen["handoff_tick"] = router.poll(rid)["status"]
    router.drain()
    seen["handoff_done"] = router.poll(rid)
    # a sub-page prompt goes straight to decode; so does a prompt whose
    # full pages a first request put in the store
    sub = router.submit(Req(prompt=[1, 2, 3], max_new=2))
    seen["sub_page"] = router.replica_of(sub)
    router.drain()
    stem = list(range(100, 124))
    r0 = router.submit(Req(prompt=stem + [7], max_new=2))
    seen["stem_first"] = router.replica_of(r0)
    router.drain()
    r1 = router.submit(Req(prompt=stem + [9], max_new=2))
    seen["stem_cached"] = router.replica_of(r1)
    router.drain()
    seen["stem_polls"] = [router.poll(r0), router.poll(r1)]
    st = router.stats()
    seen["stats"] = {k: st[k] for k in (
        "router_handoffs", "router_prefill_replicas", "replica0_role",
        "replica1_role", "router_completed", "router_pages_saved",
        "router_pages_loaded", "router_prefix_hit_tokens",
        "router_prefill_chunks")}
    seen["pinned"] = router.schedulers[0].engine.prefix_stats()["pinned"]
    return seen


@pytest.fixture(scope="module")
def scripts(weights):
    tree, state_dict, _ = weights
    want = _script(JRouter.build(jgpt.GPTConfig.tiny(dtype=jnp.float32),
                                 tree, n_replicas=2, prefill_replicas=1,
                                 health=False, **FLEET), JRequest)
    got = _script(_fleet(state_dict), Request)
    return want, got


def test_disagg_tokens_equal_jax(weights, scripts):
    want, got = scripts
    _, _, model = weights
    assert got["identity_replica"] == want["identity_replica"]
    for req, a, b in zip(_identity_requests(), got["identity"],
                         want["identity"]):
        assert a["status"] == "done"
        if "temperature" not in req:
            assert a["tokens"] == b["tokens"], req
        assert a["tokens"] == _batch1(model, req), req
    assert got["stats"] == want["stats"]
    assert got["stats"]["router_handoffs"] > 0
    assert got["stats"]["router_pages_loaded"] > 0      # KV carried
    assert got["pinned"] == 0


def test_poll_reads_prefill_during_a_handoff(scripts):
    want, got = scripts
    assert got["first_poll"] == want["first_poll"]
    assert "prefill" in got["first_poll"]
    assert got["handoff_poll"] == want["handoff_poll"] == "prefill"
    assert got["handoff_tick"] == want["handoff_tick"]
    assert got["handoff_done"] == want["handoff_done"]
    assert got["handoff_done"]["status"] == "done"


def test_cached_short_prompts_skip_the_prefill_tier(scripts):
    want, got = scripts
    for key in ("sub_page", "stem_first", "stem_cached", "stem_polls"):
        assert got[key] == want[key], key
    assert got["sub_page"] == got["stem_cached"] == 1
    assert [p["status"] for p in got["stem_polls"]] == ["done", "done"]


# ------------------------------------------------- starvation regression

def _tick_ttfts(router, rids):
    out = []
    for rid in rids:
        i, local = router._where[rid]
        rec = router.schedulers[i]._recs[local]
        assert rec.first_token_tick is not None
        out.append(rec.first_token_tick - rec.submit_tick)
    return out


def _burst_worst_short_ticks(state_dict, prefill_replicas):
    """The worst SHORT request's TTFT in its replica's ticks, behind a
    burst of long unique prompts."""
    router = (_fleet(state_dict) if prefill_replicas else
              Router.build(TCFG, state_dict, n_replicas=2, device="cpu",
                           health=False, page_save_after=1, **FLEET))
    rng = np.random.default_rng(5)
    stem = rng.integers(0, 128, 16).tolist()
    warms = [router.submit(Request(prompt=stem + [i], max_new=1))
             for i in range(1 if prefill_replicas else 2)]
    router.drain()
    assert all(router.poll(w)["status"] == "done" for w in warms)
    longs = [router.submit(Request(
        prompt=rng.integers(0, 128, 48).tolist(), max_new=2))
        for _ in range(6)]
    shorts = [router.submit(Request(prompt=stem + [10 + i], max_new=2))
              for i in range(4)]
    router.drain()
    assert all(router.poll(r)["status"] == "done" for r in longs + shorts)
    return max(_tick_ttfts(router, shorts))


def test_long_prompt_burst_starvation_regression(weights):
    _, state_dict, _ = weights
    shared = _burst_worst_short_ticks(state_dict, 0)
    disagg = _burst_worst_short_ticks(state_dict, 1)
    assert disagg * 2 <= shared, (disagg, shared)


def test_prefill_replica_quarantine_reroutes(weights):
    """The prefill replica quarantined mid-burst: its prompts re-route
    (the role falls back to the routable fleet), every stream is batch-1
    ``generate``'s and every pin is released."""
    _, state_dict, model = weights
    # a clock that stands still: no tick is slow, no probation comes
    router = _fleet(state_dict, n=3, clock=lambda: 0.0,
                    health=HealthConfig(probation_delay_s=3600.0))
    rng = np.random.default_rng(7)
    reqs = [dict(prompt=rng.integers(0, 128, int(rng.integers(20, 40))
                                     ).tolist(), max_new=3, seed=70 + i)
            for i in range(4)]
    rids = [router.submit(Request(**r)) for r in reqs]
    router.tick()
    router.quarantine(0, "test wedge")
    router.drain()
    for req, rid in zip(reqs, rids):
        st = router.poll(rid)
        assert st["status"] == "done" and st["tokens"] == _batch1(model,
                                                                  req)
    assert all(s.engine.prefix_stats()["pinned"] == 0
               for s in router.schedulers)
    assert router.stats()["router_quarantines"] == 1


# ------------------------------------------------------------- validation

def test_disagg_validation_as_jax(weights):
    tree, state_dict, _ = weights
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    for kw in (dict(prefill_replicas=1),
               dict(kv_page_size=PAGE, prefix_pages=8, prefill_replicas=2)):
        common = dict(n_replicas=2, n_slots=2, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, **kw)
        with pytest.raises(ValueError) as want:
            JRouter.build(jcfg, tree, **common)
        with pytest.raises(ValueError) as got:
            Router.build(TCFG, state_dict, device="cpu", **common)
        assert str(got.value) == str(want.value)

    class _Stub:
        n_slots = 2
        page_store = None

    with pytest.raises(ValueError, match="ONE shared page store"):
        Router([_Stub(), _Stub()], prefill_replicas=1)
