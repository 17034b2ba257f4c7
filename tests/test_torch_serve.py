"""The port's serving engine (dtf_tpu_torch.serve) and its model steps
against the JAX package's, on the CPU at GPTConfig.tiny in float32.

Both packages get the same seeded numpy weights (into the port through
``convert.params_from_flax``). The slot decode step and the right-padded
chunk match JAX's logits within 1e-5 and its caches within 1e-6 (int8
codes exactly); the dynamic filter equals JAX's exactly; greedy engine
tokens equal the JAX engine's token for token; sampled engine tokens equal
the port's batch-1 ``generate`` with the same seed (the port's sampler is
not ``jax.random``'s); the scheduler's ``poll`` records and ``stats()``
equal the JAX scheduler's under an injected clock.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from dtf_tpu.models import gpt as jgpt
from dtf_tpu.serve import DecodeEngine as JEngine
from dtf_tpu.serve import PoissonLoadGen as JLoadGen
from dtf_tpu.serve import Request as JRequest
from dtf_tpu.serve import Scheduler as JScheduler
from dtf_tpu.serve import ServeClient as JClient
from dtf_tpu_torch import convert
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.serve import (DecodeEngine, PoissonLoadGen, Request,
                                 Scheduler, ServeClient)

MAX_LEN = 48
#: logits of the model steps: the same f32 math in another order
LOGITS_ATOL = 1e-5
#: f32 K/V written to the cache (roped projections)
CACHE_ATOL = 1e-6


def _pair(**kw):
    """(JAX config, port config) of the same tiny f32 model."""
    return (jgpt.GPTConfig.tiny(dtype=jnp.float32, **kw),
            tgpt.GPTConfig.tiny(dtype=torch.float32, **kw))


def _tree(cfg, seed):
    """init_params with every leaf jittered (biases and LayerNorm affines
    not the trivial 0 / 1)."""
    tree = convert.init_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), tree)


def _port_model(tcfg, tree):
    model = tgpt.GPT(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree))
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _pair()
    return jcfg, tcfg, _tree(tcfg, 0)


# -- the model's serving steps -------------------------------------------


def _filter_cases():
    """Rows with ties (a run of equal logits at the top and at the k-th
    place) against every (top_k, top_p) pair: k in {0, 1, 3, > V}, p in
    {1.0, 0.9, 0.3}."""
    rng = np.random.default_rng(0)
    v = 24
    rows, ks, ps = [], [], []
    for k in (0, 1, 3, v + 5):
        for p in (1.0, 0.9, 0.3):
            row = rng.normal(0, 1.5, v).astype(np.float32)
            row[[2, 7, 11]] = row.max() + 0.5            # a 3-way top tie
            row[[4, 9]] = np.sort(row)[-5]               # a tie lower down
            rows.append(row)
            ks.append(k)
            ps.append(p)
    return (np.stack(rows), np.asarray(ks, np.int32),
            np.asarray(ps, np.float32))


def test_filter_logits_dynamic_equals_jax_exactly():
    logits, ks, ps = _filter_cases()
    want = jax.vmap(lambda lv, k, p: jgpt.filter_logits_dynamic(
        lv[None], top_k=k, top_p=p)[0])(logits, ks, ps)
    got = tgpt.filter_logits_dynamic(torch.from_numpy(logits),
                                     top_k=torch.from_numpy(ks).long(),
                                     top_p=torch.from_numpy(ps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    off = (ks == 0) & (ps == 1.0)
    np.testing.assert_array_equal(got.numpy()[off], logits[off])
    # exactly k survivors of the k-filter, the lowest indices of a tie
    k1 = got.numpy()[(ks == 1) & (ps == 1.0)][0]
    assert np.isfinite(k1).nonzero()[0].tolist() == [2]


def _jax_cache(jcfg, batch):
    model = jgpt.GPT(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((batch, 1), jnp.int32)))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        shapes["cache"])


def _fill_caches(jcfg, tcache, batch, index, seed):
    """The same random contents in the JAX cache tree and the port's cache
    (int8 codes and scales under int8); ``index`` per row or a scalar."""
    rng = np.random.default_rng(seed)
    jtree = _jax_cache(jcfg, batch)
    for i, layer in enumerate(tcache):
        jl = jtree[f"layer_{i}"]["attention"]
        for name, x in layer.items():
            if x is None:
                continue
            if name == "cache_index":
                val = np.asarray(index, np.int32)
                jl[name] = val
                layer[name] = (torch.from_numpy(val.astype(np.int64))
                               if isinstance(x, torch.Tensor) else int(val))
                continue
            if x.dtype == torch.int8:
                val = rng.integers(-127, 128, x.shape).astype(np.int8)
            elif name.endswith("scale"):
                val = rng.uniform(0.005, 0.02, x.shape).astype(np.float32)
            else:
                val = rng.normal(0, 1, x.shape).astype(np.float32)
            jl[name] = val
            x.copy_(torch.from_numpy(val))
    return jax.tree.map(jnp.asarray, jtree)


def _assert_cache_equal(jtree, tcache, int8):
    for i, layer in enumerate(tcache):
        jl = jtree[f"layer_{i}"]["attention"]
        for name, x in layer.items():
            if x is None:
                continue
            want = np.asarray(jl[name])
            got = (np.asarray(x) if not isinstance(x, torch.Tensor)
                   else x.numpy())
            if name == "cache_index" or (int8 and name.startswith("cached")):
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, atol=CACHE_ATOL,
                                           rtol=0, err_msg=name)


_VARIANTS = [{}, {"kv_heads": 2, "attn_window": 8, "attn_global_every": 2,
                  "kv_cache_dtype": "int8"}]


@pytest.mark.parametrize("kw", _VARIANTS, ids=["plain", "window_gqa_int8"])
def test_slot_decode_step_matches_jax(kw):
    """One ``slot_decode`` step with a position a row (past the window for
    some rows) and a ``decode_active`` mask: logits within LOGITS_ATOL,
    the cache within CACHE_ATOL (int8 codes exactly), indices equal, the
    inactive row's cache and index bit-untouched."""
    jcfg, tcfg = _pair(decode_len=MAX_LEN, slot_decode=True, **kw)
    tree = _tree(tcfg, 1)
    b = 4
    index = [3, 20, 0, 31]
    active = np.array([True, False, True, True])
    model = _port_model(tcfg, tree)
    tcache = model.init_cache(b)
    jtree = _fill_caches(jcfg, tcache, b, index, seed=2)
    before = [{n: (x.clone() if isinstance(x, torch.Tensor) else x)
               for n, x in layer.items()} for layer in tcache]
    ids = np.random.default_rng(3).integers(0, 128, (b, 1))
    want, mut = jgpt.GPT(jcfg).apply(
        {"params": tree, "cache": jtree}, jnp.asarray(ids, jnp.int32),
        deterministic=True, mutable=["cache"],
        decode_active=jnp.asarray(active))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), tcache,
                    decode_active=torch.from_numpy(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    _assert_cache_equal(mut["cache"], tcache, bool(kw))
    for layer, old in zip(tcache, before):
        assert layer["cache_index"].tolist() == [4, 20, 1, 32]
        for name, x in layer.items():
            if x is not None and name != "cache_index":
                assert torch.equal(x[1], old[name][1]), name


@pytest.mark.parametrize("kw", [{"attn_window": 8}, _VARIANTS[1]],
                         ids=["window", "window_gqa_int8"])
def test_prefill_len_chunk_matches_jax(kw):
    """A right-padded chunk (5 wide, 3 valid) continuing an advanced cache
    whose rolling buffer wraps inside the chunk: logits within LOGITS_ATOL,
    the cache (pad K/V not written over live slots) within CACHE_ATOL,
    the index advanced by the valid count only."""
    jcfg, tcfg = _pair(decode_len=MAX_LEN, chunked_prefill=True, **kw)
    tree = _tree(tcfg, 4)
    model = _port_model(tcfg, tree)
    tcache = model.init_cache(1)
    jtree = _fill_caches(jcfg, tcache, 1, 14, seed=5)
    ids = np.random.default_rng(6).integers(0, 128, (1, 5))
    want, mut = jgpt.GPT(jcfg).apply(
        {"params": tree, "cache": jtree}, jnp.asarray(ids, jnp.int32),
        deterministic=True, mutable=["cache"], prefill_len=jnp.int32(3))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), tcache,
                    prefill_len=torch.tensor(3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    _assert_cache_equal(mut["cache"], tcache, "kv_cache_dtype" in kw)
    assert int(tgpt.cache_index_of(tcache)) == 17


def test_slot_mode_checks():
    _, tcfg = _pair(decode_len=16, slot_decode=True)
    model = _port_model(tcfg, _tree(tcfg, 0))
    cache = model.init_cache(2)
    assert cache[0]["cache_index"].shape == (2,)
    _, windowed = _pair(decode_len=16, slot_decode=True, attn_window=8)
    wmodel = _port_model(windowed, _tree(windowed, 0))
    with pytest.raises(ValueError, match="VERIFY"):
        wmodel(torch.zeros(2, 3, dtype=torch.long), wmodel.init_cache(2))
    _, plain = _pair(decode_len=16)
    with pytest.raises(ValueError, match="decode_active"):
        _port_model(plain, _tree(plain, 0))(
            torch.zeros(2, 1, dtype=torch.long),
            tgpt.GPT(plain, device="cpu").init_cache(2),
            decode_active=torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="prefill_len"):
        model(torch.zeros(2, 1, dtype=torch.long), cache,
              prefill_len=torch.tensor(1))
    with pytest.raises(ValueError, match="unknown cache leaf"):
        tgpt.batch_led_cache_key("cached_query")
    assert tgpt.cache_index_of(cache) is cache[0]["cache_index"]
    with pytest.raises(ValueError, match="no cache_index"):
        tgpt.cache_index_of([{"cached_key": None}])


# -- the sampler -----------------------------------------------------------


def test_sampler_fits_the_filtered_softmax():
    """4,000 draws of one row — over 4,000 seeds at draw 0, and over 4,000
    draws of one seed — fit softmax(filter(logits / T)): no filtered token
    drawn, and Pearson's chi-square under its 0.999 quantile (fixed seeds:
    the test is deterministic)."""
    v, n = 16, 4000
    logits = torch.from_numpy(
        np.random.default_rng(7).normal(0, 1.0, v).astype(np.float32))
    temp, top_k, top_p = 0.8, 8, 0.9
    want = torch.softmax(tgpt.filter_logits(logits[None] / temp,
                                            top_k=top_k, top_p=top_p),
                         dim=-1)[0].double().numpy()

    def full(x, dtype):
        return torch.full((n,), x, dtype=dtype)

    common = dict(temperature=full(temp, torch.float32),
                  top_k=full(top_k, torch.long),
                  top_p=full(top_p, torch.float32))
    runs = {
        "over_seeds": dict(key=tgpt.sampler_key(torch.arange(n),
                                                full(0, torch.long)),
                           draw=full(0, torch.long)),
        "over_draws": dict(key=tgpt.sampler_key(full(123, torch.long),
                                                full(0, torch.long)),
                           draw=torch.arange(n)),
    }
    for name, kw in runs.items():
        toks = tgpt.sample_tokens(logits.expand(n, v), **common, **kw)
        counts = np.bincount(toks.numpy(), minlength=v)
        assert counts[want == 0].sum() == 0, name
        live = want > 0
        expected = want[live] * n
        chi2 = float(((counts[live] - expected) ** 2 / expected).sum())
        assert chi2 < sps.chi2.ppf(0.999, live.sum() - 1), (name, chi2)
    greedy = tgpt.sample_tokens(
        logits.expand(4, v), temperature=torch.zeros(4),
        top_k=torch.zeros(4, dtype=torch.long), top_p=torch.ones(4),
        key=torch.zeros(4, dtype=torch.long),
        draw=torch.zeros(4, dtype=torch.long))
    assert greedy.tolist() == [int(logits.argmax())] * 4


def test_sampler_stream_is_the_rows_own():
    """A row's token depends on its key, draw and logits only: the same
    row alone and among others draws the same token."""
    rng = np.random.default_rng(8)
    logits = torch.from_numpy(rng.normal(0, 1, (6, 32)).astype(np.float32))
    kw = dict(temperature=torch.full((6,), 1.1), top_k=torch.tensor(
        [0, 5, 0, 3, 0, 9]), top_p=torch.tensor([1.0, 1.0, .8, .9, 1., .5]),
        key=tgpt.sampler_key(torch.arange(6) * 7, torch.zeros(6).long()),
        draw=torch.tensor([0, 4, 9, 2, 2, 1]))
    batch = tgpt.sample_tokens(logits, **kw)
    for r in range(6):
        alone = tgpt.sample_tokens(logits[r:r + 1], **{
            k: v[r:r + 1] for k, v in kw.items()})
        assert int(alone) == int(batch[r])


# -- the engine --------------------------------------------------------------


def _generate(tcfg, tree, req, **kw):
    """The per-request reference: the port's batch-1 ``generate`` with the
    request's sampling and seed, cut where the engine stops (through the
    first eos, else max_new)."""
    model = _port_model(dataclasses.replace(tcfg, decode_len=MAX_LEN), tree)
    out = tgpt.generate(model, torch.tensor([req["prompt"]]),
                        req["max_new"], seed=req.get("seed", 0),
                        temperature=req.get("temperature", 0.0),
                        top_k=req.get("top_k", 0),
                        top_p=req.get("top_p", 1.0), **kw)
    return out[0, len(req["prompt"]):].tolist()


def _serve(engine_cls, client_cls, cfg, tree, reqs, **eng_kw):
    eng = engine_cls(cfg, tree, max_len=MAX_LEN, **eng_kw)
    client = client_cls(eng)
    rids = [client.submit(**r) for r in reqs]
    client.drain()
    return eng, [client.result(rid) for rid in rids]


def _both(jcfg, tcfg, tree, reqs, **eng_kw):
    """(JAX engine tokens, port engine, port engine tokens)."""
    _, jtoks = _serve(JEngine, JClient, jcfg, tree, reqs, **eng_kw)
    eng, ttoks = _serve(
        lambda cfg, t, **kw: DecodeEngine(
            cfg, convert.params_from_flax(t), device="cpu", **kw),
        ServeClient, tcfg, tree, reqs, **eng_kw)
    return jtoks, eng, ttoks


def test_engine_mixed_churn_matches_jax_engine(tiny):
    """The 7-request mixed churn of the JAX tests (4 slots, chunk 5, ragged
    chunk counts, more requests than slots): greedy requests' tokens equal
    the JAX engine's, sampled ones the port's batch-1 generate with the
    same seed — and the same request alone in the engine afterwards."""
    jcfg, tcfg, tree = tiny
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(7):
        t_p = int(rng.integers(1, 20))
        reqs.append(dict(
            prompt=rng.integers(0, 128, t_p).tolist(),
            max_new=int(rng.integers(1, 16)),
            temperature=0.0 if i % 2 == 0 else 0.9,
            top_k=0 if i < 4 else 3, top_p=1.0 if i % 3 else 0.9,
            seed=100 + i))
    jtoks, eng, ttoks = _both(jcfg, tcfg, tree, reqs, n_slots=4,
                              prefill_chunk=5)
    for r, jt, tt in zip(reqs, jtoks, ttoks):
        if r["temperature"] == 0.0:
            assert tt == jt, r
        assert tt == _generate(tcfg, tree, r, prefill_chunk=5), r
    assert eng.trace_counts == {"prefill": 1, "decode": 1}
    alone = ServeClient(eng)
    for r, tt in zip(reqs, ttoks):
        if r["temperature"] > 0.0:
            assert alone.result(alone.submit(**r)) == tt, r


def test_engine_interleaved_prefill_matches_jax_engine(tiny):
    """prefill_chunks_per_tick=1: a long prompt spreads over 7 ticks while
    a sampled request decodes between its chunks; the long greedy request
    equals the JAX engine's, the sampled one its batch-1 generate."""
    jcfg, tcfg, tree = tiny
    short = dict(prompt=[11, 22, 33], max_new=14, temperature=0.7, seed=5)
    long = dict(prompt=list(range(1, 20)), max_new=10)
    outs = []
    for eng in (JEngine(jcfg, tree, n_slots=2, max_len=MAX_LEN,
                        prefill_chunk=3),
                DecodeEngine(tcfg, convert.params_from_flax(tree),
                             n_slots=2, max_len=MAX_LEN, prefill_chunk=3,
                             device="cpu")):
        sched_cls = JScheduler if isinstance(eng, JEngine) else Scheduler
        req_cls = JRequest if isinstance(eng, JEngine) else Request
        sched = sched_cls(eng, None, prefill_chunks_per_tick=1)
        r1 = sched.submit(req_cls(**short))
        sched.tick()
        r2 = sched.submit(req_cls(**long))
        sched.run_until_idle()
        outs.append((sched.poll(r1)["tokens"], sched.poll(r2)["tokens"]))
    (_, j_long), (t_short, t_long) = outs
    assert t_long == j_long
    assert t_short == _generate(tcfg, tree, short, prefill_chunk=3)


def test_engine_window_gqa_int8_matches_jax_engine():
    """The cache variants compose: a windowed int8 GQA engine decodes the
    JAX engine's greedy tokens."""
    kw = dict(kv_heads=2, attn_window=8)
    jcfg, tcfg = _pair(**kw)
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    tree = _tree(tcfg, 1)
    prompt = np.random.default_rng(2).integers(0, 128, 10).tolist()
    reqs = [dict(prompt=prompt, max_new=8),
            dict(prompt=prompt[:7], max_new=12)]
    jtoks, _, ttoks = _both(jcfg, tcfg, tree, reqs, n_slots=3,
                            prefill_chunk=5)
    assert ttoks == jtoks


def test_engine_inactive_slots_are_untouched(tiny):
    """decode_all with one active slot: every other slot's cache rows,
    index, token, sampler state and done bit are bit for bit unchanged."""
    _, tcfg, tree = tiny
    eng = DecodeEngine(tcfg, convert.params_from_flax(tree), n_slots=3,
                       max_len=MAX_LEN, prefill_chunk=4, device="cpu")
    eng.prefill(1, [4, 5, 6, 7, 8, 9], temperature=0.5, seed=3)
    eng.prefill_chunk_into(2, list(range(1, 10)), 0)     # mid-prefill

    def snap():
        st = eng.state
        flat = {n: st[n].clone() for n in st if n != "cache"}
        for i, layer in enumerate(st["cache"]):
            for n, x in layer.items():
                if x is not None:
                    flat[f"{i}.{n}"] = x.clone()
        return flat

    before = snap()
    eng.decode()
    after = snap()
    for name, x in before.items():
        same = torch.equal(x[[0, 2]], after[name][[0, 2]])
        assert same, name
    assert int(after["draws"][1]) == 2 and int(before["draws"][1]) == 1


def test_engine_constructor_checks_raise_where_the_reference_does(tiny):
    jcfg, tcfg, tree = tiny
    sd = convert.params_from_flax(tree)
    wcfg = (dataclasses.replace(jcfg, attn_window=4),
            dataclasses.replace(tcfg, attn_window=4))
    bad = [(dict(n_slots=0, max_len=MAX_LEN), "n_slots"),
           (dict(n_slots=2, max_len=1), "max_len"),
           (dict(n_slots=2, max_len=MAX_LEN, prefill_chunk=1),
            "prefill_chunk"),
           (dict(n_slots=2, max_len=MAX_LEN, prefill_chunk=5), "exceeds")]
    for kw, match in bad:
        j, t = wcfg if match == "exceeds" else (jcfg, tcfg)
        with pytest.raises(ValueError, match=match):
            JEngine(j, tree, **kw)
        with pytest.raises(ValueError, match=match):
            DecodeEngine(t, sd, device="cpu", **kw)
    # sharded serving and its fleets are ported since
    # (tests/test_torch_tp_serve.py, tests/test_torch_tp_fleet.py): a
    # fleet's engines share one mesh, and the slots split over data
    mesh = types.SimpleNamespace(data_size=2, model_size=1, data_index=0,
                                 model_index=0)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        DecodeEngine(tcfg, sd, n_slots=2, max_len=MAX_LEN, device="cpu",
                     draft_cfg=tcfg, draft_params=sd)
    with pytest.raises(ValueError, match="another mesh"):
        DecodeEngine(tcfg, sd, n_slots=2, max_len=MAX_LEN, device="cpu",
                     mesh=mesh, weights_from=object())
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        DecodeEngine(tcfg, sd, n_slots=3, max_len=MAX_LEN, device="cpu",
                     mesh=mesh)
    for kw, match in ((dict(spec_k=2), "needs a draft model"),
                      (dict(shared_pages=object()), "needs prefix_pages"),
                      (dict(prefix_pages=4, kv_page_size=5),
                       "does not divide")):
        with pytest.raises(ValueError, match=match):
            JEngine(jcfg, tree, n_slots=2, max_len=MAX_LEN, **kw)
        with pytest.raises(ValueError, match=match):
            DecodeEngine(tcfg, sd, n_slots=2, max_len=MAX_LEN, device="cpu",
                         **kw)
    eng = DecodeEngine(tcfg, sd, n_slots=2, max_len=MAX_LEN, device="cpu")
    # swap_params is ported since: a tree that is not drop-in raises as
    # the reference's does (tests/test_torch_serve_swap.py holds the rest)
    with pytest.raises(ValueError, match="tree structure"):
        eng.swap_params({n: x for n, x in list(sd.items())[1:]})
    with pytest.raises(ValueError, match="prompt length"):
        eng.prefill(0, [1] * MAX_LEN)


# -- the scheduler and the client ----------------------------------------


def _scheduled(engine, req_cls, sched_cls, eos):
    """A run through eos and slot reuse (2 slots), a TTFT deadline that
    fires in the queue, a shed, an admission error and the completed-record
    cap, on a clock that ticks 0.25 s a read."""
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    real = engine.prefill_chunk_into

    def poisoned(slot, prompt, *a, **kw):
        if prompt[0] == 127:
            raise RuntimeError("poisoned prompt")
        return real(slot, prompt, *a, **kw)

    engine.prefill_chunk_into = poisoned
    sched = sched_cls(engine, None, prefill_chunks_per_tick=2, clock=clock,
                      completed_cap=8, max_queue=5, ttft_slo_s=2.0)
    reqs = [dict(prompt=[5, 9, 2, 44], max_new=12, eos_id=eos),
            dict(prompt=[7, 7], max_new=9),
            dict(prompt=list(range(1, 12)), max_new=6, ttft_deadline_s=1.0),
            dict(prompt=[127, 3], max_new=4),
            dict(prompt=[3, 1, 4, 1, 5], max_new=8, deadline_s=4.0),
            dict(prompt=[9], max_new=4),
            dict(prompt=[8, 8, 8], max_new=5)]
    rids = [sched.submit(req_cls(**r)) for r in reqs]
    sched.run_until_idle()
    rids += [sched.submit(req_cls(prompt=[2, 4, 6], max_new=7)),
             sched.submit(req_cls(prompt=[1, 1], max_new=3))]
    sched.run_until_idle()
    polls = []
    for rid in rids:
        try:
            polls.append(sched.poll(rid))
        except KeyError:
            polls.append("forgotten")
    return polls, sched.stats()


def test_scheduler_poll_and_stats_equal_the_jax_scheduler(tiny):
    jcfg, tcfg, tree = tiny
    eos = _generate(tcfg, tree, dict(prompt=[5, 9, 2, 44], max_new=4))[2]
    want = _scheduled(JEngine(jcfg, tree, n_slots=2, max_len=MAX_LEN,
                              prefill_chunk=5), JRequest, JScheduler, eos)
    got = _scheduled(DecodeEngine(tcfg, convert.params_from_flax(tree),
                                  n_slots=2, max_len=MAX_LEN,
                                  prefill_chunk=5, device="cpu"),
                     Request, Scheduler, eos)
    assert got == want
    polls, st = got
    statuses = [p if isinstance(p, str) else p["status"] for p in polls]
    assert {"shed", "timeout", "error", "done", "forgotten"} <= set(
        statuses), statuses
    assert st["serve_occupancy"] == 0.0 and st["serve_completed"] >= 4


def test_poisson_arrivals_equal_the_reference():
    kw = dict(rate=7.0, n_requests=9, vocab_size=128, prompt_min=2,
              prompt_max=30, new_min=3, new_max=20, temperature=0.5,
              seed=4)
    want = list(JLoadGen(**kw).arrivals())
    got = list(PoissonLoadGen(**kw).arrivals())
    assert [(t, dataclasses.asdict(r)) for t, r in got] == [
        (t, dataclasses.asdict(r)) for t, r in want]
    for bad in (dict(rate=0.0), dict(new_min=0), dict(prompt_min=8,
                                                      prompt_max=4)):
        with pytest.raises(ValueError):
            PoissonLoadGen(**{**kw, **bad})
