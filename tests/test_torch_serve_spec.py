"""Speculative decoding in the port's serving engine against the JAX
package's, on the CPU at GPTConfig.tiny in float32 (4 slots of 48, chunk
5, k = 3).

Both packages get the same seeded numpy weights. The slot VERIFY step
(``slot_decode`` with a multi-token call) matches JAX's logits within
1e-5 and its cache within 1e-6 (int8 codes exactly), rows past the cache
end and inactive rows included; ``cache_rollback`` is bitwise JAX's. ONE
JAX spec engine (self-draft, pages on) is built for the file: greedy
streams and every tick's ``n_emit`` of the port's self-draft engine,
pages off and on, equal it. Sampled streams have no JAX counterpart (the
port's sampler is not ``jax.random``'s): a spec engine's equal the port's
plain engine's, whatever the draft proposes — the eos and budget edges,
partial acceptance and a failing draft included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.models import gpt as jgpt
from dtf_tpu.serve import DecodeEngine as JEngine
from dtf_tpu.serve import Request as JRequest
from dtf_tpu.serve import Scheduler as JScheduler
from dtf_tpu_torch import convert, serve_gpt
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.serve import DecodeEngine, Request, Scheduler

MAX_LEN, K = 48, 3
#: logits of the model steps: the same f32 math in another order
LOGITS_ATOL = 1e-5
#: f32 K/V written to the cache (roped projections)
CACHE_ATOL = 1e-6
PAGES = dict(kv_page_size=4, prefix_pages=8, page_save_after=1)


def _pair(**kw):
    return (jgpt.GPTConfig.tiny(dtype=jnp.float32, **kw),
            tgpt.GPTConfig.tiny(dtype=torch.float32, **kw))


def _tree(cfg, seed):
    """init_params with every leaf jittered (biases and LayerNorm affines
    not the trivial 0 / 1)."""
    tree = convert.init_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _pair()
    tree = _tree(tcfg, 0)
    return jcfg, tcfg, tree, convert.params_from_flax(tree)


# -- the model's verify step ---------------------------------------------


def _jax_cache(jcfg, batch):
    model = jgpt.GPT(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((batch, 1), jnp.int32)))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        shapes["cache"])


def _fill_caches(jcfg, tcache, index, seed):
    """The same random contents in the JAX cache tree and the port's
    cache (int8 codes and scales under int8), ``index`` a row."""
    rng = np.random.default_rng(seed)
    jtree = _jax_cache(jcfg, len(index))
    for i, layer in enumerate(tcache):
        jl = jtree[f"layer_{i}"]["attention"]
        for name, x in layer.items():
            if x is None:
                continue
            if name == "cache_index":
                val = np.asarray(index, np.int32)
                x.copy_(torch.from_numpy(val.astype(np.int64)))
            elif x.dtype == torch.int8:
                val = rng.integers(-127, 128, x.shape).astype(np.int8)
            elif name.endswith("scale"):
                val = rng.uniform(0.005, 0.02, x.shape).astype(np.float32)
            else:
                val = rng.normal(0, 1, x.shape).astype(np.float32)
            jl[name] = val
            if name != "cache_index":
                x.copy_(torch.from_numpy(val))
    return jax.tree.map(jnp.asarray, jtree)


def _assert_cache_equal(jtree, tcache, exact):
    for i, layer in enumerate(tcache):
        jl = jtree[f"layer_{i}"]["attention"]
        for name, x in layer.items():
            if x is None:
                continue
            want, got = np.asarray(jl[name]), x.numpy()
            if exact or name == "cache_index" or x.dtype == torch.int8:
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, atol=CACHE_ATOL,
                                           rtol=0, err_msg=name)


def _port_model(tcfg, tree):
    model = tgpt.GPT(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree))
    return model.eval()


#: a row's position: mid-cache, inactive, empty, crossing the cache end
#: (46 + 4 > 48), at the last position, and past the end
_INDEX = [3, 20, 0, 46, 47, 50]
_ACTIVE = [True, False, True, True, True, True]


@pytest.mark.parametrize("kw", [{}, {"kv_heads": 2,
                                     "kv_cache_dtype": "int8"}],
                         ids=["plain", "gqa_int8"])
def test_verify_step_matches_jax(kw):
    """One 4-token verify call: logits within LOGITS_ATOL, the cache
    within CACHE_ATOL (int8 codes exactly, the dropped writes past the
    end and of the inactive row keep their contents), the active rows'
    indices advanced by 4."""
    jcfg, tcfg = _pair(decode_len=MAX_LEN, slot_decode=True, **kw)
    tree = _tree(tcfg, 1)
    model = _port_model(tcfg, tree)
    tcache = model.init_cache(len(_INDEX))
    jtree = _fill_caches(jcfg, tcache, _INDEX, seed=2)
    before = [{n: x.clone() for n, x in layer.items() if x is not None}
              for layer in tcache]
    ids = np.random.default_rng(3).integers(0, 128, (len(_INDEX), 4))
    want, mut = jax.jit(lambda p, c, x, a: jgpt.GPT(jcfg).apply(
        {"params": p, "cache": c}, x, deterministic=True,
        mutable=["cache"], decode_active=a))(
            tree, jtree, jnp.asarray(ids, jnp.int32), jnp.asarray(_ACTIVE))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), tcache,
                    decode_active=torch.tensor(_ACTIVE))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    _assert_cache_equal(mut["cache"], tcache, exact=False)
    assert tcache[0]["cache_index"].tolist() == [7, 20, 4, 50, 51, 54]
    for layer, old in zip(tcache, before):
        for name, x in layer.items():
            if x is None or name == "cache_index":
                continue
            assert torch.equal(x[1], old[name][1]), name     # inactive
            assert torch.equal(x[5], old[name][5]), name     # past the end
            assert torch.equal(x[3, :, :46], old[name][3, :, :46]), name


def test_verify_step_refuses_a_window():
    _, tcfg = _pair(decode_len=16, slot_decode=True, attn_window=8)
    model = _port_model(tcfg, _tree(tcfg, 0))
    with pytest.raises(ValueError, match="windowless"):
        model(torch.zeros(2, 3, dtype=torch.long), model.init_cache(2))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
def test_cache_rollback_equals_jax_bitwise(masked):
    jcfg, tcfg = _pair(decode_len=MAX_LEN, slot_decode=True,
                       kv_cache_dtype="int8")
    model = _port_model(tcfg, _tree(tcfg, 0))
    tcache = model.init_cache(4)
    jtree = _fill_caches(jcfg, tcache, [9, 30, 2, 47], seed=4)
    new = np.array([11, 31, 2, 48], np.int32)
    active = np.array([True, False, True, True]) if masked else None
    want = jgpt.cache_rollback(jtree, jnp.asarray(new),
                               None if active is None
                               else jnp.asarray(active))
    out = tgpt.cache_rollback(tcache, torch.from_numpy(new.astype(np.int64)),
                              None if active is None
                              else torch.from_numpy(active))
    assert out is tcache
    _assert_cache_equal(want, tcache, exact=True)


def test_draft_truncate_shares_storage(tiny):
    _, tcfg, _, sd = tiny
    dcfg, dsd = tgpt.draft_truncate(tcfg, sd, 1)
    assert dcfg.layers == 1 and dcfg.d_model == tcfg.d_model
    assert {n.split(".")[0] for n in dsd} == {"token_embed", "layer_0",
                                             "ln_f", "lm_head"}
    assert all(dsd[n] is sd[n] for n in dsd)
    with pytest.raises(ValueError, match="draft n_layers"):
        tgpt.draft_truncate(tcfg, sd, tcfg.layers)
    with pytest.raises(ValueError, match="missing"):
        tgpt.draft_truncate(tcfg, {"layer_0.x": sd["ln_f.weight"]}, 1)
    # the engine's draft model holds the target model's own tensors
    eng = DecodeEngine(tcfg, sd, n_slots=2, max_len=MAX_LEN,
                       prefill_chunk=5, draft_cfg=dcfg, draft_params=dsd,
                       spec_k=K, device="cpu")
    target = dict(eng._model.named_parameters())
    for name, p in eng._draft_model.named_parameters():
        assert p is target[name], name


# -- the engine against the JAX spec engine ------------------------------


def _greedy_reqs(n=7, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, 128, int(rng.integers(1, 20)))
                 .tolist(), max_new=int(rng.integers(1, 16)))
            for _ in range(n)]


def _mixed_reqs(n=7, seed=0):
    reqs = _greedy_reqs(n, seed)
    for i, r in enumerate(reqs):
        if i % 2:
            r.update(temperature=0.9, top_k=0 if i < 4 else 3,
                     top_p=1.0 if i % 3 else 0.9, seed=100 + i)
    return reqs


def _logged(engine):
    """Record each tick's ``n_emit`` (the third output of a spec decode)."""
    log, real = [], engine.decode

    def decode(**kw):
        out = real(**kw)
        log.append(np.asarray(out[2]).tolist())
        return out

    engine.decode = decode
    return log


def _run(engine, reqs, sched_cls=Scheduler, req_cls=Request, per_tick=2):
    sched = sched_cls(engine, None, prefill_chunks_per_tick=per_tick)
    rids = [sched.submit(req_cls(**r)) for r in reqs]
    sched.run_until_idle()
    return [sched.poll(rid)["tokens"] for rid in rids], sched


def _port(tcfg, sd, draft="self", pages=False, **kw):
    if draft == "self":
        dkw = dict(draft_cfg=tcfg, draft_params=sd, spec_k=K)
    elif draft == "truncated":
        dcfg, dsd = tgpt.draft_truncate(tcfg, sd, 1)
        dkw = dict(draft_cfg=dcfg, draft_params=dsd, spec_k=K)
    else:
        dkw = {}
    return DecodeEngine(tcfg, sd, n_slots=4, max_len=MAX_LEN,
                        prefill_chunk=5, device="cpu", **dkw,
                        **(PAGES if pages else {}), **kw)


@pytest.fixture(scope="module")
def jax_spec(tiny):
    """THE JAX engine of this file (self-draft, pages on): the greedy
    churn's streams, each tick's n_emit and the counters."""
    jcfg, _, tree, _ = tiny
    eng = JEngine(jcfg, tree, n_slots=4, max_len=MAX_LEN, prefill_chunk=5,
                  draft_cfg=jcfg, draft_params=tree, spec_k=K, **PAGES)
    log = _logged(eng)
    toks, sched = _run(eng, _greedy_reqs(), JScheduler, JRequest)
    return {"tokens": toks, "n_emit": log, "counters": dict(eng.counters),
            "accept": sched.stats()["serve_spec_accept_rate"],
            "trace_counts": dict(eng.trace_counts)}


@pytest.mark.parametrize("pages", [False, True], ids=["pages_off",
                                                      "pages_on"])
def test_self_draft_streams_and_n_emit_equal_jax(tiny, jax_spec, pages):
    """Greedy churn (7 requests, 4 slots, ragged chunks, budgets 1–15):
    the streams, every tick's n_emit, the accept rate and the spec
    counters equal the JAX spec engine's; with pages on, its page
    counters too (no prompt repeats: every full page saved, none hit)."""
    _, tcfg, _, sd = tiny
    eng = _port(tcfg, sd, pages=pages)
    log = _logged(eng)
    toks, sched = _run(eng, _greedy_reqs())
    assert toks == jax_spec["tokens"]
    assert log == jax_spec["n_emit"]
    assert sched.stats()["serve_spec_accept_rate"] == jax_spec["accept"]
    assert eng.trace_counts == jax_spec["trace_counts"]
    want = jax_spec["counters"]
    keys = ["decode_steps", "draft_steps", "draft_prefill_chunks",
            "draft_fallbacks", "spec_proposed", "spec_accepted",
            "prefill_chunks"]
    if pages:
        keys += ["pages_saved", "pages_loaded", "prefix_hit_tokens",
                 "prefix_miss_tokens", "draft_pages_loaded"]
    assert {k: eng.counters[k] for k in keys} == {k: want[k] for k in keys}


def _plain_tokens(tcfg, sd, reqs, **kw):
    return _run(_port(tcfg, sd, draft=None, **kw), reqs)[0]


@pytest.mark.parametrize("draft,pages", [("self", False), ("self", True),
                                         ("truncated", False),
                                         ("truncated", True)])
def test_sampled_spec_streams_equal_the_plain_engine(tiny, draft, pages):
    """Greedy and sampled rows (temperature, top-k, top-p, seeds): a spec
    engine's streams equal the port's plain engine's, for either draft
    and the pool off or on; four step functions, built once."""
    _, tcfg, _, sd = tiny
    reqs = _mixed_reqs()
    eng = _port(tcfg, sd, draft=draft, pages=pages)
    toks, sched = _run(eng, reqs)
    assert toks == _plain_tokens(tcfg, sd, reqs)
    assert eng.trace_counts == {"prefill": 1, "decode": 1,
                                "draft_prefill": 1, "draft": 1}
    if draft == "self":
        assert sched._spec_accepted > 0


def test_eos_and_budget_edges(tiny):
    """eos in the middle of a verify chain stops delivery where the plain
    engine stops; a budget below k, a budget of 1 and a slot budget that
    ends inside a chain deliver what the plain engine delivers."""
    _, tcfg, _, sd = tiny
    base = [dict(prompt=[3, 1, 4, 1, 5], max_new=12, seed=7),
            dict(prompt=[2, 7, 1, 8], max_new=1, seed=8),
            dict(prompt=[9, 9], max_new=2, seed=9),
            dict(prompt=list(range(1, 40)), max_new=20, seed=1)]
    eos = _plain_tokens(tcfg, sd, base[:1])[0][5]
    reqs = [dict(base[0], eos_id=eos), *base[1:],
            dict(base[0], temperature=0.8, eos_id=eos)]
    want = _plain_tokens(tcfg, sd, reqs)
    got, _ = _run(_port(tcfg, sd), reqs)
    assert got == want
    assert len(got[0]) <= 6 and got[0][-1] == eos
    assert len(got[1]) == 1 and len(got[2]) == 2
    assert len(got[3]) == MAX_LEN - 39            # the slot's budget


def test_partial_acceptance_rollback(tiny):
    """A draft whose proposals are corrupted at a rotating position: the
    rejected tail's cache writes are dead weight behind the rolled-back
    index, and every stream stays the plain engine's."""
    _, tcfg, _, sd = tiny
    eng = _port(tcfg, sd)
    real, tick = eng.draft_propose, [0]

    def corrupting():
        props = real().clone()
        props[:, tick[0] % K] = (props[:, tick[0] % K] + 1) % 128
        tick[0] += 1
        return props

    eng.draft_propose = corrupting
    reqs = _mixed_reqs(5, seed=4)
    toks, sched = _run(eng, reqs)
    assert toks == _plain_tokens(tcfg, sd, reqs)
    assert 0 < sched._spec_accepted < sched._spec_proposed


@pytest.mark.parametrize("mode", ["always", "partial_write"])
def test_draft_failure_falls_back_to_null_proposals(tiny, mode):
    """A draft step that raises — before anything, or midway through a
    tick after its first layer wrote the draft cache and advanced that
    layer's index — costs the tick its proposals (``draft_fallbacks``),
    never a request: streams stay the plain engine's, and the next tick's
    rollback puts every draft layer back on the verifier's boundary."""
    _, tcfg, _, sd = tiny
    eng = _port(tcfg, sd)
    if mode == "always":
        def boom():
            raise RuntimeError("draft down")
        eng.draft_propose = boom
    else:
        blk = eng._draft_model.layer_1
        real, calls = blk.forward, [0]

        def flaky(x, *a, **kw):
            if x.shape[1] == 1:           # a draft step, not its prefill
                calls[0] += 1
                if calls[0] % 7 == 3:     # midway through some ticks
                    raise RuntimeError("draft failed midway")
            return real(x, *a, **kw)

        blk.forward = flaky
    reqs = _mixed_reqs(5, seed=6)
    toks, _ = _run(eng, reqs)
    assert toks == _plain_tokens(tcfg, sd, reqs)
    assert eng.counters["draft_fallbacks"] > 0
    if mode == "always":
        assert eng.counters["spec_accepted"] <= eng.counters["decode_steps"]
    else:
        assert eng.counters["spec_accepted"] > 0


def test_validation_errors_match_the_reference(tiny):
    """The JAX engine's checks, raised before anything is built."""
    jcfg, tcfg, tree, sd = tiny
    wj, wt = (dataclasses.replace(c, attn_window=8) for c in (jcfg, tcfg))
    vj, vt = (dataclasses.replace(c, vocab_size=64) for c in (jcfg, tcfg))
    common = dict(n_slots=2, max_len=MAX_LEN, prefill_chunk=5)
    cases = [(dict(spec_k=3), {}, "needs a draft model"),
             (dict(draft_cfg=wj, draft_params=tree, spec_k=2),
              dict(draft_cfg=wt, draft_params=sd, spec_k=2), "windowless"),
             (dict(draft_cfg=vj, draft_params=tree, spec_k=2),
              dict(draft_cfg=vt, draft_params=sd, spec_k=2), "vocab"),
             (dict(draft_cfg=jcfg, spec_k=2), dict(draft_cfg=tcfg, spec_k=2),
              "without draft_params"),
             (dict(draft_cfg=jcfg, draft_params=tree, spec_k=MAX_LEN - 1),
              dict(draft_cfg=tcfg, draft_params=sd, spec_k=MAX_LEN - 1),
              "no room"),
             (dict(spec_k=-1), {}, "must be >= 0")]
    for jkw, tkw, match in cases:
        tkw = tkw or jkw
        with pytest.raises(ValueError, match=match):
            JEngine(wj if match == "windowless" else jcfg, tree,
                    **common, **jkw)
        with pytest.raises(ValueError, match=match):
            DecodeEngine(wt if match == "windowless" else tcfg, sd,
                         device="cpu", **common, **tkw)
    with pytest.raises(NotImplementedError, match=r"not yet ported \(tune/"):
        DecodeEngine(tcfg, sd, device="cpu", draft_cfg=tcfg,
                     draft_params=sd, **common)


# -- the launcher ----------------------------------------------------------

_TINY = ["--size=tiny", "--device=cpu", "--init_seed=0", "--n_slots=3",
         "--max_len=40", "--prefill_chunk=4", "--n_new=9", "--emit_tokens",
         "--requests=12,7,99;5,6,7,8;3;12,7,99,4,4;40,41"]


@pytest.mark.parametrize("draft", ["--draft_layers=1", "self_ckpt"])
def test_serve_gpt_speculative_rows_equal_plain(tmp_path, draft):
    """``--spec_k 3`` with an early-exit draft, or with a ``--draft_ckpt``
    (a train_gpt logdir's manifest and checkpoint: here the served model
    itself): the rows equal plain serving's, and the JSON line carries
    the spec counters and the accept rate."""
    from dtf_tpu_torch import train_gpt

    plain, prow, _ = serve_gpt.run(_TINY)
    if draft == "self_ckpt":
        logdir = str(tmp_path / "run")
        train_gpt.run(["--device=cpu", "--size=tiny", "--batch_size=2",
                       "--seq_len=16", "--train_steps=1",
                       f"--logdir={logdir}"])
        args = [a for a in _TINY if a != "--init_seed=0"]
        plain, prow, _ = serve_gpt.run(args + [f"--logdir={logdir}"])
        out, rows, eng = serve_gpt.run(args + [
            f"--logdir={logdir}", "--spec_k=3", f"--draft_ckpt={logdir}"])
        assert out["draft"] == "ckpt" and eng._draft_self
    else:
        out, rows, eng = serve_gpt.run(_TINY + ["--spec_k=3", draft])
        assert out["draft"] == "layers:1" and eng.draft_cfg.layers == 1
    assert rows == prow and out["spec_k"] == 3
    for key in ("serve_spec_accept_rate", "serve_spec_proposed",
                "serve_spec_accepted", "serve_draft_steps",
                "serve_draft_prefill_chunks", "serve_draft_fallbacks"):
        assert key in out, key
    assert out["cache_mib"] > plain["cache_mib"]


@pytest.mark.parametrize("argv,error", [
    (["--spec_k=2"], SystemExit),
    (["--spec_k=2", "--draft_layers=1", "--draft_ckpt=/x"], SystemExit),
    (["--spec_k=2", "--draft_layers=2"], SystemExit),
    (["--spec_k=2", "--draft_ckpt=/nonexistent"], SystemExit),
    (["--draft_layers=1"], NotImplementedError),
    (["--spec_k=2", "--draft_layers=1", "--draft_precision=int8"],
     NotImplementedError)],
    ids=["no_draft", "two_drafts", "full_depth", "no_manifest", "tuner_k",
         "draft_precision"])
def test_serve_gpt_spec_flag_errors(argv, error):
    """Usage errors where the reference has them; the tuner's
    ``spec_k = 0`` with a draft and ``--draft_precision`` still raise
    "not yet ported"."""
    with pytest.raises(error) as info:
        serve_gpt.run(_TINY + argv)
    if error is NotImplementedError:
        assert "not yet ported" in str(info.value)
