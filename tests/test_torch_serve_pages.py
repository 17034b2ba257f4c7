"""The prefix page pool in the port's serving engine against the JAX
package's, on the CPU at GPTConfig.tiny in float32 (4 slots of 48, chunk
5, pages of 4 tokens).

``cache_load_pages`` and ``cache_save_pages`` are bitwise JAX's (f32 and
int8 caches, ids past the chain and the dropped sentinel ids included);
the port's ``PrefixIndex`` answers a seeded sequence of acquire, save,
release, eviction and epoch operations as JAX's does. ONE JAX engine is
built for the file (an early-exit draft, k = 3, pages on): on requests
that share stems, the port's greedy streams, every tick's ``n_emit`` and
the page counters equal it, and with the pool off the streams still do.
Loads are bitwise copies of what a prefill wrote; pins drain to 0 on
done, error and timeout alike; a mounted store is shared.
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
from dtf_tpu.serve.pages import PrefixIndex as JPrefixIndex
from dtf_tpu_torch import convert, serve_gpt
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.serve import DecodeEngine, Request, Scheduler
from dtf_tpu_torch.serve.pages import PrefixIndex, pool_abstract

MAX_LEN, K, PAGE = 48, 3, 4
PAGES = dict(kv_page_size=PAGE, prefix_pages=8, page_save_after=1)


def _pair(**kw):
    return (jgpt.GPTConfig.tiny(dtype=jnp.float32, **kw),
            tgpt.GPTConfig.tiny(dtype=torch.float32, **kw))


def _tree(cfg, seed):
    tree = convert.init_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _pair()
    tree = _tree(tcfg, 0)
    return jcfg, tcfg, tree, convert.params_from_flax(tree)


# -- the page copies ------------------------------------------------------


def _random_like(x, rng):
    if x.dtype == torch.int8:
        return rng.integers(-127, 128, x.shape).astype(np.int8)
    if x.dtype == torch.long:
        return rng.integers(0, 40, x.shape).astype(np.int64)
    return rng.normal(0, 1, x.shape).astype(np.float32)


def _filled(int8, seed):
    """(port cache, port pool, JAX cache tree, JAX pool tree) with the
    same random contents: 3 slots of 48, a pool of 6 pages of 4."""
    _, tcfg = _pair(decode_len=MAX_LEN, slot_decode=True,
                    kv_cache_dtype="int8" if int8 else "")
    rng = np.random.default_rng(seed)
    cache = tgpt.GPT(tcfg, device="cpu").init_cache(3)
    pool = [{n: torch.zeros(x.shape, dtype=x.dtype) for n, x in layer.items()}
            for layer in pool_abstract(cache, 6, PAGE)]
    jcache, jpool = {}, {}
    for i, (layer, player) in enumerate(zip(cache, pool)):
        jl = jcache.setdefault(f"layer_{i}", {}).setdefault("attention", {})
        jp = jpool.setdefault(f"layer_{i}", {}).setdefault("attention", {})
        for name, x in layer.items():
            if x is None:
                continue
            val = _random_like(x, rng)
            x.copy_(torch.from_numpy(val))
            jl[name] = jnp.asarray(val.astype(np.int32)
                                   if name == "cache_index" else val)
            if name in player:
                pval = _random_like(player[name], rng)
                player[name].copy_(torch.from_numpy(pval))
                jp[name] = jnp.asarray(pval)
    return cache, pool, jcache, jpool


def _equal(ttree, jtree):
    for i, layer in enumerate(ttree):
        for name, x in layer.items():
            if x is not None and name != "cache_index":
                np.testing.assert_array_equal(
                    x.numpy(), np.asarray(jtree[f"layer_{i}"]["attention"]
                                          [name]), err_msg=f"{i}.{name}")


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("n_valid", [0, 3, 12])
def test_cache_load_pages_equals_jax_bitwise(int8, n_valid):
    """Pages ``ids[:n_valid]`` into slot 1 (the ids past it out of range
    on purpose: they are clamped and masked); the other slots and the
    positions past the chain keep their contents."""
    cache, pool, jcache, jpool = _filled(int8, seed=n_valid)
    ids = np.array([5, 0, 3, 1, 2, 4, 9, 77, 3, 0, 1, 2], np.int64)
    want = jgpt.cache_load_pages(jcache, jpool, jnp.int32(1),
                                 jnp.asarray(ids, jnp.int32),
                                 jnp.int32(n_valid))
    tgpt.cache_load_pages(cache, pool, torch.tensor([1]),
                          torch.from_numpy(ids), torch.tensor(n_valid))
    _equal(cache, want)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("ids", [[2, 6, 0, 6, 5, 7, 1, 9, 6, 6, 6, 6],
                                 [6] * 12, [0, 1, 2, 3, 4, 5] + [6] * 6],
                         ids=["some_dropped", "all_dropped", "tail"])
def test_cache_save_pages_equals_jax_bitwise(int8, ids):
    """Slot 2's pages to pool ids; an id >= P (6) drops its page (the
    reference's drop-mode scatter), the rest of the pool keeps its
    contents."""
    cache, pool, jcache, jpool = _filled(int8, seed=len(set(ids)))
    want = jgpt.cache_save_pages(jcache, jpool, jnp.int32(2),
                                 jnp.asarray(ids, jnp.int32))
    tgpt.cache_save_pages(cache, pool, torch.tensor([2]),
                          torch.tensor(ids))
    _equal(pool, want)


def _index_ops(idx_cls, seed):
    """A seeded run of admission lookups, engine-style saves (longest,
    the save filter, a chain of reserves), releases, a second epoch and
    its invalidation, on a 6-page pool (evictions and full pools
    included); everything observable after each operation."""
    idx = idx_cls(6, 2, save_after=2)
    rng = np.random.default_rng(seed)
    stems = [tuple(int(t) for t in rng.integers(0, 4, 6)) for _ in range(3)]
    handles, log = [], []
    for step in range(160):
        epoch = int(step >= 120)
        prompt = stems[rng.integers(0, 3)] + tuple(
            int(t) for t in rng.integers(0, 4, rng.integers(0, 5)))
        op = int(rng.integers(0, 3))
        if op == 0:
            h = idx.acquire(prompt, epoch=epoch)
            log.append(None if h is None else
                       ([e.page_id for e in h.entries], h.n_tokens))
            if h is not None:
                handles.append(h)
        elif op == 1:
            full = len(prompt) // 2
            have, parent = idx.longest(prompt, cap=full, epoch=epoch)
            full = have + idx.save_eligible(prompt, have, full, epoch=epoch)
            saved = []
            for i in range(have, full):
                ent = idx.reserve(prompt[:(i + 1) * 2], parent, epoch=epoch)
                if ent is None:
                    break
                saved.append(ent.page_id)
                parent = ent
            log.append((have, saved))
        elif handles:
            idx.release(handles.pop(int(rng.integers(0, len(handles)))))
        if step == 140:
            log.append(idx.invalidate_stale(1))
        log.append((dict(idx.stats), idx.n_free, idx.n_entries,
                    idx.pinned()))
    for h in handles:
        idx.release(h)
    log.append(idx.pinned())
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_index_answers_as_the_reference(seed):
    assert _index_ops(PrefixIndex, seed) == _index_ops(JPrefixIndex, seed)


def test_prefix_index_checks():
    """Exact-match verification under forced hash collisions, a double
    release, and the reserve rules."""
    idx = PrefixIndex(4, 2, save_after=1, hash_fn=lambda t: 0)
    a = idx.reserve((1, 2), None)
    b = idx.reserve((3, 4), None)
    ha, hb = idx.acquire((1, 2, 9)), idx.acquire((3, 4, 9))
    assert ha.entries == (a,) and hb.entries == (b,) and a is not b
    assert idx.acquire((5, 6, 9)) is None
    idx.release(ha)
    with pytest.raises(RuntimeError, match="twice"):
        idx.release(ha)
    with pytest.raises(ValueError, match="does not extend"):
        idx.reserve((1, 2, 3), a)
    with pytest.raises(ValueError, match="already registered"):
        idx.reserve((1, 2), None)
    with pytest.raises(ValueError, match="epoch"):
        idx.reserve((1, 2, 3, 4), a, epoch=1)
    for bad in (dict(n_pages=0, page_size=2), dict(n_pages=2, page_size=0),
                dict(n_pages=2, page_size=2, save_after=0)):
        with pytest.raises(ValueError):
            PrefixIndex(**bad)


# -- the engine against the JAX engine -------------------------------------


def _stem_reqs(n=9, seed=1):
    """Requests on two shared stems (12 and 9 tokens: 3 and 2 pages) with
    1–7-token tails, and one without a stem."""
    rng = np.random.default_rng(seed)
    stems = [rng.integers(0, 128, 12).tolist(), rng.integers(0, 128, 9)
             .tolist()]
    reqs = [dict(prompt=stems[i % 2] + rng.integers(
        0, 128, int(rng.integers(1, 8))).tolist(),
        max_new=int(rng.integers(2, 12))) for i in range(n - 1)]
    return reqs + [dict(prompt=rng.integers(0, 128, 10).tolist(), max_new=5)]


def _logged(engine):
    log, real = [], engine.decode

    def decode(**kw):
        out = real(**kw)
        log.append(np.asarray(out[2]).tolist())
        return out

    engine.decode = decode
    return log


def _run(engine, reqs, sched_cls=Scheduler, req_cls=Request, **kw):
    sched = sched_cls(engine, None, prefill_chunks_per_tick=2, **kw)
    rids = [sched.submit(req_cls(**r)) for r in reqs]
    sched.run_until_idle()
    return [sched.poll(rid)["tokens"] for rid in rids], sched


_COUNTERS = ("pages_loaded", "pages_saved", "prefix_hit_tokens",
             "prefix_miss_tokens", "prefill_chunks", "draft_prefill_chunks",
             "decode_steps", "spec_proposed", "spec_accepted")


@pytest.fixture(scope="module")
def jax_pages(tiny):
    """THE JAX engine of this file (early-exit draft of 1 layer, pages
    on): the stem requests' streams, each tick's n_emit, the counters."""
    jcfg, _, tree, _ = tiny
    dcfg, dtree = jgpt.draft_truncate(jcfg, tree, 1)
    eng = JEngine(jcfg, tree, n_slots=4, max_len=MAX_LEN, prefill_chunk=5,
                  draft_cfg=dcfg, draft_params=dtree, spec_k=K, **PAGES)
    log = _logged(eng)
    toks, _ = _run(eng, _stem_reqs(), JScheduler, JRequest)
    return {"tokens": toks, "n_emit": log,
            "counters": {k: eng.counters[k] for k in _COUNTERS},
            "prefix": eng.prefix_stats()}


def _port(tcfg, sd, pages=True, draft="truncated", **kw):
    dkw = {}
    if draft == "truncated":
        dcfg, dsd = tgpt.draft_truncate(tcfg, sd, 1)
        dkw = dict(draft_cfg=dcfg, draft_params=dsd, spec_k=K)
    elif draft == "self":
        dkw = dict(draft_cfg=tcfg, draft_params=sd, spec_k=K)
    return DecodeEngine(tcfg, sd, n_slots=4, max_len=MAX_LEN,
                        prefill_chunk=5, device="cpu", **dkw,
                        **(PAGES if pages else {}), **kw)


def test_pages_on_equals_jax(tiny, jax_pages):
    """Hits, misses and saves on shared stems, under a speculative tick:
    the streams, every tick's n_emit, the page and spec counters and the
    pool's aggregates equal the JAX engine's; pins drain to 0."""
    _, tcfg, _, sd = tiny
    eng = _port(tcfg, sd)
    log = _logged(eng)
    toks, _ = _run(eng, _stem_reqs())
    assert toks == jax_pages["tokens"]
    assert log == jax_pages["n_emit"]
    assert {k: eng.counters[k] for k in _COUNTERS} == jax_pages["counters"]
    assert eng.prefix_stats() == jax_pages["prefix"]
    assert eng.counters["pages_loaded"] > 0
    assert eng.prefix_stats()["pinned"] == 0
    assert eng.page_trace_counts == {"save": 1, "load": 1}


@pytest.mark.parametrize("draft", ["truncated", "self", None])
def test_pages_off_streams_equal(tiny, jax_pages, draft):
    """The pool off (and the draft self or none): the same greedy streams
    — pages and speculation move the work, not the tokens."""
    _, tcfg, _, sd = tiny
    toks, _ = _run(_port(tcfg, sd, pages=False, draft=draft), _stem_reqs())
    assert toks == jax_pages["tokens"]


def test_self_draft_loads_its_pages_too(tiny):
    """Self-speculation with the pool: a hit lands in the draft's cache
    as well, so the draft prefills only the tail; sampled rows too equal
    the plain engine's."""
    _, tcfg, _, sd = tiny
    reqs = _stem_reqs()
    for i, r in enumerate(reqs):
        if i % 3 == 1:
            r.update(temperature=0.8, top_p=0.9, seed=50 + i)
    plain, _ = _run(_port(tcfg, sd, pages=False, draft=None), reqs)
    eng = _port(tcfg, sd, draft="self")
    toks, _ = _run(eng, reqs)
    off = _port(tcfg, sd, pages=False, draft="self")
    _run(off, reqs)
    assert toks == plain
    assert eng.counters["draft_pages_loaded"] == eng.counters["pages_loaded"]
    assert eng.counters["pages_loaded"] > 0
    assert (eng.counters["draft_prefill_chunks"]
            < off.counters["draft_prefill_chunks"])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_loaded_pages_are_bitwise_a_prefill(tiny, int8):
    """A slot's leading positions after a load equal, bit for bit, the
    pool pages and those a fresh prefill of the same stem writes; the
    load leaves the slot inactive and not done."""
    _, tcfg, tree, _ = tiny
    if int8:
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    sd = convert.params_from_flax(tree)
    eng = DecodeEngine(tcfg, sd, n_slots=3, max_len=MAX_LEN,
                       prefill_chunk=5, device="cpu", kv_page_size=PAGE,
                       prefix_pages=8)
    stem = list(range(3, 15))                            # 3 pages
    for _ in range(2):                                   # seen twice: saved
        eng.prefill(0, stem + [99, 98])
        eng.save_prefix_pages(0, stem + [99, 98])
    assert eng.counters["pages_saved"] == 3
    handle = eng.prefix_match(stem + [7])
    assert handle.n_tokens == 12
    eng.state["active"][2] = eng.state["done"][2] = True
    eng.load_prefix(2, handle)
    assert not eng.state["active"][2] and not eng.state["done"][2]
    ids = [e.page_id for e in handle.entries]
    for layer, player in zip(eng.state["cache"], eng.page_store.pool):
        for name, x in layer.items():
            if x is None or name == "cache_index":
                continue
            assert torch.equal(x[2, :, :12], x[0, :, :12]), name
            pages = player[name][ids].transpose(0, 1).reshape(
                x.shape[1], 12, x.shape[3])
            assert torch.equal(x[2, :, :12], pages), name
    eng.release_prefix(handle)
    assert eng.prefix_stats()["pinned"] == 0


def test_pins_released_on_error_and_timeout(tiny):
    """A request that fails in admission after its chain loaded, and one
    that times out in the queue holding nothing, leave no pin; the pool
    keeps serving hits."""
    _, tcfg, _, sd = tiny
    eng = _port(tcfg, sd, draft=None)
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    real = eng.prefill_chunk_into

    def poisoned(slot, prompt, *a, **kw):
        if prompt[-1] == 127:
            raise RuntimeError("poisoned prompt")
        return real(slot, prompt, *a, **kw)

    eng.prefill_chunk_into = poisoned
    stem = list(range(1, 13))
    reqs = [dict(prompt=stem + [5], max_new=3),
            dict(prompt=stem + [127], max_new=3),
            dict(prompt=stem + [6], max_new=3, ttft_deadline_s=0.3),
            dict(prompt=stem + [8], max_new=3)]
    toks, sched = _run(eng, reqs, clock=clock)
    statuses = [sched.poll(i)["status"] for i in range(4)]
    assert statuses == ["done", "error", "timeout", "done"]
    assert eng.counters["pages_loaded"] >= 6
    assert eng.prefix_stats()["pinned"] == 0


def test_shared_store_and_cache_bytes(tiny):
    """An engine mounting another's page store hits the pages the other
    saved; cache_bytes counts the pool on its owner only, and the draft's
    cache; a store of another shape is refused."""
    _, tcfg, _, sd = tiny
    a = _port(tcfg, sd, draft=None)
    b = _port(tcfg, sd, draft=None, shared_pages=a.page_store)
    stem = list(range(20, 32))
    want = _run(_port(tcfg, sd, pages=False, draft=None),
                [dict(prompt=stem + [1], max_new=4)])[0]
    _run(a, [dict(prompt=stem + [2], max_new=4)])
    assert _run(b, [dict(prompt=stem + [1], max_new=4)])[0] == want
    assert b.counters["pages_loaded"] == 3 and a.counters["pages_saved"] == 3

    def nbytes(layers):
        return sum(x.numel() * x.element_size() for layer in layers
                   for x in layer.values() if x is not None)

    slot = nbytes(a.state["cache"])
    assert b.cache_bytes() == slot
    assert a.cache_bytes() == slot + nbytes(a.page_store.pool)
    spec = _port(tcfg, sd, pages=False)
    assert spec.cache_bytes() == slot + nbytes(spec.draft_state["cache"])
    with pytest.raises(ValueError, match="shared page pool"):
        DecodeEngine(tcfg, sd, n_slots=4, max_len=MAX_LEN, prefill_chunk=5,
                     device="cpu", kv_page_size=8, prefix_pages=8,
                     shared_pages=a.page_store)
    with pytest.raises(ValueError, match="shared page pool"):
        DecodeEngine(dataclasses.replace(tcfg, kv_cache_dtype="int8"), sd,
                     n_slots=4, max_len=MAX_LEN, prefill_chunk=5,
                     device="cpu", shared_pages=a.page_store, **PAGES)


def test_warm_page_programs_change_nothing(tiny):
    """The warm-up's no-op load and save leave every cache row and pool
    page as they were."""
    _, tcfg, _, sd = tiny
    eng = _port(tcfg, sd, draft=None)
    _run(eng, _stem_reqs(4))

    def snap():
        return [x.clone() for layers in (eng.state["cache"],
                                         eng.page_store.pool)
                for layer in layers for x in layer.values()
                if x is not None]

    before = snap()
    eng.warm_page_programs()
    assert all(torch.equal(x, y) for x, y in zip(before, snap()))
    assert eng.page_trace_counts == {"save": 1, "load": 1}


def test_page_validation_errors_match_the_reference(tiny):
    jcfg, tcfg, tree, sd = tiny
    common = dict(n_slots=2, max_len=MAX_LEN, prefill_chunk=5)
    cases = [(dict(prefix_pages=4), "kv_page_size >= 1", False),
             (dict(prefix_pages=4, kv_page_size=5), "does not divide",
              False),
             (dict(prefix_pages=4, kv_page_size=4), "slot=position", True),
             (dict(shared_pages=object()), "needs prefix_pages", False)]
    for kw, match, window in cases:
        jc, tc = ((dataclasses.replace(c, attn_window=8)
                   for c in (jcfg, tcfg)) if window else (jcfg, tcfg))
        with pytest.raises(ValueError, match=match):
            JEngine(jc, tree, **common, **kw)
        with pytest.raises(ValueError, match=match):
            DecodeEngine(tc, sd, device="cpu", **common, **kw)


# -- the launcher ----------------------------------------------------------

_TINY = ["--size=tiny", "--device=cpu", "--init_seed=0", "--n_slots=3",
         "--max_len=40", "--prefill_chunk=4", "--emit_tokens"]


def test_serve_gpt_prefix_pages(tmp_path):
    """``--prefix_pages`` / ``--kv_page_size`` with a ``--requests`` file
    of rows with their own budgets (``/N``): the rows equal the pool-off
    run's, pages are saved and loaded, the JSON line carries the pool's
    aggregates with ``pinned`` back at 0; speculation rides along."""
    stem = ",".join(str(t) for t in range(10, 22))
    path = tmp_path / "requests.txt"
    path.write_text("\n".join(f"{stem},{t}/{3 + t % 5}" for t in range(6)))
    argv = _TINY + [f"--requests=@{path}"]
    plain, prow, _ = serve_gpt.run(argv)
    out, rows, _ = serve_gpt.run(argv + ["--prefix_pages=16",
                                         "--kv_page_size=4"])
    spec, srows, _ = serve_gpt.run(argv + [
        "--prefix_pages=16", "--kv_page_size=4", "--spec_k=2",
        "--draft_layers=1"])
    assert rows == prow == srows
    assert [len(r.split(":")[1].split(",")) for r in rows] == [
        3 + t % 5 for t in range(6)]
    assert out["kv_page_size"] == 4 and out["prefix_pages"] == 16
    assert out["serve_pages_saved"] == 3 and out["serve_pages_loaded"] >= 9
    assert out["serve_prefix_pinned"] == 0 and spec["serve_prefix_pinned"] == 0
    assert out["serve_prefix_hits"] >= 3
    assert out["cache_mib"] > plain["cache_mib"]


@pytest.mark.parametrize("argv", [
    ["--kv_page_size=4"], ["--prefix_pages=8"],
    ["--prefix_pages=8", "--kv_page_size=3"],
    ["--requests=1,2/x"]],
    ids=["size_without_pages", "pages_without_size", "not_dividing",
         "bad_budget"])
def test_serve_gpt_page_flag_errors(argv):
    with pytest.raises(SystemExit):
        serve_gpt.run(_TINY + ["--requests=1,2"] + argv)
