"""Sharded decode and serving of the port's GPT against the JAX package.

One gloo spawn a world size: 2 ranks on a model axis of 2, then 4 ranks
on data 2 x model 2. The ranks run this file as a script (torch, numpy
and the port only) and write their results; this process holds the JAX
side, on the conftest's CPU mesh, and the port's one-rank runs, built
while the ranks run. Every wait on the ranks is bounded (the ranks'
process group too). A tiny f32 GPT (2 layers, 4 heads, d 32, vocab 128),
every leaf of its seeded init jittered.

(a) ``generate(mesh=)`` greedy at model 2 and at data 2 x model 2: the
    tokens equal JAX's ``generate(mesh=)`` on the same mesh and JAX's
    unsharded ``generate`` (the reference's own contract), the last
    step's logits (gathered whole) within ``LOGITS_ATOL`` of JAX's, and
    the call's counted collectives exact.
(b) Chunked prefill (``prefill_chunk=3``, ``kv_heads=2``): the tokens
    equal JAX's sharded and unsharded chunked decode.
(c) Sampled rows (temperature 0.9, top-k 5): equal to the port's
    unsharded ``generate`` — each row keeps its global stream.
(d) The int8 KV cache (GQA): tokens equal to the port's unsharded int8
    decode.
(e) ``DecodeEngine(mesh=)`` with the requests of the reference's
    sharded-engine test (4 slots, chunk 5): tokens equal to JAX's
    unsharded engine (the greedy request) and to the port's unsharded
    engine (both); each rank's KV cache is the unsharded one's over
    data x model.
(f) The same requests and a shared 8-token stem through prefix pages (a
    hit on pages another data line saved) and through ``spec_k`` 2 on a
    1-layer truncated draft: every stream equals the plain unsharded
    engine's.
(g) One decode step's counted collectives, exact on every rank.
(h) The refusals: a batch the data axis does not divide (as the
    reference's test), ``--n_slots`` the data axis does not divide,
    beams with a mesh, the fleet's flags that still have no port
    (``--draft_precision``, ``--draft_publish_dir``, a draft with
    ``--spec_k`` 0: "not yet ported"), and ``swap_params`` over a mesh of
    a set no rank staged (a fleet's roll over a mesh is
    ``tests/test_torch_tp_fleet.py``'s).
(i) A leader that raises between calls stops its followers: they return
    a failed stop, and every rank ends within the bounded wait.
(j) ``serve_gpt --mesh_model 2`` and ``generate_gpt --mesh_model 2`` from
    a tiny ``train_gpt`` logdir: rank 0's rows equal the unsharded
    launchers'.

    python tests/test_torch_tp_serve.py RANK WORLD STORE_FILE OUT_DIR
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import os
import sys
import types

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
for _p in (ROOT, TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from dtf_tpu_torch import convert  # noqa: E402
from dtf_tpu_torch.core import comms  # noqa: E402
from dtf_tpu_torch.models import gpt as tgpt  # noqa: E402

#: f32 logits against the JAX package's
LOGITS_ATOL = 1e-5
#: the bound on every wait for the ranks, and the ranks' group timeout
WAIT_S = 60
B, T_P, N_NEW, DECODE_LEN = 4, 8, 8, 24
MAX_LEN, N_SLOTS, CHUNK = 48, 4, 5
#: generate's cases: name → (config fields, generate options)
GEN_CASES = {
    "greedy": ({}, {}),
    "chunked_gqa": ({"kv_heads": 2}, {"prefill_chunk": 3}),
    "sampled": ({}, {"temperature": 0.9, "top_k": 5, "seed": 11}),
    "int8": ({"kv_heads": 2, "kv_cache_dtype": "int8"}, {}),
}
#: the reference's sharded-engine requests (tests/test_serve.py)
REQS = [dict(prompt=[5, 9, 2], max_new=8),
        dict(prompt=list(range(1, 13)), max_new=6, temperature=0.9, seed=7)]
STEM = [17, 3, 99, 41, 8, 8, 120, 64]
#: (f): REQS and six requests on one 8-token stem (two 4-token pages),
#: two of them sampled — the later ones hit the pages the earlier saved
PAGE_REQS = REQS + [dict(prompt=STEM + [i + 1] * (i % 3 + 1), max_new=5,
                         temperature=0.8 if i % 3 == 2 else 0.0,
                         seed=30 + i) for i in range(6)]
#: engine name → (engine options, requests)
ENGINES = {
    "plain": ({}, REQS),
    "pages": ({"prefix_pages": 8, "kv_page_size": 4}, PAGE_REQS),
    "spec": ({"spec_k": 2}, PAGE_REQS),
}
SERVE_REQUESTS = "12,7,99;5,6,7,8,9,10,11;3,3/4"


def tree(kv_heads=None):
    """The seeded init of the tiny GPT, every leaf jittered (biases and
    LayerNorm affines not the trivial 0 / 1): numpy only, for the ranks
    and this process alike."""
    cfg = tgpt.GPTConfig.tiny(kv_heads=kv_heads)
    rng = np.random.default_rng(1)

    def jitter(t):
        if isinstance(t, dict):
            return {k: jitter(v) for k, v in t.items()}
        return t + rng.normal(0, 0.05, t.shape).astype(np.float32)

    return jitter(convert.init_params(cfg, 0))


def port_cfg(**kw):
    return tgpt.GPTConfig.tiny(dtype=torch.float32, **kw)


def prompts():
    return np.random.default_rng(5).integers(0, 128, (B, T_P))


def mesh_config(world):
    from dtf_tpu_torch.core.mesh import MeshConfig

    return MeshConfig(model=2) if world == 2 else MeshConfig(data=2, model=2)


def port_model(cfg, mesh=None):
    model = tgpt.GPT(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(tgpt.tp_shard(
        convert.params_from_flax(tree(cfg.kv_heads)), mesh))
    return model.eval()


# --- generate ----------------------------------------------------------------

def gen_run(case, mesh=None):
    """Case ``case`` of generate: its tokens, the last step's whole
    logits and (over a mesh) the call's counted collectives."""
    fields, opts = GEN_CASES[case]
    model = port_model(port_cfg(decode_len=DECODE_LEN, **fields), mesh)
    comms.reset_collective_counts()
    out = tgpt.generate(model, torch.from_numpy(prompts()), N_NEW,
                        mesh=mesh, **opts)
    counts = dict(comms.collective_counts)
    # the logits that chose the last token, teacher-forced on the output
    rows = out
    if mesh is not None:
        n = B // mesh.data_size
        rows = out[mesh.data_index * n:(mesh.data_index + 1) * n]
    with torch.no_grad():
        cache = model.init_cache(rows.shape[0])
        logits = model(rows[:, :T_P], cache)
        for j in range(T_P, T_P + N_NEW - 1):
            logits = model(rows[:, j:j + 1], cache)
        last = model.vocab_rows(logits[:, -1])
    if mesh is not None and mesh.data_size > 1:
        last = comms.gather_rows(last, mesh.data_group)
    return {"tokens": out, "logits": last, "collectives": counts}


def gen_collectives_want(case, mesh, layers=2):
    """generate's counted collectives, from the code: each forward (the
    prefill's, one a chunk under ``prefill_chunk``, then one a token)
    sums the embedding and each layer's two row-parallel outputs over the
    model group (2L + 1 all-reduces); each of the N_NEW sampled rows'
    vocabularies is gathered (1 all-gather); over a data split one
    all-gather of the output."""
    chunk = GEN_CASES[case][1].get("prefill_chunk", 0)
    prefills = -(-T_P // chunk) if chunk else 1
    return {"all_reduce": (prefills + N_NEW - 1) * (2 * layers + 1),
            "all_gather": N_NEW + (mesh.data_size > 1), "reduce_scatter": 0,
            "ring_exchange": 0, "broadcast": 0}


# --- the engine -----------------------------------------------------------

def engine_of(name, mesh=None):
    from dtf_tpu_torch.serve import DecodeEngine

    opts, _ = ENGINES[name]
    cfg = port_cfg()
    params = tgpt.tp_shard(convert.params_from_flax(tree()), mesh)
    if opts.get("spec_k"):
        dcfg, dparams = tgpt.draft_truncate(cfg, params, 1)
        opts = dict(opts, draft_cfg=dcfg, draft_params=dparams)
    return DecodeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                        prefill_chunk=CHUNK, device="cpu", mesh=mesh,
                        **opts)


def kv_bytes(engine):
    """The bytes of the slot cache's K/V leaves (the position counters
    are not KV)."""
    return sum(x.numel() * x.element_size()
               for layer in engine.state["cache"]
               for name, x in layer.items()
               if x is not None and tgpt.batch_led_cache_key(name))


def serve(engine, reqs):
    from dtf_tpu_torch.serve import ServeClient

    client = ServeClient(engine)
    rids = [client.submit(**r) for r in reqs]
    client.drain()
    return [client.result(r) for r in rids]


def engine_rank(name, mesh):
    """Engine ``name`` on this rank: the leader serves the requests, then
    takes one more decode step counted; a follower runs the calls,
    counting the collectives inside each (the announcing broadcast comes
    before it)."""
    eng = engine_of(name, mesh)
    out = {"kv_bytes": kv_bytes(eng)}
    if eng.is_leader:
        with eng.leading():
            out["tokens"] = serve(eng, ENGINES[name][1])
            if eng.spec_k:      # the draft and verify calls alone
                out["verify_shape"] = list(eng.verify_all(
                    eng.draft_propose()).shape)
            comms.reset_collective_counts()
            eng.decode()
            out["step_collectives"] = dict(comms.collective_counts)
        out["counters"] = dict(eng.counters)
        if name == "plain":
            try:
                eng.swap_params(eng.params)
            except KeyError as e:
                out["swap_refused"] = str(e)
        return out
    run, ops = eng._run_op, []

    def counted(op, args):
        before = dict(comms.collective_counts)
        result = run(op, args)
        ops.append((op, {k: v - before[k]
                         for k, v in comms.collective_counts.items()}))
        return result

    eng._run_op = counted
    out["stopped_ok"] = eng.follow()
    out["last_op"] = ops[-1]
    return out


def failing_leader(mesh):
    """(i): the leader takes a decode step and raises; returns what each
    side saw."""
    eng = engine_of("plain", mesh)
    if not eng.is_leader:
        return {"stopped_ok": eng.follow()}
    try:
        with eng.leading():
            eng.decode()
            raise RuntimeError("planted leader failure")
    except RuntimeError as e:
        return {"raised": str(e)}


def step_collectives_want(mesh, layers=2):
    """A plain decode step's counted collectives, from the code: the
    call's broadcast, the embedding's and each layer's two row-parallel
    sums (2L + 1 all-reduces), the vocab gather, and over a data split
    the tokens' gather."""
    return {"all_reduce": 2 * layers + 1,
            "all_gather": 1 + (mesh.data_size > 1), "reduce_scatter": 0,
            "ring_exchange": 0, "broadcast": 1}


# --- the launchers -------------------------------------------------------

def serve_argv(logdir):
    return ["--device=cpu", f"--logdir={logdir}", "--n_slots=4",
            "--max_len=32", "--prefill_chunk=4", "--n_new=6",
            f"--requests={SERVE_REQUESTS}", "--emit_tokens"]


def generate_argv(logdir):
    return ["--device=cpu", f"--logdir={logdir}", "--batch=2",
            "--prompt=9,8,7,6", "--n_new=5"]


def launcher_rank(logdir, rank):
    """(j) on this rank: serve_gpt's and generate_gpt's rows over the
    model axis (rank 0's)."""
    from dtf_tpu_torch import generate_gpt, serve_gpt

    out, rows, _ = serve_gpt.run(serve_argv(logdir) + ["--mesh_model=2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        generate_gpt.main(generate_argv(logdir) + ["--mesh_model=2"])
    return {"serve_rows": rows, "serve_is_leader": out is not None,
            "serve_statuses": None if out is None
            else out["request_statuses"],
            "generate_rows": buf.getvalue().split()}


def n_slots_refused(logdir):
    """(h) at data 2 x model 2: ``--n_slots`` 3 is a usage error on every
    rank."""
    from dtf_tpu_torch import serve_gpt

    try:
        serve_gpt.run(serve_argv(logdir)[:2] + [
            "--n_slots=3", "--requests=1,2", "--mesh_model=2",
            "--mesh_data=2"])
    except SystemExit as e:
        return e.code
    return None


# --- the ranks ---------------------------------------------------------------

def rank_main(argv):
    import torch.distributed as dist

    from dtf_tpu_torch.core.mesh import make_mesh

    p = argparse.ArgumentParser()
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("store")
    p.add_argument("out")
    a = p.parse_args(argv)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{a.store}",
                            world_size=a.world, rank=a.rank,
                            timeout=datetime.timedelta(seconds=WAIT_S))
    mesh = make_mesh(mesh_config(a.world), torch.device("cpu"))
    out = {"generate": {c: gen_run(c, mesh) for c in GEN_CASES},
           "engines": {n: engine_rank(n, mesh) for n in ENGINES}}
    logdir = os.path.join(os.path.dirname(a.store), "run")
    if a.world == 2:
        out["failing_leader"] = failing_leader(mesh)
        out["launchers"] = launcher_rank(logdir, a.rank)
    else:
        out["n_slots_refused"] = n_slots_refused(logdir)
    torch.save(out, os.path.join(a.out, f"rank{a.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# --- the JAX side ------------------------------------------------------------

def jax_generate(case, world=None):
    """JAX's generate of ``case`` (greedy cases), on the CPU mesh of the
    ranks' shape under ``gpt.tp_rules`` when ``world`` is given: (tokens,
    the last step's logits of the unsharded model)."""
    import jax
    import jax.numpy as jnp

    from dtf_tpu.core.mesh import MeshConfig, make_mesh
    from dtf_tpu.core.sharding import shard_tree
    from dtf_tpu.models import gpt as jgpt

    fields, opts = GEN_CASES[case]
    cfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, decode_len=DECODE_LEN,
                              **fields)
    model = jgpt.GPT(cfg)
    params = jax.tree.map(jnp.asarray, tree(fields.get("kv_heads")))
    prompt = jnp.asarray(prompts(), jnp.int32)
    mesh = None
    if world is not None:
        mesh = make_mesh(MeshConfig(model=2) if world == 2
                         else MeshConfig(data=2, model=2),
                         devices=jax.devices()[:world])
        params = shard_tree(params, mesh, jgpt.tp_rules)
    out = np.asarray(jgpt.generate(model, params, prompt, N_NEW, mesh=mesh,
                                   **opts))
    if world is not None:
        return out, None
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((B, 1), jnp.int32)))
    cache0 = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                          shapes["cache"])
    logits, vs = model.apply({"params": params, "cache": cache0},
                             jnp.asarray(out[:, :T_P]), mutable=["cache"])
    for j in range(T_P, T_P + N_NEW - 1):
        logits, vs = model.apply({"params": params, **vs},
                                 jnp.asarray(out[:, j:j + 1]),
                                 mutable=["cache"])
    return out, np.asarray(logits[:, -1])


def jax_engine_tokens():
    """The JAX package's unsharded engine on REQS."""
    import jax.numpy as jnp

    from dtf_tpu.models import gpt as jgpt
    from dtf_tpu.serve import DecodeEngine as JEngine
    from dtf_tpu.serve import ServeClient as JClient

    eng = JEngine(jgpt.GPTConfig.tiny(dtype=jnp.float32), tree(),
                  n_slots=N_SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK)
    client = JClient(eng)
    rids = [client.submit(**r) for r in REQS]
    client.drain()
    return [client.result(r) for r in rids]


def port_one_rank():
    """The port's unsharded runs: generate's cases, the plain engine on
    PAGE_REQS (its first two requests are REQS) and its cache bytes."""
    gen = {c: gen_run(c) for c in GEN_CASES}
    eng = engine_of("plain")
    return {"generate": gen, "engine_tokens": serve(eng, PAGE_REQS),
            "kv_bytes": kv_bytes(eng)}


# --- the checks --------------------------------------------------------------

def _spawn(world, tmp_path):
    from test_torch_multirank import spawn_ranks

    return spawn_ranks(lambda r: [
        os.path.abspath(__file__), str(r), str(world),
        str(tmp_path / "store"), str(tmp_path)], tmp_path / "logs",
        world=world)


def _join(procs, world, tmp_path):
    from test_torch_multirank import join_ranks

    join_ranks(procs, WAIT_S)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _check_generate(ranks, one, jax_sharded, jax_one, world):
    mesh = types.SimpleNamespace(data_size=1 if world == 2 else 2)
    for r, got in enumerate(ranks):
        g = got["generate"]
        for case in GEN_CASES:
            # every rank returns the whole output; each equals the port's
            # unsharded decode (sampled rows keep their global streams)
            assert torch.equal(g[case]["tokens"],
                               one["generate"][case]["tokens"]), (case, r)
            assert g[case]["collectives"] == gen_collectives_want(
                case, mesh), (
                case, r, g[case]["collectives"])
        for case in ("greedy", "chunked_gqa"):
            toks = g[case]["tokens"].numpy()
            np.testing.assert_array_equal(toks, jax_sharded[case],
                                          err_msg=f"{case} vs JAX's mesh")
            np.testing.assert_array_equal(toks, jax_one[case][0],
                                          err_msg=f"{case} vs JAX's one")
            np.testing.assert_allclose(
                g[case]["logits"].numpy(), jax_one[case][1],
                atol=LOGITS_ATOL, rtol=LOGITS_ATOL,
                err_msg=f"{case} last-step logits, rank {r}")


def _check_engines(ranks, one, jax_tokens, world):
    mesh = types.SimpleNamespace(data_size=1 if world == 2 else 2)
    leader = ranks[0]["engines"]
    # (e) the plain engine: JAX's greedy request, the port's both
    assert leader["plain"]["tokens"][0] == jax_tokens[0]
    assert leader["plain"]["tokens"] == one["engine_tokens"][:len(REQS)]
    # (f) pages and speculation: the plain unsharded engine's streams
    for name in ("pages", "spec"):
        assert leader[name]["tokens"] == one["engine_tokens"], name
    assert leader["pages"]["counters"]["prefix_hit_tokens"] > 0
    assert leader["pages"]["counters"]["pages_loaded"] > 0
    assert leader["spec"]["counters"]["spec_accepted"] > 0
    assert leader["spec"]["verify_shape"] == [N_SLOTS, 2 * 3 + 1]
    assert "no staged shard set" in leader["plain"]["swap_refused"]
    # the KV cache a rank: the unsharded one's over data x model
    for got in ranks:
        assert got["engines"]["plain"]["kv_bytes"] * 2 * \
            mesh.data_size == one["kv_bytes"]
    # (g) one decode step's collectives, exact on every rank
    want = step_collectives_want(mesh)
    assert leader["plain"]["step_collectives"] == want
    for got in ranks[1:]:
        op, inside = got["engines"]["plain"]["last_op"]
        assert op == "decode" and dict(inside, broadcast=inside[
            "broadcast"] + 1) == want, (op, inside)
        assert all(e["stopped_ok"] for e in got["engines"].values())


def _train_logdir(tmp_path):
    from dtf_tpu_torch import train_gpt

    logdir = tmp_path / "run"
    train_gpt.run(["--device=cpu", "--size=tiny", "--batch_size=2",
                   "--seq_len=16", "--train_steps=2", "--log_every=1",
                   f"--logdir={logdir}"])
    return logdir


def test_sharded_decode_and_serving_at_model_2(tmp_path):
    logdir = _train_logdir(tmp_path)
    procs = _spawn(2, tmp_path)
    try:
        from dtf_tpu_torch import generate_gpt, serve_gpt

        jax_sharded = {c: jax_generate(c, 2)[0]
                       for c in ("greedy", "chunked_gqa")}
        jax_one = {c: jax_generate(c) for c in ("greedy", "chunked_gqa")}
        jax_tokens = jax_engine_tokens()
        one = port_one_rank()
        _, serve_rows, _ = serve_gpt.run(serve_argv(logdir))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            generate_gpt.main(generate_argv(logdir))
        generate_rows = buf.getvalue().split()
    finally:
        ranks = _join(procs, 2, tmp_path)
    _check_generate(ranks, one, jax_sharded, jax_one, 2)
    _check_engines(ranks, one, jax_tokens, 2)
    # (i) the planted failure: the follower saw a failed stop
    assert ranks[0]["failing_leader"] == {"raised": "planted leader failure"}
    assert ranks[1]["failing_leader"] == {"stopped_ok": False}
    # (j) the launchers: rank 0's rows are the unsharded launchers'
    lead, other = ranks[0]["launchers"], ranks[1]["launchers"]
    assert lead["serve_is_leader"] and not other["serve_is_leader"]
    assert lead["serve_statuses"] == {"done": 3}
    assert lead["serve_rows"] == serve_rows and len(serve_rows) == 3
    assert lead["generate_rows"] == generate_rows and len(
        generate_rows) == 2
    assert other["serve_rows"] == [] and other["generate_rows"] == []


def test_sharded_decode_and_serving_at_data_2_by_model_2(tmp_path):
    procs = _spawn(4, tmp_path)
    try:
        jax_sharded = {c: jax_generate(c, 4)[0]
                       for c in ("greedy", "chunked_gqa")}
        jax_one = {c: jax_generate(c) for c in ("greedy", "chunked_gqa")}
        jax_tokens = jax_engine_tokens()
        one = port_one_rank()
    finally:
        ranks = _join(procs, 4, tmp_path)
    _check_generate(ranks, one, jax_sharded, jax_one, 4)
    _check_engines(ranks, one, jax_tokens, 4)
    # (h) --n_slots the data axis does not divide: a usage error each rank
    assert [r["n_slots_refused"] for r in ranks] == [2] * 4


def test_sharded_decode_refusals():
    """(h) in one process: the reference's divisibility test, beams with
    a mesh, and a sharded fleet's flags that still have no port."""
    import jax
    import jax.numpy as jnp

    from dtf_tpu.core.mesh import MeshConfig, make_mesh
    from dtf_tpu.models import gpt as jgpt
    from dtf_tpu_torch import generate_gpt, serve_gpt

    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, decode_len=24)
    jmodel = jgpt.GPT(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((3, 1), jnp.int32))
    with pytest.raises(ValueError, match="not divisible"):
        jgpt.generate(jmodel, variables["params"],
                      jnp.zeros((3, 4), jnp.int32), 4,
                      mesh=make_mesh(MeshConfig(data=4, model=2)))
    model = port_model(port_cfg(decode_len=24))
    stub = types.SimpleNamespace(data_size=2, model_size=1, data_index=0,
                                 model_index=0)
    with pytest.raises(ValueError, match="not divisible"):
        tgpt.generate(model, torch.zeros(3, 4, dtype=torch.long), 4,
                      mesh=stub)
    with pytest.raises(ValueError, match="not divisible"):
        tgpt.check_decode_mesh(port_model(port_cfg(decode_len=24)),
                               types.SimpleNamespace(data_size=1,
                                                     model_size=3))
    with pytest.raises(SystemExit) as e:
        generate_gpt.main(["--device=cpu", "--size=tiny", "--init_seed=0",
                           "--num_beams=2", "--mesh_model=2"])
    assert e.value.code == 2
    base = ["--device=cpu", "--size=tiny", "--init_seed=0",
            "--requests=1,2", "--mesh_model=2"]
    for flags in (["--replicas=2", "--draft_precision=bf16"],
                  ["--replicas=2", "--swap_poll_ticks=2", "--publish_dir=/x",
                   "--draft_publish_dir=/y"],
                  ["--replicas=2", "--draft_layers=1"]):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            serve_gpt.run(base + flags)


if __name__ == "__main__":
    rank_main(sys.argv[1:])
