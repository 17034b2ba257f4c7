"""A fleet and a rolling swap of sharded replicas of the port's GPT against
the JAX package and the port's unsharded fleet.

One gloo spawn a world size: 2 ranks on a model axis of 2, then 4 ranks
on data 2 x model 2. Each rank builds the same ``Router.build(mesh=)``
fleet of 2 replicas, round after round; rank 0 leads and the others
follow (``Router.follow``). The ranks run this file as a script (torch,
numpy and the port only) and write their results; this process holds the
JAX side (``dtf_tpu``'s ``Router.build(mesh=)`` on the conftest's CPU
mesh) and the port's unsharded runs, made while the ranks run. Every
wait on the ranks is bounded (the ranks' process group too). A tiny f32
GPT (2 layers, 4 heads, d 32, vocab 128), two published versions, every
leaf of each seeded init jittered.

(a) A 2-replica sharded fleet's greedy streams equal JAX's sharded fleet
    and the port's unsharded fleet (sampled ones the port's unsharded
    fleet); on each rank the replicas hold one set of tensors (by
    identity), and each rank's KV caches are 1/(D·M) of the unsharded.
(b) A roll v1 -> v2 under traffic (the publish dir polled by the
    leader): one swap, no rollback, every request done and stamped 1 or
    2, its stream the unsharded engine's on that version (a request that
    spans the roll completes on one version), every replica probed; the
    streams after the roll equal the port's unsharded fleet on v2 and
    JAX's sharded fleet on v2; on every rank both replicas serve v2 from
    one set, no staged set is left, and that set's logits equal JAX's
    unsharded v2 model's within ``LOGITS_ATOL``.
(c) ``wedge_in_swap`` on replica 1 rolls the partial fleet back on every
    rank: version 1 everywhere, each replica's tensors the version-1
    tensors by identity, the streams the v1 streams; the plan arms on
    the leader only.
(d) ``corrupt_publish`` is skipped with a warning: no rank stages or
    moves.
(e) A canary health breach (the canary's decode past the wedge bar on
    the leader's clock) rolls back fleet-wide.
(f) Pages never serve stale KV after a swap over a mesh.
(g) ``prefill_replicas`` 1 over the mesh equals the unsharded
    disaggregated fleet.
(h) A fleet with ``spec_k`` 2 and a truncated draft (and
    ``poison_draft`` on the leader) rolls once, its streams unchanged,
    the drafts on the new shards.
(i) An idle roll's counted collectives, exact on every rank: the
    staging, each swap and the commit are one announcing broadcast each
    (no tensor collective carries parameters), the probes decode steps.
(j) ``serve_gpt --mesh_model 2 --replicas 2 --swap_poll_ticks`` (at data
    2 x model 2 too) on a publish dir — at model 2 the one a tiny
    ``train_gpt --mesh_model 2 --publish_every 2`` wrote, versions 1 and
    2 whole: rank 0's line has ``final_version`` 2 and its rows equal
    the unsharded launcher's.
(k) A leader that raises between calls stops every follower of a
    two-engine fleet within the bounded wait.

Tolerance: greedy tokens exact, logits within ``LOGITS_ATOL``.

    python tests/test_torch_tp_fleet.py RANK WORLD STORE_FILE OUT_DIR
"""

from __future__ import annotations

import argparse
import datetime
import functools
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
for _p in (ROOT, TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from dtf_tpu_torch import convert  # noqa: E402
from dtf_tpu_torch.models import gpt as tgpt  # noqa: E402

#: f32 logits against the JAX package's
LOGITS_ATOL = 1e-5
#: the bound on every wait for the ranks, and the ranks' group timeout
WAIT_S = 60
N_SLOTS, MAX_LEN, CHUNK = 4, 48, 5
#: health thresholds no CPU tick reaches (a breach is planted where wanted)
CHAOS_HEALTH = dict(min_slow_s=1000.0, wedge_s=2000.0)
FLEET_REQS = [dict(prompt=[5, 9, 2], max_new=8),
              dict(prompt=list(range(1, 13)), max_new=6, temperature=0.9,
                   seed=7),
              dict(prompt=[3, 1, 4, 1, 5], max_new=6),
              dict(prompt=[7], max_new=7)]
ROLL_REQS = FLEET_REQS + [dict(prompt=[11, 12, 13, 14, 15, 16, 17],
                               max_new=8),
                          dict(prompt=[2, 2], max_new=5, temperature=0.8,
                               seed=3)]
STEM = [17, 3, 99, 41, 8, 8, 120, 64]
STEM_REQ = dict(prompt=STEM + [1, 2, 3, 4], max_new=4, seed=3)
PAGE_REQS = [dict(prompt=STEM + [i + 1] * (i % 3 + 1), max_new=5)
             for i in range(6)]
LOGIT_PROMPTS = [[5, 9, 2, 7], [1, 2, 3, 4]]
SERVE_REQUESTS = "12,7,99;5,6,7,8,9,10,11;3,3/4"


def version_tree(v):
    """Published version ``v``'s parameters: a seeded init, every leaf
    jittered (numpy only, for the ranks and this process alike)."""
    rng = np.random.default_rng(10 + v)

    def jitter(t):
        if isinstance(t, dict):
            return {k: jitter(x) for k, x in t.items()}
        return t + rng.normal(0, 0.05, t.shape).astype(np.float32)

    return jitter(convert.init_params(tgpt.GPTConfig.tiny(), v))


def port_cfg():
    return tgpt.GPTConfig.tiny(dtype=torch.float32)


def publish_versions(directory):
    from dtf_tpu_torch.publish import ParamPublisher

    pub = ParamPublisher(directory, wall=lambda: 5.0)
    for v in (1, 2):
        pub.publish(10 * v, convert.params_from_flax(version_tree(v)))
    pub.close()


def mesh_config(world):
    from dtf_tpu_torch.core.mesh import MeshConfig

    return MeshConfig(model=2) if world == 2 else MeshConfig(data=2, model=2)


def kv_bytes(engine):
    """The bytes of the slot cache's K/V leaves."""
    return sum(x.numel() * x.element_size()
               for layer in engine.state["cache"]
               for name, x in layer.items()
               if x is not None and tgpt.batch_led_cache_key(name))


# --- the fleet on a rank -----------------------------------------------------

def fleet(mesh, pub, version=1, *, spec=False, **kw):
    """The 2-replica fleet on ``version`` of ``pub``: this rank's shards
    (``mesh``) or the whole model (None)."""
    from dtf_tpu_torch.publish import load_published
    from dtf_tpu_torch.serve import HealthConfig, Router

    _, _, whole = load_published(pub, version)
    params = tgpt.tp_shard(whole, mesh)
    if spec:
        dcfg, dparams = tgpt.draft_truncate(port_cfg(), params, 1)
        kw.update(draft_cfg=dcfg, draft_params=dparams, spec_k=2)
    kw.setdefault("health", HealthConfig(**CHAOS_HEALTH))
    r = Router.build(port_cfg(), params, n_replicas=2, n_slots=N_SLOTS,
                     max_len=MAX_LEN, prefill_chunk=CHUNK, mesh=mesh,
                     device="cpu", **kw)
    r.stamp_version(version)
    return r


def serve(r, reqs):
    """Submit ``reqs`` to a leader's router, drain; (tokens, stamps)."""
    from dtf_tpu_torch.serve import Request

    rids = [r.submit(Request(**q)) for q in reqs]
    r.drain()
    polls = [r.poll(rid) for rid in rids]
    assert all(p["status"] == "done" for p in polls), polls
    return [p["tokens"] for p in polls], [p["version"] for p in polls]


def roll(r, pub, reqs, canary_ticks, *, before=2, **kw):
    """Submit ``reqs``, tick ``before`` times, poll ``pub`` for a new
    version and roll while draining; (tokens, stamps, the swap's version
    or None)."""
    from dtf_tpu_torch.publish import PublishWatcher
    from dtf_tpu_torch.serve import Request, SwapConfig

    rids = [r.submit(Request(**q)) for q in reqs]
    for _ in range(before):
        r.tick()
    watcher = kw.pop("watcher", None) or PublishWatcher(
        pub, applied_version=r.version)
    v = r.maybe_swap_published(
        watcher, config=SwapConfig(canary_ticks=canary_ticks), **kw)
    r.drain()
    if r.swap_in_progress:
        r.finish_swap()
    polls = [r.poll(rid) for rid in rids]
    assert all(p["status"] == "done" for p in polls), polls
    return [p["tokens"] for p in polls], [p["version"] for p in polls], v


def rank_view(r):
    """This rank's facts after a round: each replica's version, whether
    the replicas hold one set (identity), the drafts' sharing, the KV,
    the staged sets left and the plane's op statistics."""
    engs = r.engines
    ps = [e.params for e in engs]
    return {"versions": [e.param_version for e in engs],
            "one_set": all(ps[0][n] is p[n] for p in ps[1:] for n in ps[0]),
            "drafts_on_target": [
                all(x is e.params[n] for n, x in e.draft_params.items())
                for e in engs if e.spec_k],
            "kv_bytes": [kv_bytes(e) for e in engs],
            "staged_sets": len(engs[0].plane.sets),
            "op_stats": {op: (st["calls"], dict(st["collectives"]))
                         for op, st in engs[0].plane.op_stats.items()}}


def param_ids(r):
    return [{n: id(p) for n, p in e.params.items()} for e in r.engines]


def round_(r, lead):
    """One serving round: the leader runs ``lead(r)`` (its followers
    stopped after it), the others follow."""
    if r.is_leader:
        with r.leading():
            out = lead(r)
        return out
    return {"stopped_ok": r.follow()}


def case_a(mesh, pub):
    r = fleet(mesh, pub)

    def lead(r):
        toks, stamps = serve(r, FLEET_REQS)
        return {"tokens": toks, "stamps": stamps,
                "replicas": sorted({r.replica_of(i)
                                    for i in range(len(FLEET_REQS))})}

    return {**round_(r, lead), **rank_view(r)}


def case_b(mesh, pub):
    r = fleet(mesh, pub)

    def lead(r):
        toks, stamps, v = roll(r, pub, ROLL_REQS, 2)
        post, post_stamps = serve(r, [q for q in FLEET_REQS
                                      if not q.get("temperature")])
        st = r.stats()
        return {"tokens": toks, "stamps": stamps, "swapped_to": v,
                "post": post, "post_stamps": post_stamps,
                "swaps": st["router_swaps"],
                "rollbacks": st["router_swap_rollbacks"],
                "version": r.version,
                "probes": [e.counters["probe_decodes"] for e in r.engines],
                "postmortem": {k: r.postmortem_state()["router"][k] for k in
                               ("version", "replica_versions", "last_swap")},
                "trace_counts": r.trace_counts()}

    out = {**round_(r, lead), **rank_view(r)}
    # every rank in step: the served v2 set's logits through a plain
    # GPT(mesh=) that takes the replica's tensors as its own
    model = tgpt.GPT(tgpt.GPTConfig.tiny(dtype=torch.float32,
                                         decode_len=MAX_LEN),
                     device="cpu", mesh=mesh)
    model.load_state_dict(r.engines[1].params, assign=True)
    with torch.no_grad():
        prompts = torch.tensor(LOGIT_PROMPTS)
        out["logits"] = model.vocab_rows(
            model.eval()(prompts, model.init_cache(len(prompts)))[:, -1])
    return out


def case_c(mesh, pub):
    from dtf_tpu_torch.fault.inject import ServeFaultPlan
    from dtf_tpu_torch.serve import install_serve_fault

    r = fleet(mesh, pub)
    install_serve_fault(ServeFaultPlan.parse("wedge_in_swap@0:replica=1"),
                        r, sleep=lambda s: None, emit=lambda line: None)
    armed = ["swap_params" in vars(e) for e in r.engines]
    before = param_ids(r)

    def lead(r):
        toks, stamps, v = roll(r, pub, ROLL_REQS, 1)
        st = r.stats()
        return {"tokens": toks, "stamps": stamps, "swapped_to": v,
                "swaps": st["router_swaps"],
                "rollbacks": st["router_swap_rollbacks"],
                "version": r.version}

    out = {**round_(r, lead), **rank_view(r)}
    out.update(armed=armed, same_ids=param_ids(r) == before)
    return out


def case_d(mesh, pub):
    from dtf_tpu_torch.fault.inject import ServeFaultPlan
    from dtf_tpu_torch.publish import PublishWatcher
    from dtf_tpu_torch.serve import install_serve_fault

    r = fleet(mesh, pub)
    before = param_ids(r)

    def lead(r):
        watcher = PublishWatcher(pub, applied_version=1)
        install_serve_fault(ServeFaultPlan.parse("corrupt_publish@0"), r,
                            emit=lambda line: None, watcher=watcher)
        warned = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = lambda rec: warned.append(rec.getMessage())
        logging.getLogger("dtf_tpu_torch").addHandler(handler)
        try:
            toks, stamps, v = roll(r, pub, FLEET_REQS, 1, watcher=watcher)
        finally:
            logging.getLogger("dtf_tpu_torch").removeHandler(handler)
        return {"tokens": toks, "stamps": stamps, "swapped_to": v,
                "skipped": sorted(watcher.skipped), "version": r.version,
                "warned": [m for m in warned
                           if m.startswith("skipping published version 2")]}

    out = {**round_(r, lead), **rank_view(r)}
    out["same_ids"] = param_ids(r) == before
    return out


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def case_e(mesh, pub):
    from dtf_tpu_torch.publish import PublishWatcher
    from dtf_tpu_torch.serve import HealthConfig, Request, SwapConfig

    clk = _Clock()
    r = fleet(mesh, pub, clock=clk, health=HealthConfig(
        min_slow_s=1.0, wedge_s=5.0, probation_delay_s=1000.0))

    def lead(r):
        v = r.maybe_swap_published(PublishWatcher(pub, applied_version=1),
                                   config=SwapConfig(canary_ticks=4))
        r.tick()                            # the canary (replica 0) swaps
        eng = r.engines[0]
        orig = eng.decode

        def wedged(**kw):                   # before the call: the leader
            clk.t += 9.0                    # only, past the wedge bar
            return orig(**kw)

        eng.decode = wedged
        rids = [r.submit(Request(**q)) for q in FLEET_REQS]
        r.drain()
        if r.swap_in_progress:
            r.finish_swap()
        polls = [r.poll(rid) for rid in rids]
        st = r.stats()
        return {"swapped_to": v, "statuses": [p["status"] for p in polls],
                "tokens": [p["tokens"] for p in polls],
                "stamps": [p["version"] for p in polls],
                "rollbacks": st["router_swap_rollbacks"],
                "swaps": st["router_swaps"], "version": r.version,
                "cause": r._last_swap["cause"]}

    return {**round_(r, lead), **rank_view(r)}


def case_f(mesh, pub):
    from dtf_tpu_torch.publish import PublishWatcher
    from dtf_tpu_torch.serve import Request, SwapConfig

    r = fleet(mesh, pub, prefix_pages=8, kv_page_size=4, page_save_after=1)

    def lead(r):
        for s in r.schedulers:              # pages saved on v1, both
            s.submit(Request(**STEM_REQ))
            s.run_until_idle()
        hit = r.schedulers[1].submit(Request(**STEM_REQ))
        r.schedulers[1].run_until_idle()
        hits0 = sum(e.counters["pages_loaded"] for e in r.engines)
        r.maybe_swap_published(PublishWatcher(pub, applied_version=1),
                               config=SwapConfig(canary_ticks=1))
        r.finish_swap()
        toks, stamps = serve(r, [STEM_REQ])
        return {"hit_tokens": r.schedulers[1].poll(hit)["tokens"],
                "hits_before": hits0, "tokens": toks, "stamps": stamps,
                "hits_after": sum(e.counters["pages_loaded"]
                                  for e in r.engines),
                "pinned": [e.prefix_stats()["pinned"] for e in r.engines]}

    return {**round_(r, lead), **rank_view(r)}


def case_g(mesh, pub):
    r = fleet(mesh, pub, prefix_pages=8, kv_page_size=4, prefill_replicas=1)

    def lead(r):
        toks, _ = serve(r, PAGE_REQS)
        return {"tokens": toks, "handoffs": r.stats()["router_handoffs"]}

    return {**round_(r, lead), **rank_view(r)}


def case_h(mesh, pub):
    from dtf_tpu_torch.fault.inject import ServeFaultPlan
    from dtf_tpu_torch.serve import install_serve_fault

    r = fleet(mesh, pub, spec=True)
    install_serve_fault(ServeFaultPlan.parse("poison_draft@1"), r,
                        emit=lambda line: None)

    def lead(r):
        toks, stamps, v = roll(r, pub, ROLL_REQS, 2,
                               draft_factory=functools.partial(
                                   tgpt.early_exit_draft, port_cfg(), 1))
        st = r.stats()
        return {"tokens": toks, "stamps": stamps, "swapped_to": v,
                "swaps": st["router_swaps"],
                "fallbacks": st["router_draft_fallbacks"],
                "accepted": st["router_spec_accepted"]}

    return {**round_(r, lead), **rank_view(r)}


def case_i(mesh, pub):
    from dtf_tpu_torch.publish import PublishWatcher
    from dtf_tpu_torch.serve import SwapConfig

    r = fleet(mesh, pub)

    def lead(r):
        v = r.maybe_swap_published(PublishWatcher(pub, applied_version=1),
                                   config=SwapConfig(canary_ticks=1))
        r.finish_swap()
        return {"swapped_to": v}

    return {**round_(r, lead), **rank_view(r)}


def case_k(mesh, pub):
    from dtf_tpu_torch.serve import Request

    r = fleet(mesh, pub)
    if not r.is_leader:
        return {"stopped_ok": r.follow()}
    try:
        with r.leading():
            r.submit(Request(**FLEET_REQS[0]))
            r.tick()
            raise RuntimeError("planted leader failure")
    except RuntimeError as e:
        return {"raised": str(e)}


def serve_argv(pub):
    return ["--device=cpu", "--size=tiny", f"--publish_dir={pub}",
            "--publish_version=1",
            "--replicas=2", "--swap_poll_ticks=2", "--canary_ticks=1",
            "--n_slots=4", "--max_len=32", "--prefill_chunk=4", "--n_new=6",
            "--health_slow_s=1000", "--health_wedge_s=2000",
            f"--requests={SERVE_REQUESTS}", "--emit_tokens"]


def case_j(rank, world, mesh, work):
    """The launchers: at model 2, ``train_gpt --mesh_model 2`` publishes
    versions 1 and 2, then ``serve_gpt`` rolls over them; at data 2 x
    model 2 the fleet serves this process's publish dir."""
    from dtf_tpu_torch import serve_gpt, train_gpt

    pub = os.path.join(work, "pub")
    flags = [f"--mesh_model={mesh.model_size}",
             f"--mesh_data={mesh.data_size}"]
    if world == 2:
        pub = os.path.join(work, "train", "pub")
        train_gpt.run(["--device=cpu", "--size=tiny", "--batch_size=2",
                       "--seq_len=16", "--train_steps=4", "--log_every=1",
                       f"--logdir={os.path.join(work, 'train')}",
                       f"--publish_dir={pub}", "--publish_every=2", *flags])
    out, rows, _ = serve_gpt.run(serve_argv(pub) + flags)
    return {"rows": rows, "line": None if out is None else {
        k: out[k] for k in ("served_version", "final_version", "replicas",
                            "prefill_replicas", "request_statuses",
                            "router_swaps")}}


CASES = {"a": case_a, "b": case_b, "c": case_c, "d": case_d, "e": case_e,
         "f": case_f, "g": case_g, "h": case_h, "i": case_i, "k": case_k}


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
    pubs = {"d": os.path.join(a.out, "pub_corrupt")}
    out = {name: fn(mesh, pubs.get(name, os.path.join(a.out, "pub")))
           for name, fn in CASES.items()}
    out["j"] = case_j(a.rank, a.world, mesh, a.out)
    torch.save(out, os.path.join(a.out, f"rank{a.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# --- this process: JAX's sharded fleet and the port's unsharded runs ---------

def jax_fleet_tokens(world, version, reqs):
    """JAX's ``Router.build(mesh=)`` of 2 replicas on ``version``, on the
    CPU mesh of the ranks' shape: the tokens of ``reqs``."""
    import jax
    import jax.numpy as jnp

    from dtf_tpu.core.mesh import MeshConfig, make_mesh
    from dtf_tpu.core.sharding import shard_tree
    from dtf_tpu.models import gpt as jgpt
    from dtf_tpu.serve import HealthConfig, Request, Router

    mesh = make_mesh(MeshConfig(model=2) if world == 2
                     else MeshConfig(data=2, model=2),
                     devices=jax.devices()[:world])
    params = shard_tree(jax.tree.map(jnp.asarray, version_tree(version)),
                        mesh, jgpt.tp_rules)
    r = Router.build(jgpt.GPTConfig.tiny(dtype=jnp.float32), params,
                     n_replicas=2, n_slots=N_SLOTS, max_len=MAX_LEN,
                     prefill_chunk=CHUNK, mesh=mesh,
                     health=HealthConfig(**CHAOS_HEALTH))
    rids = [r.submit(Request(**q)) for q in reqs]
    r.drain()
    return [[int(t) for t in r.poll(rid)["tokens"]] for rid in rids]


def jax_logits(version):
    """JAX's unsharded model on ``version``: the last prompt position's
    logits of LOGIT_PROMPTS."""
    import jax
    import jax.numpy as jnp

    from dtf_tpu.models import gpt as jgpt

    cfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, decode_len=MAX_LEN)
    model = jgpt.GPT(cfg)
    params = jax.tree.map(jnp.asarray, version_tree(version))
    prompts = jnp.asarray(LOGIT_PROMPTS, jnp.int32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((len(LOGIT_PROMPTS), 1),
                                         jnp.int32)))
    cache = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                         shapes["cache"])
    logits, _ = model.apply({"params": params, "cache": cache}, prompts,
                            mutable=["cache"])
    return np.asarray(logits[:, -1])


def port_one(pub):
    """The port's unsharded runs: one engine's stream of every request on
    each version, the unsharded fleet's (a) and disaggregated fleet's
    (g) streams, and one engine's KV bytes."""
    from dtf_tpu_torch.publish import load_published
    from dtf_tpu_torch.serve import DecodeEngine, ServeClient

    streams = {}
    for v in (1, 2):
        eng = DecodeEngine(port_cfg(), load_published(pub, v)[2],
                           n_slots=N_SLOTS, max_len=MAX_LEN,
                           prefill_chunk=CHUNK, device="cpu")
        client = ServeClient(eng)
        rids = [client.submit(**q) for q in ROLL_REQS + [STEM_REQ]]
        client.drain()
        streams[v] = [client.result(rid) for rid in rids]
    unsharded = fleet(None, pub)
    disagg = fleet(None, pub, prefix_pages=8, kv_page_size=4,
                   prefill_replicas=1)
    return {"streams": streams,
            "fleet": serve(unsharded, FLEET_REQS)[0],
            "disagg": serve(disagg, PAGE_REQS)[0],
            "kv_bytes": kv_bytes(unsharded.engines[0])}


# --- the checks --------------------------------------------------------------

def _spawn(world, tmp_path):
    from test_torch_multirank import spawn_ranks

    publish_versions(tmp_path / "pub")
    shutil.copytree(tmp_path / "pub", tmp_path / "pub_corrupt")
    return spawn_ranks(lambda r: [
        os.path.abspath(__file__), str(r), str(world),
        str(tmp_path / "store"), str(tmp_path)], tmp_path / "logs",
        world=world)


def _join(procs, world, tmp_path):
    from test_torch_multirank import join_ranks

    join_ranks(procs, WAIT_S)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _on_stamp(streams, idx, toks, stamps):
    """Each request's stream equals the unsharded engine's on the version
    it is stamped with."""
    for i, t, v in zip(idx, toks, stamps):
        assert t == streams[v][i], (i, v)


def _check(ranks, one, jax_v1, jax_v2, logits_v2, world):
    data = 1 if world == 2 else 2
    lead, rest = ranks[0], ranks[1:]
    streams = one["streams"]
    greedy = [i for i, q in enumerate(FLEET_REQS) if not q.get("temperature")]
    for got in rest:
        for name in CASES:
            want = name != "k"
            assert got[name]["stopped_ok"] is want, (name, got[name])
    # (a)
    a = lead["a"]
    assert a["tokens"] == one["fleet"] and a["replicas"] == [0, 1]
    assert [a["tokens"][i] for i in greedy] == [jax_v1[i] for i in greedy]
    for got in ranks:
        assert got["a"]["one_set"] and got["a"]["versions"] == [1, 1]
        assert all(b * 2 * data == one["kv_bytes"]
                   for b in got["a"]["kv_bytes"]), got["a"]["kv_bytes"]
    # (b)
    b = lead["b"]
    assert b["swapped_to"] == 2 and b["swaps"] == 1.0 and b["rollbacks"] == 0
    assert set(b["stamps"]) <= {1, 2} and b["version"] == 2
    _on_stamp(streams, range(len(ROLL_REQS)), b["tokens"], b["stamps"])
    assert b["post_stamps"] == [2] * len(greedy)
    assert b["post"] == [streams[2][i] for i in greedy] == jax_v2
    assert all(n >= 1 for n in b["probes"])
    assert b["postmortem"] == {"version": 2, "replica_versions": [2, 2],
                               "last_swap": {"version": 2,
                                             "outcome": "done"}}
    assert b["trace_counts"] == [{"prefill": 1, "decode": 1}] * 2
    for got in ranks:
        assert got["b"]["versions"] == [2, 2] and got["b"]["one_set"]
        assert got["b"]["staged_sets"] == 0
        np.testing.assert_allclose(got["b"]["logits"].numpy(), logits_v2,
                                   atol=LOGITS_ATOL, rtol=LOGITS_ATOL)
    # (c)
    c = lead["c"]
    assert c["swapped_to"] == 2 and c["rollbacks"] == 1.0 and c["swaps"] == 0
    assert c["version"] == 1 and c["stamps"] == [1] * len(ROLL_REQS)
    _on_stamp(streams, range(len(ROLL_REQS)), c["tokens"], c["stamps"])
    assert c["armed"] == [False, True]
    for got in ranks:
        assert got["c"]["versions"] == [1, 1] and got["c"]["same_ids"]
        assert got["c"]["staged_sets"] == 0 and got["c"]["one_set"]
        assert got["c"]["op_stats"]["swap"][0] == 2     # the canary, back
    assert all(not got["c"]["armed"][1] for got in rest)
    # (d)
    d = lead["d"]
    assert d["swapped_to"] is None and d["skipped"] == [2]
    assert len(d["warned"]) == 1, d["warned"]
    assert d["version"] == 1 and d["stamps"] == [1] * len(FLEET_REQS)
    for got in ranks:
        assert got["d"]["versions"] == [1, 1] and got["d"]["same_ids"]
        assert "stage" not in got["d"]["op_stats"]
    # (e)
    e = lead["e"]
    assert e["swapped_to"] == 2 and e["rollbacks"] == 1.0 and e["swaps"] == 0
    assert "canary" in e["cause"] and e["version"] == 1
    assert e["statuses"] == ["done"] * len(FLEET_REQS)
    _on_stamp(streams, range(len(FLEET_REQS)), e["tokens"], e["stamps"])
    for got in ranks:
        assert got["e"]["versions"] == [1, 1] and got["e"]["staged_sets"] == 0
    # (f)
    f = lead["f"]
    stem = len(ROLL_REQS)
    assert f["hit_tokens"] == streams[1][stem] and f["hits_before"] >= 2
    assert f["stamps"] == [2] and f["tokens"] == [streams[2][stem]]
    assert f["hits_after"] == f["hits_before"] and f["pinned"] == [0, 0]
    # (g)
    assert lead["g"]["tokens"] == one["disagg"]
    assert lead["g"]["handoffs"] >= 1
    # (h)
    h = lead["h"]
    assert h["swapped_to"] == 2 and h["swaps"] == 1.0
    _on_stamp(streams, range(len(ROLL_REQS)), h["tokens"], h["stamps"])
    assert h["fallbacks"] >= 1 and h["accepted"] > 0
    for got in ranks:
        assert got["h"]["versions"] == [2, 2] and got["h"]["one_set"]
        assert got["h"]["drafts_on_target"] == [True, True]
    # (i) the idle roll, exact on every rank
    decode = {"all_reduce": 2 * 2 + 1, "all_gather": 1 + (data > 1),
              "reduce_scatter": 0, "ring_exchange": 0, "broadcast": 1}
    one_call = dict.fromkeys(decode, 0) | {"broadcast": 1}
    want = {"stage": (1, one_call),
            "swap": (2, {k: 2 * v for k, v in one_call.items()}),
            "decode": (2, {k: 2 * v for k, v in decode.items()}),
            "commit": (1, one_call)}
    assert lead["i"]["swapped_to"] == 2
    for got in ranks:
        assert got["i"]["op_stats"] == want, got["i"]["op_stats"]
        assert got["i"]["versions"] == [2, 2]
    # (k)
    assert lead["k"] == {"raised": "planted leader failure"}
    assert all(got["k"] == {"stopped_ok": False} for got in rest)
    # (j) rank 0 prints; the others follow
    assert lead["j"]["line"] == {"served_version": 1, "final_version": 2,
                                 "replicas": 2, "prefill_replicas": 0,
                                 "request_statuses": {"done": 3},
                                 "router_swaps": 1.0}
    assert all(got["j"] == {"rows": [], "line": None} for got in rest)


def _unsharded_rows(pub):
    from dtf_tpu_torch import serve_gpt

    out, rows, _ = serve_gpt.run(serve_argv(pub))
    assert out["final_version"] == 2 and len(rows) == 3
    return rows


def _run(world, tmp_path):
    procs = _spawn(world, tmp_path)
    try:
        pub = str(tmp_path / "pub")
        greedy = [q for q in FLEET_REQS if not q.get("temperature")]
        jax_v1 = jax_fleet_tokens(world, 1, FLEET_REQS)
        jax_v2 = jax_fleet_tokens(world, 2, greedy)
        logits_v2 = jax_logits(2)
        one = port_one(pub)
        rows = None if world == 2 else _unsharded_rows(pub)
    finally:
        ranks = _join(procs, world, tmp_path)
    _check(ranks, one, jax_v1, jax_v2, logits_v2, world)
    return ranks, rows


def test_sharded_fleet_and_rolling_swap_at_model_2(tmp_path):
    ranks, _ = _run(2, tmp_path)
    # (j): the TP trainer published versions 1 and 2 whole, and the
    # unsharded launcher on them serves rank 0's rows
    from dtf_tpu_torch.publish import load_published, read_manifest

    pub = tmp_path / "train" / "pub"
    m = read_manifest(pub)
    assert m["version"] == 2 and {v: h["step"] for v, h in
                                  m["history"].items()} == {"1": 2, "2": 4}
    whole = {n: tuple(x.shape) for n, x in convert.params_from_flax(
        convert.init_params(tgpt.GPTConfig.tiny(), 0)).items()}
    for v in (1, 2):
        got = load_published(pub, v)[2]
        assert {n: tuple(x.shape) for n, x in got.items()} == whole
    assert ranks[0]["j"]["rows"] == _unsharded_rows(pub)


def test_sharded_fleet_and_rolling_swap_at_data_2_by_model_2(tmp_path):
    ranks, rows = _run(4, tmp_path)
    assert ranks[0]["j"]["rows"] == rows


# --- single process ----------------------------------------------------------

def test_version_source_and_shard_sets(tmp_path):
    """A follower's load of a version whose recorded digest is not the
    leader's raises (a fault, never a skip); the shard-set registry finds
    a set by the identity of its tensors only and drops all but the kept
    ones; a sharded fleet's swap without a source, or over engines on two
    planes, raises."""
    from dtf_tpu_torch.publish import published_digest
    from dtf_tpu_torch.serve import Router
    from dtf_tpu_torch.serve.plane import CallPlane, ShardSets
    from dtf_tpu_torch.serve.router import VersionSource

    pub = tmp_path / "pub"
    publish_versions(pub)
    digest = published_digest(pub, 1)
    draft = functools.partial(tgpt.early_exit_draft, port_cfg(), 1)
    params, dparams = VersionSource(str(pub), digest, draft).load(1)
    assert sorted(dparams) == sorted(
        tgpt.draft_truncate(port_cfg(), params, 1)[1])
    assert all(dparams[n] is params[n] for n in dparams)
    with pytest.raises(RuntimeError, match="the leader verified"):
        VersionSource(str(pub), published_digest(pub, 2)).load(1)

    sets = ShardSets()
    x, y = {"w": torch.zeros(2)}, {"w": torch.zeros(2)}
    sets.put(("prev", 0), x)
    sets.put(("new", 1), y)
    assert sets.key_of(dict(y)) == ("new", 1)
    with pytest.raises(KeyError, match="no staged shard set"):
        sets.key_of({"w": torch.zeros(2)})
    sets.keep_only([("prev", 0)])
    assert len(sets) == 1 and sets.get(("prev", 0)) is x

    class Sharded:
        n_slots = 2

        def __init__(self, plane):
            self._plane = plane

    plane = CallPlane(rank=0)
    r = Router([Sharded(plane), Sharded(plane)], health=False)
    assert r.is_leader and plane.fleet is r
    with pytest.raises(ValueError, match="needs source="):
        r.start_swap(params, version=1)
    with pytest.raises(ValueError, match="ONE call plane"):
        Router([Sharded(plane), Sharded(CallPlane(rank=0))])
    follower = Router([Sharded(CallPlane(rank=1))] * 2)
    assert not follower.is_leader and follower.schedulers == []


if __name__ == "__main__":
    rank_main(sys.argv[1:])
