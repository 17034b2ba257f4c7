"""Megatron tensor parallelism of the port's GPT against the JAX package.

One gloo spawn a world size: 2 ranks on a model axis of 2, then 4 ranks
on data 2 × model 2. The ranks run this file as a script (torch, numpy
and the port only) and write their results; this process holds the JAX
side, on the conftest's CPU mesh, and the port's one-rank runs, built
while the ranks run. Every wait on the ranks is bounded.

(a) The TP operators on a model axis of 2 against their whole-weight
    versions, forward and gradients, within ``F32_TOL``: the
    column-parallel ``tp_dense`` (its input through ``copy_to_model``)
    and the row-parallel one (the sum over the group, the bias once), the
    collective-matmul rings (``tp_dense(overlap=True)``: the rank's token
    block in, every token out, and back), the vocab-parallel embedding
    (``masked_lookup_sharded``, as GPT calls it) and the vocab-parallel
    cross-entropy (ignored labels on both ranks' halves of the vocab).
(b) 3 AdamW steps of a tiny f32 GPT (2 layers, 4 heads, d 64, vocab 128;
    the launcher's cosine schedule, clipping at 1.0, unequal ignored
    labels) at model 2, and at data 2 × model 2 with ZeRO-1 and
    ``grad_accum`` 2, against JAX's ``make_train_step`` under
    ``gpt.tp_rules`` on the same mesh: losses, ``grad_norm`` (within
    ``GRAD_NORM_TOL``) and every parameter, gathered whole, within
    ``F32_TOL``; every rank's gathered parameters bitwise equal.
(c) The same with ``tp_overlap`` (the rings, the token-sharded residual
    stream) against JAX's ``tp_overlap=True`` on the same mesh and
    against the port's plain TP run; with dropout 0.1 (and remat) both
    layouts against one rank (the masks are torch's bits, not JAX's):
    each rank's token block of the global masks.
(d) A checkpoint saved at model 2 resumes at model 1 (one process, no
    mesh): the parameters equal, and the 4th step's loss and parameters
    equal those of the model-2 run's 4th step within ``F32_TOL`` (the
    optimizer state resharded too).
(e) ``train_gpt --mesh_model 2`` with ``--loss_pallas`` or a chunked loss
    is a usage error; ``--tp_overlap`` without a model axis warns and
    trains; ``--matmul_precision int8``, ``--mesh_seq/pipe/expert 2`` and
    GQA heads the axis does not divide raise; a decode model over a model
    axis caches the rank's heads.

    python tests/test_torch_tp.py RANK WORLD STORE_FILE OUT_DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
for _p in (ROOT, TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import _torch_multirank_worker as worker  # noqa: E402
from dtf_tpu_torch import convert, optim  # noqa: E402
from dtf_tpu_torch.core import comms  # noqa: E402
from dtf_tpu_torch.core import train as ttr  # noqa: E402
from dtf_tpu_torch.models import gpt as tgpt  # noqa: E402

F32_TOL = 1e-5
#: ``grad_norm`` against JAX's, relative: the two sum the squares of the
#: same f32 gradients in other orders (the port per leaf with one
#: all-reduce of the split leaves' parts)
GRAD_NORM_TOL = F32_TOL
#: the bound on every wait for the ranks
WAIT_S = 60
STEPS = 3
#: the tiny GPT of (b)-(d)
GPT_KW = dict(vocab_size=128, d_model=64, layers=2, heads=4, d_ff=128)

#: world size → {case: (tp_overlap, grad_accum, dropout, remat)}
CASES = {
    2: {"plain": (False, 1, 0.0, False),
        "overlap": (True, 1, 0.0, False),
        "dropout_plain": (False, 1, 0.1, False),
        "dropout_overlap": (True, 1, 0.1, True)},
    4: {"plain_accum2": (False, 2, 0.0, False),
        "overlap_accum2": (True, 2, 0.0, False)},
}


def mesh_config(world):
    from dtf_tpu_torch.core.mesh import MeshConfig

    return MeshConfig(model=2) if world == 2 else MeshConfig(data=2, model=2)


def gpt_cfg(overlap=False, dropout=0.0, remat=False):
    return tgpt.GPTConfig(dtype=torch.float32, tp_overlap=overlap,
                          dropout=dropout, remat=remat, **GPT_KW)


def batches(n=STEPS):
    """The multirank check's GPT batches (unequal ignored labels on the
    data ranks' rows), ``n`` of them."""
    from dtf_tpu_torch.data.synthetic import SyntheticData

    data = SyntheticData("gpt", worker.GPT_BATCH, seed=3,
                         seq_len=worker.GPT_SEQ, vocab_size=128)
    out = []
    for i in range(n):
        b = data.batch(i)
        for row, k in worker.IGNORED:
            b["labels"][row, :k] = -100
        out.append(b)
    return out


def init_tree():
    return convert.init_params_flax(gpt_cfg(), seed=1)


def train_run(case, world=None, mesh=None, ckpt_dir=None):
    """STEPS steps of ``case`` (one rank on the whole batch without a
    mesh): losses, grad_norms and the whole parameters (gathered over
    the model group). With ``ckpt_dir`` the state is saved after them
    and one more step taken: its loss and parameters."""
    from dtf_tpu_torch.core.sharding import make_layout

    overlap, accum, dropout, remat = (CASES[world][case] if world
                                      else case)
    cfg = gpt_cfg(overlap, dropout, remat)
    model = tgpt.GPT(cfg, device="cpu", mesh=mesh)
    whole = convert.params_from_flax(init_tree())
    layout = None
    if mesh is not None:
        layout = make_layout(dict(model.named_parameters()), mesh,
                             tgpt.tp_rules, zero1=True)
        whole = convert.shard_params(whole, layout, mesh)
    model.load_state_dict(whole)
    tx = optim.wrap_optimizer(optim.adamw(
        optim.make_lr_schedule(worker.Args), weight_decay=0.1), worker.Args)
    state = ttr.create_train_state(model, tx, 7, mesh=mesh, layout=layout)
    step = ttr.make_train_step(tgpt.make_loss(model, mesh=mesh), tx,
                               grad_accum=accum, mesh=mesh)

    def rows(b):
        if mesh is not None:
            lo, hi = mesh.host_view.batch_rows(len(b["input_ids"]))
            b = {k: v[lo:hi] for k, v in b.items()}
        return {k: torch.from_numpy(v) for k, v in b.items()}

    def gathered():
        return {n: (layout.gather_param(n, p.detach(), mesh) if layout
                    else p.detach()).clone()
                for n, p in model.named_parameters()}

    run = {"losses": [], "norms": []}
    all_batches = batches(STEPS + 1)
    for b in all_batches[:STEPS]:
        state, m = step(state, rows(b))
        run["losses"].append(float(m["loss"]))
        run["norms"].append(float(m["grad_norm"]))
    run["params"] = gathered()
    if ckpt_dir is not None:
        from dtf_tpu_torch.checkpoint import Checkpointer

        Checkpointer(ckpt_dir, mesh=mesh).save(STEPS, state, force=True)
        state, m = step(state, rows(all_batches[STEPS]))
        run["next"] = {"loss": float(m["loss"]), "params": gathered()}
    return run


def resume_run(ckpt_dir):
    """One process, no mesh: restore the model-2 checkpoint and take the
    4th step of the plain case."""
    from dtf_tpu_torch.checkpoint import Checkpointer

    model = tgpt.GPT(gpt_cfg(), device="cpu")
    tx = optim.wrap_optimizer(optim.adamw(
        optim.make_lr_schedule(worker.Args), weight_decay=0.1), worker.Args)
    state = ttr.create_train_state(model, tx, 0)
    state = Checkpointer(ckpt_dir).restore(state)
    restored = {n: p.detach().clone() for n, p in state.params.items()}
    step = ttr.make_train_step(tgpt.make_loss(model), tx)
    state, m = step(state, {k: torch.from_numpy(v)
                            for k, v in batches(STEPS + 1)[STEPS].items()})
    return {"step": state.step, "restored": restored,
            "loss": float(m["loss"]),
            "params": {n: p.detach().clone() for n, p in
                       state.params.items()}}


# --- (a): the operators -----------------------------------------------------

def op_inputs():
    """Whole operands of check (a), from a seed."""
    rng = np.random.default_rng(31)

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    b, t, d, fe, v = 2, 6, 8, 10, 12
    labels = rng.integers(0, v, (b, t)).astype(np.int64)
    labels[0, :2] = -100
    labels[1, 4] = -100
    return {"x": f(b, t, d), "w_col": f(fe, d, scale=0.3), "b_col": f(fe),
            "cot_col": f(b, t, fe), "y": f(b, t, fe),
            "w_row": f(d, fe, scale=0.3), "b_row": f(d), "cot_row": f(b, t, d),
            "table": f(v, d), "ids": rng.integers(0, v, (b, t)),
            "logits": f(b, t, v, scale=2.0), "labels": labels}


def op_whole():
    """The whole-weight versions: {name: (output, {operand: grad})}."""
    a = {k: torch.from_numpy(np.asarray(v)) for k, v in op_inputs().items()}
    out = {}
    x, wc, bc = (a[k].clone().requires_grad_() for k in ("x", "w_col",
                                                          "b_col"))
    y = x @ wc.t() + bc
    out["column"] = (y.detach(), dict(zip(("x", "w", "b"), torch.autograd.grad(
        (y * a["cot_col"]).sum(), (x, wc, bc)))))
    yi, wr, br = (a[k].clone().requires_grad_() for k in ("y", "w_row",
                                                          "b_row"))
    z = yi @ wr.t() + br
    out["row"] = (z.detach(), dict(zip(("y", "w", "b"), torch.autograd.grad(
        (z * a["cot_row"]).sum(), (yi, wr, br)))))
    table = a["table"].clone().requires_grad_()
    e = table[a["ids"]]
    out["embed"] = (e.detach(), {"table": torch.autograd.grad(
        (e * a["x"]).sum(), table)[0]})
    logits = a["logits"].clone().requires_grad_()
    from dtf_tpu_torch.ops.losses import softmax_cross_entropy

    mean, n = softmax_cross_entropy(logits, a["labels"], ignore_index=-100)
    out["ce"] = (torch.stack([mean.detach(), n]), {
        "logits": torch.autograd.grad(mean, logits)[0]})
    return out


def op_run(mesh):
    """Check (a) on this rank: each operator's output and gradients, this
    rank's blocks."""
    from dtf_tpu_torch.ops.losses import vocab_parallel_cross_entropy
    from dtf_tpu_torch.parallel.embedding import masked_lookup_sharded

    a = {k: torch.from_numpy(np.asarray(v)) for k, v in op_inputs().items()}
    n, r = mesh.model_size, mesh.model_index

    def block(t, dim):
        size = t.shape[dim] // n
        return t.narrow(dim, r * size, size).contiguous()

    def leaf(t):
        return t.clone().requires_grad_()

    got = {}
    # column: the rank's output features
    x, wc, bc = leaf(a["x"]), leaf(block(a["w_col"], 0)), leaf(
        block(a["b_col"], 0))
    y = comms.tp_dense(comms.copy_to_model(x, mesh), wc, bc, mesh,
                       parallel="column")
    got["column"] = (y.detach(), dict(zip(("x", "w", "b"), torch.autograd.grad(
        (y * block(a["cot_col"], 2)).sum(), (x, wc, bc)))))
    # row: the rank's input features, the sum, the bias once
    yi, wr, br = leaf(block(a["y"], 2)), leaf(block(a["w_row"], 1)), leaf(
        a["b_row"])
    z = comms.tp_dense(yi, wr, br, mesh, parallel="row")
    got["row"] = (z.detach(), dict(zip(("y", "w", "b"), torch.autograd.grad(
        (z * a["cot_row"]).sum(), (yi, wr, br)))))
    # the rings: the rank's token block in, every token out (column) and
    # back to the block (row)
    xt, wc2, bc2 = leaf(block(a["x"], 1)), leaf(block(a["w_col"], 0)), leaf(
        block(a["b_col"], 0))
    y = comms.tp_dense(xt, wc2, bc2, mesh, parallel="column", overlap=True)
    got["ring_column"] = (y.detach(), dict(zip(
        ("x", "w", "b"), torch.autograd.grad(
            (y * block(a["cot_col"], 2)).sum(), (xt, wc2, bc2)))))
    yi, wr, br = leaf(block(a["y"], 2)), leaf(block(a["w_row"], 1)), leaf(
        a["b_row"])
    z = comms.tp_dense(yi, wr, br, mesh, parallel="row", overlap=True)
    got["ring_row"] = (z.detach(), dict(zip(
        ("y", "w", "b"), torch.autograd.grad(
            (z * block(a["cot_row"], 1)).sum(), (yi, wr, br)))))
    # the vocab-parallel embedding and cross-entropy
    table = leaf(block(a["table"], 0))
    e = masked_lookup_sharded(table, a["ids"], mesh.model_group,
                              dtype=torch.float32)
    got["embed"] = (e.detach(), {"table": torch.autograd.grad(
        (e * a["x"]).sum(), table)[0]})
    logits = leaf(block(a["logits"], 2))
    mean, cnt = vocab_parallel_cross_entropy(logits, a["labels"],
                                             mesh.model_group,
                                             ignore_index=-100)
    got["ce"] = (torch.stack([mean.detach(), cnt]), {
        "logits": torch.autograd.grad(mean, logits)[0]})
    return got


# --- the ranks ---------------------------------------------------------------

class _FailingOnce:
    """A publisher whose first publish fails; it records each attempt."""

    def __init__(self):
        self.attempts = []

    def publish(self, step, params):
        self.attempts.append(step)
        if len(self.attempts) == 1:
            raise OSError("disk full")


def publish_run(rank):
    """PublishHook under TP: only rank 0 publishes, and its first publish
    (step 1) fails. Every rank's ``_last_published_step`` after that
    step and after ``end()``, and rank 0's attempts."""
    import types

    from dtf_tpu_torch.hooks import PublishHook

    publisher = _FailingOnce() if rank == 0 else None
    hook = PublishHook(publisher, 1, params_of=lambda st: st.params)
    state = types.SimpleNamespace(params={"w": torch.ones(2)}, step=1)
    hook.after_step(1, state, {})
    after_step = hook._last_published_step
    hook.end(state)
    return {"after_step": after_step, "after_end": hook._last_published_step,
            "attempts": publisher.attempts if publisher else None}


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
                            world_size=a.world, rank=a.rank)
    mesh = make_mesh(mesh_config(a.world), torch.device("cpu"))
    out = {"runs": {}}
    if a.world == 2:
        out["ops"] = op_run(mesh)
        out["publish"] = publish_run(a.rank)
    for case in CASES[a.world]:
        comms.reset_collective_counts()
        out["runs"][case] = train_run(
            case, a.world, mesh, ckpt_dir=os.path.join(a.out, "ckpt")
            if (a.world, case) == (2, "plain") else None)
        out["runs"][case]["collectives"] = dict(comms.collective_counts)
    torch.save(out, os.path.join(a.out, f"rank{a.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# --- the JAX side ------------------------------------------------------------

def jax_run(world, overlap, accum):
    """JAX's make_train_step under gpt.tp_rules on the CPU mesh of the
    ranks' shape, from the port's init tree."""
    import jax
    import jax.numpy as jnp
    import optax

    from dtf_tpu.cli import flags as jflags
    from dtf_tpu.core import train as jtr
    from dtf_tpu.core.mesh import MeshConfig, make_mesh
    from dtf_tpu.models import gpt as jgpt

    mc = (MeshConfig(model=2) if world == 2
          else MeshConfig(data=2, model=2))
    mesh = make_mesh(mc, devices=jax.devices()[:world])
    cfg = jgpt.GPTConfig(dtype=jnp.float32, tp_overlap=overlap, **GPT_KW)
    model, init_fn = jgpt.make_init(cfg, mesh, seq_len=worker.GPT_SEQ)
    args = argparse.Namespace(
        learning_rate=worker.Args.learning_rate, lr_schedule="cosine",
        warmup_steps=-1, lr_min_ratio=worker.Args.lr_min_ratio,
        train_steps=worker.Args.train_steps,
        clip_grad_norm=worker.Args.clip_grad_norm, optimizer="",
        weight_decay=-1.0)
    tx = jflags.wrap_optimizer(optax.adamw(
        jflags.make_lr_schedule(args), weight_decay=0.1), args)
    state, shardings = jtr.create_train_state(
        init_fn, tx, jax.random.PRNGKey(0), mesh,
        param_rules=jgpt.tp_rules, zero1=True)
    params = jax.tree.map(jnp.asarray, init_tree())
    state = jax.device_put(
        state.replace(params=params, opt_state=tx.init(params)), shardings)
    step = jtr.make_train_step(jgpt.make_loss(model), tx, mesh, shardings,
                               grad_accum=accum, donate=False)
    losses, norms = [], []
    for b in batches():
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "params": convert.params_from_flax(
                jax.tree.map(np.asarray, state.params))}


def _close(got, want, what, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=what)


def _same_run(got, want, what, norms=True):
    _close(got["losses"], want["losses"], f"{what} losses")
    if norms:
        _close(got["norms"], want["norms"], f"{what} grad_norm",
               GRAD_NORM_TOL)
    assert set(got["params"]) == set(want["params"])
    for k in want["params"]:
        _close(got["params"][k], want["params"][k], f"{what} {k}")


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


def _ranks_agree(ranks, case):
    for got in ranks[1:]:
        for k, v in ranks[0]["runs"][case]["params"].items():
            assert torch.equal(got["runs"][case]["params"][k], v), (case, k)
        assert got["runs"][case]["losses"] == ranks[0]["runs"][case][
            "losses"], case


def test_tp_at_model_2_equals_jax_and_resumes_at_model_1(tmp_path):
    procs = _spawn(2, tmp_path)
    try:
        want = {overlap: jax_run(2, overlap, 1) for overlap in (False, True)}
        whole = op_whole()
        one = {dropout: train_run((False, 1, dropout, False))
               for dropout in (0.0, 0.1)}
    finally:
        ranks = _join(procs, 2, tmp_path)
    # (a) the operators, each rank's blocks against the whole versions
    for r, got in enumerate(ranks):
        ops = got["ops"]

        def blk(t, dim):
            size = t.shape[dim] // 2
            return t.narrow(dim, r * size, size)

        col_y, col_g = whole["column"]
        for name in ("column", "ring_column"):
            y, g = ops[name]
            x_want = (col_g["x"] if name == "column"
                      else blk(col_g["x"], 1))
            _close(y, blk(col_y, 2), f"{name} forward, rank {r}")
            _close(g["x"], x_want, f"{name} dx, rank {r}")
            _close(g["w"], blk(col_g["w"], 0), f"{name} dW, rank {r}")
            _close(g["b"], blk(col_g["b"], 0), f"{name} db, rank {r}")
        row_z, row_g = whole["row"]
        for name in ("row", "ring_row"):
            z, g = ops[name]
            _close(z, row_z if name == "row" else blk(row_z, 1),
                   f"{name} forward, rank {r}")
            _close(g["y"], blk(row_g["y"], 2), f"{name} dy, rank {r}")
            _close(g["w"], blk(row_g["w"], 1), f"{name} dW, rank {r}")
            if name == "row":       # the bias once, after the sum
                _close(g["b"], row_g["b"], f"row db, rank {r}")
            else:                   # this rank's tokens' part of it
                assert g["b"].shape == row_g["b"].shape
        _close(ranks[0]["ops"]["ring_row"][1]["b"]
               + ranks[1]["ops"]["ring_row"][1]["b"], row_g["b"],
               "ring row db summed over the ranks")
        e, g = ops["embed"]
        _close(e, whole["embed"][0], f"embedding forward, rank {r}")
        _close(g["table"], blk(whole["embed"][1]["table"], 0),
               f"embedding dtable, rank {r}")
        ce, g = ops["ce"]
        _close(ce, whole["ce"][0], f"vocab-parallel CE (mean, n), rank {r}")
        _close(g["logits"], blk(whole["ce"][1]["logits"], 2),
               f"vocab-parallel CE dlogits, rank {r}")
    # a failed publish of the chief is retried at end() on every rank
    assert [g["publish"] for g in ranks] == [
        {"after_step": None, "after_end": 1, "attempts": [1, 1]},
        {"after_step": None, "after_end": 1, "attempts": None}]
    # (b), (c) against JAX, the two layouts against each other
    runs = ranks[0]["runs"]
    for case in CASES[2]:
        _ranks_agree(ranks, case)
    _same_run(runs["plain"], want[False], "model 2")
    _same_run(runs["overlap"], want[True], "model 2, tp_overlap")
    _same_run(runs["overlap"], runs["plain"], "tp_overlap vs plain TP")
    for case in ("dropout_plain", "dropout_overlap"):
        _same_run(runs[case], one[0.1], f"{case} vs one rank")
    # the model-group collectives of a step, from the code
    layers = GPT_KW["layers"]
    # (and the step's one psum of its loss statistics over the data group)
    assert runs["plain"]["collectives"] == {
        "all_reduce": (STEPS + 1) * (4 * layers + 5),
        "all_gather": 0, "reduce_scatter": 0, "ring_exchange": 0,
        "broadcast": 0}
    assert runs["overlap"]["collectives"] == {
        "all_reduce": 5 * STEPS, "all_gather": 2 * STEPS,
        "reduce_scatter": STEPS, "ring_exchange": 18 * layers * STEPS,
        "broadcast": 0}
    # (d) the model-2 checkpoint resumes at model 1
    res = resume_run(str(tmp_path / "ckpt"))
    assert res["step"] == STEPS + 1
    for k, v in runs["plain"]["params"].items():
        assert torch.equal(res["restored"][k], v), k
    nxt = runs["plain"]["next"]
    _close(res["loss"], nxt["loss"], "the resumed 4th step's loss")
    for k, v in nxt["params"].items():
        _close(res["params"][k], v, f"the resumed 4th step's {k}")
    _same_run({"losses": one[0.0]["losses"], "norms": one[0.0]["norms"],
               "params": one[0.0]["params"]}, runs["plain"],
              "one rank vs model 2")


def test_tp_at_data_2_by_model_2_equals_jax(tmp_path):
    procs = _spawn(4, tmp_path)
    try:
        want = {overlap: jax_run(4, overlap, 2) for overlap in (False, True)}
    finally:
        ranks = _join(procs, 4, tmp_path)
    runs = ranks[0]["runs"]
    for case in CASES[4]:
        _ranks_agree(ranks, case)
    _same_run(runs["plain_accum2"], want[False],
              "data 2 x model 2, ZeRO-1, grad_accum 2")
    _same_run(runs["overlap_accum2"], want[True],
              "data 2 x model 2, ZeRO-1, grad_accum 2, tp_overlap")
    _same_run(runs["overlap_accum2"], runs["plain_accum2"],
              "tp_overlap vs plain TP at data 2 x model 2")


class _Mesh:
    """A model axis of 2 without a process group: enough to build a
    model, which raises before it needs one."""
    data_size, model_size, data_index, model_index = 1, 2, 0, 0
    data_group = model_group = None


def test_train_gpt_refuses_what_tp_does_not_take(tmp_path, caplog):
    from dtf_tpu_torch import train_gpt

    base = ["--device=cpu", "--size=tiny", "--batch_size=2", "--seq_len=16",
            "--train_steps=1", f"--logdir={tmp_path / 'run'}"]
    for flag in ("--loss_pallas", "--loss_chunk_tokens=8",
                 "--loss_chunk_vocab=64"):
        with pytest.raises(SystemExit) as e:
            train_gpt.run([*base, "--mesh_model=2", flag])
        assert e.value.code == 2, flag
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train_gpt.run([*base, "--matmul_precision=int8"])
    for axis in ("seq", "pipe", "expert"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            train_gpt.run([*base, f"--mesh_{axis}=2"])
    with caplog.at_level("WARNING", logger="dtf_tpu_torch"):
        state, _ = train_gpt.run([*base, "--tp_overlap"])
    assert state.step == 1
    assert any("--tp_overlap has no effect" in r.getMessage()
               for r in caplog.records)
    # the model over a model axis: heads the axis divides, and no fused
    # or chunked loss; a decode model is ported since
    # (tests/test_torch_tp_serve.py): its cache holds the rank's heads
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    dec = tgpt.GPT(dataclasses.replace(cfg, decode_len=8, kv_heads=2),
                   device="cpu", mesh=_Mesh())
    assert dec.init_cache(3)[0]["cached_key"].shape == (3, 1, 8, 8)
    with pytest.raises(ValueError, match="kv_heads"):
        tgpt.GPT(dataclasses.replace(cfg, kv_heads=1), device="cpu",
                 mesh=_Mesh())
    model = tgpt.GPT(cfg, device="cpu", mesh=_Mesh())
    for opts in ({"loss_pallas": True}, {"loss_chunk": 64},
                 {"loss_chunk_tokens": 8}):
        with pytest.raises(ValueError, match="cannot combine with "
                                             "--mesh_model"):
            tgpt.make_loss(model, **opts)


if __name__ == "__main__":
    rank_main(sys.argv[1:])
