"""The port over two processes: one gloo spawn of 2 ranks, several checks.

The ranks (``tests/_torch_multirank_worker.py``, torch only) join a gloo
group through a ``file://`` store under ``tmp_path`` and write their
results; this process holds the JAX side and the port's one-rank runs,
built while the ranks run, and compares. Every wait on the ranks is
bounded (``WAIT_S``): on expiry both are killed and the test fails with
their stderr.

(a) 3 train steps on the data axis equal one rank on the whole batch and
    JAX's ``make_train_step`` on a ``MeshConfig(data=2)`` CPU-sim mesh:
    tiny GPT (AdamW under the launcher's cosine schedule, clipping at
    1.0; rank 0's rows hold 11 ignored labels, rank 1's 3, so a mean of
    the ranks' means would miss) and the MNIST MLP
    (SGD), each with ZeRO-1 on and off and under ``grad_accum 2
    --grad_shard``; the losses, ``grad_norm`` and every parameter within
    ``F32_TOL`` (the sums run in other orders: one rank against two,
    torch against XLA). With dropout on, against one rank only (the
    masks are torch's bits, not JAX's).
(b) ``masked_lookup_sharded`` with the table's rows split over the model
    axis equals ``jnp.take`` exactly (a gather copies), and the shards'
    gradients put together equal ``take``'s within ``F32_TOL`` (an
    all-reduce in the backward would double them). A tiny Wide&Deep's two
    row-sharded tables (f32, and the deep one at bf16) through the
    grouped lookup its forward takes (one B8 launch on the card) equal
    the per-table composite it replaces (each shard cast,
    ``masked_lookup`` with ``gather_rows``, the shards summed) bit for
    bit, outputs and gradients; the outputs equal ``jnp.take`` of the
    cast tables exactly, and the gradients ``take``'s within ``F32_TOL``,
    the bf16 table's within ``BF16_GRAD_TOL`` of its largest element
    (JAX sums a repeated id's cotangents in bf16, the port in f32).
(c) The token-sharded fused CE (its plain version on the CPU) gives the
    unsharded ``(mean, n)``, dX row for row, and dW summed over the ranks,
    within ``F32_TOL``.
(d) GPT's dropout: each rank's rows of the global masks, so the 2-rank
    forward with dropout equals the 1-rank forward row for row (within
    ``F32_TOL``: two rows against four in each product), and the masks
    themselves exactly.
(e) A tiny f32 Wide&Deep, its tables row-sharded over the model axis,
    3 Adam steps with ``--clip_grad_norm`` far below the norm: the losses,
    ``grad_norm`` (every table row counted once, summed over the model
    group) and every parameter against one rank and JAX's
    ``make_train_step`` on a ``MeshConfig(model=2)`` mesh within
    ``F32_TOL``; the replicated dense leaves bitwise equal on both model
    ranks (clipped by one norm).
(f) Tiny ResNets (both stems and blocks, 16×16 images, 2 rows a rank)
    with BatchNorm synchronised over the data axis: the loss, every
    gradient (the ranks' mean) and the running statistics of one forward,
    then 3 train steps' losses, ``grad_norm``, parameters and statistics,
    against one rank on the global batch within ``F32_TOL``.
(g) GPT with dropout 0.1, ZeRO-1 and ``grad_accum`` 2: each microbatch
    is the global batch's rows (the ranks exchange rows first), so each
    rank's rows of the global masks meet the rows they meet in one
    process: against one rank on the global batch within ``F32_TOL``
    (a case of (a)).
(h) The tiny ResNets of (f) at ``grad_accum`` 2 (1 row a rank a
    microbatch): BatchNorm's statistics are each global microbatch's.
    Losses, ``grad_norm``, every parameter and running statistic against
    JAX's ``make_train_step`` on a ``MeshConfig(data=2)`` mesh at
    ``grad_accum`` 2 within ``F32_TOL``.
(i) A tiny BERT (hidden 128, vocab 256: adafactor factors its tables and
    kernels), ZeRO-1, ``grad_accum`` 2, one row padded, under ``adamw``,
    ``lamb`` and ``adafactor`` from the launcher's flags: losses,
    ``grad_norm`` and every parameter against JAX's ``MeshConfig(data=2)``
    step within ``F32_TOL`` (the per-leaf norms and row / column means
    summed over the ranks' blocks), the ranks' parameters bitwise equal,
    adafactor's statistics of a factored leaf this rank's block, or
    whole where they reduce the split dim, and each optimizer's state
    saved by the collective checkpoint and restored bit for bit.
And ``core/comms``' psum, pmean, psum_scatter and all_gather over the
group, exactly (small integers in f32).
"""

import argparse
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_multirank_worker as worker
from dtf_tpu.cli import flags as jflags
from dtf_tpu.core import train as jtr
from dtf_tpu.core.mesh import MeshConfig, make_mesh
from dtf_tpu.models import bert as jbert
from dtf_tpu.models import gpt as jgpt
from dtf_tpu.models import mnist as jmnist
from dtf_tpu.models import resnet as jresnet
from dtf_tpu.models import widedeep as jwd
from dtf_tpu_torch import convert
from dtf_tpu_torch.core.dist import free_port
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.ops.fused_ce import fused_lm_cross_entropy
from test_torch_resnet import jax_model as jax_resnet

F32_TOL = 1e-5
#: a bf16 table's gradient against JAX's, relative to its largest element
BF16_GRAD_TOL = 2.0 ** -6
#: check (i): the reference step's ``grad_norm`` metric (a ``jnp.vdot`` a
#: leaf under XLA:CPU) is itself 1.2e-4 off the norm of its own
#: ``jax.value_and_grad`` gradient on the tiny BERT's first batch, and
#: moves by 4e-5 between its one- and two-device meshes; the port's is
#: within 1e-7 of that exact norm. BERT's grad_norm is held at this,
#: relative
BERT_NORM_TOL = 2e-4
#: the key projection's bias: its analytic gradient is 0 (the softmax
#: ignores a per-query shift), so its gradient is rounding noise, which
#: adamw, lamb and adafactor scale into steps of about the learning rate
#: in the noise's direction; it moves nothing else. Not compared
NOISE_LEAF = "attention.key.bias"
#: the bound on every wait for the ranks
WAIT_S = 60
WORLD = 2


def spawn_ranks(args_of_rank, logs, world=WORLD):
    """Start ``world`` Python processes, rank r with the arguments
    ``args_of_rank(r)``, one thread each, its output in the file
    ``logs/<r>.log`` (a full pipe would stall a rank inside a
    collective); the caller joins them with :func:`join_ranks`."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    os.makedirs(logs, exist_ok=True)
    procs = []
    for r in range(world):
        with open(os.path.join(logs, f"{r}.log"), "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, *args_of_rank(r)], env=env, stdout=out,
                stderr=subprocess.STDOUT, text=True))
        procs[-1].log = os.path.join(logs, f"{r}.log")
    return procs


def join_ranks(procs, wait_s=WAIT_S):
    """Wait for every rank within ``wait_s`` in all; on expiry, or when
    a rank fails, kill them all and fail with their output. Returns
    their outputs."""
    deadline = time.monotonic() + wait_s
    failed = None
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            failed = f"a rank did not finish within {wait_s} s"
            break
        if p.returncode:
            failed = f"a rank exited {p.returncode}"
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    outs = []
    for p in procs:
        with open(p.log) as f:
            outs.append(f.read())
    if failed:
        pytest.fail(f"{failed}; output:\n" + "\n----\n".join(
            o[-3000:] for o in outs))
    return outs


def _jax_args():
    return argparse.Namespace(
        learning_rate=worker.Args.learning_rate, lr_schedule="cosine",
        warmup_steps=-1, lr_min_ratio=worker.Args.lr_min_ratio,
        train_steps=worker.Args.train_steps,
        clip_grad_norm=worker.Args.clip_grad_norm, optimizer="",
        weight_decay=-1.0)


def _jax_run(name):
    """JAX's make_train_step on MeshConfig(data=2) for case ``name``."""
    kind, accum, grad_shard, zero1, _ = worker.CASES[name]
    mesh = make_mesh(MeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    if kind == "gpt":
        model, init_fn = jgpt.make_init(jgpt.GPTConfig.tiny(
            dtype=jnp.float32), None, seq_len=worker.GPT_SEQ)
        args = _jax_args()
        tx = jflags.wrap_optimizer(optax.adamw(
            jflags.make_lr_schedule(args), weight_decay=0.1), args)
        tree, loss_fn = worker.gpt_tree()[1], jgpt.make_loss(model)
        batches = worker.gpt_batches()
    else:
        model = jmnist.make_model("mlp")
        init_fn = jmnist.make_init(model)
        tx, tree = optax.sgd(0.1), worker.mlp_tree()
        loss_fn, batches = jmnist.make_loss(model), worker.mnist_batches()
    state, shardings = jtr.create_train_state(
        init_fn, tx, jax.random.PRNGKey(0), mesh, zero1=zero1)
    params = jax.tree.map(jnp.asarray, tree)
    state = jax.device_put(
        state.replace(params=params, opt_state=tx.init(params)), shardings)
    step = jtr.make_train_step(loss_fn, tx, mesh, shardings,
                               grad_accum=accum, grad_shard=grad_shard,
                               donate=False)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "params": convert.params_from_flax(
                jax.tree.map(np.asarray, state.params))}


def _jax_widedeep_run():
    """JAX's make_train_step on MeshConfig(model=2) for check (e)."""
    mesh = make_mesh(MeshConfig(model=WORLD), devices=jax.devices()[:WORLD])
    jmodel = jwd.WideDeep(num_sparse=worker.WD_SPARSE,
                          hash_buckets=worker.WD_BUCKETS,
                          embed_dim=worker.WD_EMBED, mlp=(8,),
                          dtype=jnp.float32)
    args = argparse.Namespace(clip_grad_norm=worker.WD_CLIP)
    tx = jflags.wrap_optimizer(optax.adam(worker.WD_LR), args)
    state, shardings = jtr.create_train_state(
        jwd.make_init(jmodel), tx, jax.random.PRNGKey(0), mesh, jwd.rules)
    params = jax.tree.map(jnp.asarray, worker.widedeep_tree())
    state = jax.device_put(
        state.replace(params=params, opt_state=tx.init(params)), shardings)
    step = jtr.make_train_step(jwd.make_loss(jmodel), tx, mesh, shardings,
                               donate=False)
    losses, norms = [], []
    for b in worker.widedeep_batches():
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "params": convert.params_from_flax(
                jax.tree.map(np.asarray, state.params))}


def _jax_steps(step, state, batches):
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def _jax_resnet_run(stem, block):
    """JAX's make_train_step on MeshConfig(data=2) at grad_accum 2 for
    check (h)."""
    mesh = make_mesh(MeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    jmodel = jax_resnet(stem, block)
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    size = worker.RN_SIZE
    state, shardings = jtr.create_train_state(
        jresnet.make_init(jmodel, (size, size, 3)), tx,
        jax.random.PRNGKey(0), mesh)
    tree = worker.resnet_vars(worker.resnet_tiny(stem, block), 5)
    params = jax.tree.map(jnp.asarray, tree["params"])
    state = jax.device_put(state.replace(
        params=params, opt_state=tx.init(params),
        extra={"batch_stats": jax.tree.map(jnp.asarray,
                                           tree["batch_stats"])}),
        shardings)
    step = jtr.make_train_step(
        jresnet.make_loss(jmodel, weight_decay=worker.RN_L2), tx, mesh,
        shardings, grad_accum=2, donate=False)
    state, losses, norms = _jax_steps(step, state, worker.resnet_batches())
    return {"losses": losses, "norms": norms,
            "params": convert.params_from_flax(
                jax.tree.map(np.asarray, state.params)),
            "extra": convert.stats_from_flax(jax.tree.map(
                np.asarray, state.extra["batch_stats"]))}


def _jax_bert_run(optimizer):
    """JAX's make_train_step on MeshConfig(data=2), ZeRO-1, grad_accum 2
    for check (i)."""
    mesh = make_mesh(MeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    model, init_fn = jbert.make_init(
        jbert.BertConfig(dtype=jnp.float32, **worker.BERT_KW),
        seq_len=worker.BERT_SEQ)
    tx = jflags.make_optimizer(worker.bert_args(optimizer), recipe=None)
    state, shardings = jtr.create_train_state(
        init_fn, tx, jax.random.PRNGKey(0), mesh,
        param_rules=jbert.tp_rules, zero1=True)
    params = jax.tree.map(jnp.asarray, worker.bert_tree())
    state = jax.device_put(
        state.replace(params=params, opt_state=tx.init(params)), shardings)
    step = jtr.make_train_step(jbert.make_loss(model), tx, mesh, shardings,
                               grad_accum=worker.BERT_ACCUM, donate=False)
    state, losses, norms = _jax_steps(step, state, worker.bert_batches())
    return {"losses": losses, "norms": norms,
            "params": convert.params_from_flax(
                jax.tree.map(np.asarray, state.params))}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=F32_TOL, rtol=F32_TOL, err_msg=what)


def _same_run(got, want, what):
    _close(got["losses"], want["losses"], f"{what} losses")
    _close(got["norms"], want["norms"], f"{what} grad_norm")
    assert set(got["params"]) == set(want["params"])
    for k in want["params"]:
        _close(got["params"][k], want["params"][k], f"{what} {k}")


def test_two_ranks_equal_one_rank_and_jax(tmp_path):
    procs = spawn_ranks(lambda r: [
        worker.__file__, str(r), str(WORLD), str(tmp_path / "store"),
        str(tmp_path)], tmp_path / "logs")
    try:
        # the references, while the ranks run
        jax_ref = {}
        for name, (kind, accum, shard, _, dropout) in worker.CASES.items():
            key = (kind, accum, shard)
            if not dropout and key not in jax_ref:
                jax_ref[key] = _jax_run(name)
        one_rank = {name: worker.port_run(name) for name in worker.CASES}
        table, ids, cot = worker.lookup_inputs()
        take_grad = jax.grad(lambda t: (jnp.take(t, ids, axis=0)
                                        * cot).sum())(table)
        x, w, labels = worker.ce_inputs()
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        ce_mean, ce_n = fused_lm_cross_entropy(
            xt, wt, torch.from_numpy(labels), ignore_index=-100)
        ce_dx, ce_dw = torch.autograd.grad(ce_mean, (xt, wt))
        wd_tables, wd_sparse, wd_cots = worker.widedeep_inputs()
        wd_flat = wd_sparse + np.arange(worker.WD_SPARSE, dtype=np.int32) \
            * worker.WD_BUCKETS
        wd_take = {}
        for dtype in worker.WD_DTYPES:
            deep_dt = (jnp.bfloat16 if dtype == torch.bfloat16
                       else jnp.float32)

            def take(t, dt):
                return jnp.take(t.astype(dt), wd_flat, axis=0)

            outs = [take(t, dt) for t, dt in
                    zip(wd_tables, (jnp.float32, deep_dt))]
            grads = [jax.grad(lambda t, dt=dt, c=c: (take(t, dt).astype(
                jnp.float32) * c).sum())(jnp.asarray(t))
                for t, dt, c in zip(wd_tables, (jnp.float32, deep_dt),
                                    wd_cots)]
            wd_take[str(dtype)] = (outs, grads)
        cfg, tree, drop_ids = worker.dropout_inputs()
        dropped = worker.dropout_run(cfg, tree, drop_ids, 5)
        wd_jax, wd_one = _jax_widedeep_run(), worker.widedeep_train_run()
        rn_one = {f"{stem}-{block}": worker.resnet_run(stem, block)
                  for stem, block in worker.RN_CASES}
        rn_jax = {f"{stem}-{block}": _jax_resnet_run(stem, block)
                  for stem, block in worker.RN_CASES}
        bert_jax = {name: _jax_bert_run(name)
                    for name in worker.BERT_OPTIMIZERS}
    finally:
        join_ranks(procs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]

    # (a)
    for name, (kind, accum, shard, zero1, dropout) in worker.CASES.items():
        got = ranks[0]["train"][name]
        for other in ranks[1:]:              # the ranks hold one model
            for k, v in got["params"].items():
                assert torch.equal(other["train"][name]["params"][k], v), k
        _same_run(got, one_rank[name], f"{name} vs one rank")
        if not dropout:
            _same_run(got, jax_ref[(kind, accum, shard)], f"{name} vs JAX")
        # ZeRO-1 really sharded the optimizer state: adam's moments (GPT)
        # are the rank's half of every leaf with a dim 2 divides
        assert bool(got["zero1_dims"]) == zero1, name
        if kind == "gpt" and zero1:
            mu = got["opt_state"][1][0]["mu"]
            for k, dim in got["zero1_dims"].items():
                assert mu[k].shape[dim] * WORLD == \
                    got["params"][k].shape[dim], k

    # (b)
    want_rows = np.take(table, ids, axis=0)
    for kernel in (False, True):
        rows, _ = ranks[0]["lookup"][kernel]
        np.testing.assert_array_equal(rows.numpy(), want_rows)
        grad = torch.cat([r["lookup"][kernel][1] for r in ranks])
        _close(grad, take_grad, f"lookup grad (use_kernel={kernel})")

    for dtype in worker.WD_DTYPES:
        want_outs, want_grads = wd_take[str(dtype)]
        for r, got in enumerate(ranks):
            runs = got["widedeep_lookup"][str(dtype)]
            for a, b in zip(*(runs[k][0] + runs[k][1]
                              for k in ("grouped", "per_table"))):
                assert a.dtype == b.dtype and torch.equal(a, b), dtype
            for o, w in zip(runs["grouped"][0], want_outs):
                np.testing.assert_array_equal(
                    o.float().numpy(), np.asarray(w.astype(jnp.float32)))
        for t, w in enumerate(want_grads):
            grad = torch.cat([r["widedeep_lookup"][str(dtype)][
                "grouped"][1][t] for r in ranks])
            what = f"Wide&Deep table {t} grad vs take ({dtype})"
            if dtype == torch.bfloat16 and t == 1:
                w = np.asarray(w)
                np.testing.assert_allclose(
                    grad.numpy(), w, rtol=0.0,
                    atol=BF16_GRAD_TOL * float(np.abs(w).max()),
                    err_msg=what)
            else:
                _close(grad, w, what)

    # (c)
    for r, got in enumerate(ranks):
        _close(got["ce"]["mean"], ce_mean.detach(), "ce mean")
        assert float(got["ce"]["n"]) == float(ce_n) == 15.0
        rows = len(x) // WORLD
        _close(got["ce"]["dx"], ce_dx[r * rows:(r + 1) * rows], "ce dx")
        _close(got["ce"]["dw"], ce_dw, "ce dW summed over ranks")

    # (e)
    for r, got in enumerate(ranks):
        run = got["widedeep_train"]
        assert set(run["model_dims"]) == {"embed_tables_wide.weight",
                                          "embed_tables_deep.weight"}
        assert min(run["norms"]) > 10 * worker.WD_CLIP    # every step clips
        _same_run(run, wd_one, f"rank {r} Wide&Deep (clipped) vs one rank")
        _same_run(run, wd_jax, f"rank {r} Wide&Deep (clipped) vs JAX")
    for k, v in ranks[0]["widedeep_train"]["params"].items():
        assert torch.equal(ranks[1]["widedeep_train"]["params"][k], v), k

    # (f)
    for case, want in rn_one.items():
        for r, got in enumerate(ranks):
            run = got["resnet"][case]
            what = f"rank {r} ResNet {case}"
            _close(run["first"]["loss"], want["first"]["loss"],
                   f"{what} first loss")
            for kind in ("grads", "stats"):
                assert set(run["first"][kind]) == set(want["first"][kind])
                for k, v in want["first"][kind].items():
                    _close(run["first"][kind][k], v, f"{what} {kind} {k}")
            _same_run(run, want, f"{what} vs one rank")
            for k, v in want["extra"].items():
                _close(run["extra"][k], v, f"{what} statistic {k}")
            assert run["zero1_dims"], what       # ZeRO-1 split something
        for k, v in ranks[0]["resnet"][case]["extra"].items():
            assert torch.equal(ranks[1]["resnet"][case]["extra"][k], v), k

    # (h)
    for case, want in rn_jax.items():
        for r, got in enumerate(ranks):
            run = got["resnet_accum2"][case]
            what = f"rank {r} ResNet {case} grad_accum 2 vs JAX"
            _same_run(run, want, what)
            assert set(run["extra"]) == set(want["extra"])
            for k, v in want["extra"].items():
                _close(run["extra"][k], v, f"{what} statistic {k}")

    # (i)
    for name, want in bert_jax.items():
        for r, got in enumerate(ranks):
            run = got["bert"][name]
            what = f"rank {r} BERT {name} vs JAX"
            _close(run["losses"], want["losses"], f"{what} losses")
            np.testing.assert_allclose(run["norms"], want["norms"],
                                       rtol=BERT_NORM_TOL,
                                       err_msg=f"{what} grad_norm")
            assert set(run["params"]) == set(want["params"])
            for k, v in want["params"].items():
                if not k.endswith(NOISE_LEAF):
                    _close(run["params"][k], v, f"{what} {k}")
            assert run["zero1_dims"], name
            assert run["restored_equal"], f"{name}: checkpoint round trip"
            for k, v in run["params"].items():
                assert torch.equal(ranks[0]["bert"][name]["params"][k], v)
    fac = ranks[1]["bert"]["adafactor"]
    state, dims = fac["opt_state"][0], fac["zero1_dims"]
    full = fac["params"]["layer_0.mlp_in.weight"]           # [256, 128]
    assert dims["layer_0.mlp_in.weight"] == 1                # split: d1
    assert tuple(state["v_row"]["layer_0.mlp_in.weight"].shape) == (
        1, full.shape[1] // WORLD)
    assert tuple(state["v_col"]["layer_0.mlp_in.weight"].shape) == (
        full.shape[0], 1)

    # the collectives over a group (exact: small integers in f32)
    xs = [worker.comms_input(r) for r in range(WORLD)]
    total = sum(xs)
    for r, got in enumerate(ranks):
        c = got["comms"]
        assert torch.equal(c["psum"], total)
        assert torch.equal(c["pmean"], total / WORLD)
        assert torch.equal(c["psum_scatter"], total[:, 2 * r:2 * r + 2])
        assert torch.equal(c["all_gather"], torch.cat(xs, dim=1))

    # (d)
    rows = len(drop_ids) // WORLD
    for r, got in enumerate(ranks):
        _close(got["dropout"], dropped[r * rows:(r + 1) * rows],
               f"dropout forward, rank {r}")
    x = torch.ones(len(drop_ids), 3, 8)
    full = tgpt._dropout(x, 0.5, 5, 1, 1)
    for r in range(WORLD):
        mine = tgpt._dropout(x[r * rows:(r + 1) * rows], 0.5,
                             tgpt.DropoutKey(5, r, WORLD), 1, 1)
        assert torch.equal(mine, full[r * rows:(r + 1) * rows])
    assert not torch.equal(full[:rows], full[rows:2 * rows])


def _launch_mnist(logdir, *extra):
    """``python -m dtf_tpu_torch.distributed`` as the reference launches
    it: 2 workers over gloo and 1 ps, a fresh rendezvous port."""
    hosts = [f"--ps_hosts=localhost:{free_port()}",
             f"--worker_hosts=localhost:{free_port()},localhost:"
             f"{free_port()}", "--backend=cpu", f"--logdir={logdir}",
             *extra]
    module = ["-m", "dtf_tpu_torch.distributed", *hosts]
    ps = spawn_ranks(lambda r: [*module, "--job_name=ps", "--task_index=0"],
                     f"{logdir}.ps", world=1)
    workers = spawn_ranks(lambda r: [*module, "--job_name=worker",
                                     f"--task_index={r}"], f"{logdir}.w")
    return ps, workers


def test_distributed_launch_line_two_workers_and_a_ps(tmp_path):
    """The reference's launch line: the ps exits 0, both workers train
    200 steps over gloo and print ``done:`` with the same held-out
    accuracy (reduced over the ranks)."""
    ps, workers = _launch_mnist(tmp_path / "run")
    assert "ps role has no work" in join_ranks(ps)[0]
    outs = join_ranks(workers)
    done = [o.strip().splitlines()[-1] for o in outs]
    assert done[0].startswith("done: step=200 eval_accuracy=")
    assert done[0] == done[1]
    assert "loss=" in outs[0] and "loss=" not in outs[1]   # chief prints


@pytest.mark.slow
def test_two_rank_kill_and_resume_equals_the_uninterrupted_run(tmp_path):
    """Two workers killed (SIGKILL) once a checkpoint is on disk, then
    relaunched to N steps: the parameters equal those of a run of N
    steps that was not interrupted, bit for bit."""
    from dtf_tpu_torch.checkpoint import Checkpointer

    killed = tmp_path / "killed"
    ckpt = Checkpointer(killed / "ckpt")
    ps, workers = _launch_mnist(killed, "--train_steps=100000",
                                "--checkpoint_every=5", "--model=mlp")
    join_ranks(ps)
    deadline = time.monotonic() + WAIT_S
    while ckpt.latest_step() is None and time.monotonic() < deadline:
        time.sleep(0.02)
    for p in workers:
        p.kill()
        p.communicate()
    last = ckpt.latest_step()
    assert last is not None, "no checkpoint within the wait"
    n = last + 7
    for logdir in (killed, tmp_path / "straight"):
        ps, workers = _launch_mnist(logdir, f"--train_steps={n}",
                                    "--checkpoint_every=5", "--model=mlp")
        join_ranks(ps)
        join_ranks(workers)
    got = Checkpointer(killed / "ckpt").restore_params(n)
    want = Checkpointer(tmp_path / "straight" / "ckpt").restore_params(n)
    for k in want:
        assert torch.equal(got[k], want[k]), k
