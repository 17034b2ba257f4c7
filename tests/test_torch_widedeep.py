"""The port's Wide&Deep slice against the JAX package.

``WideDeep(hash_buckets=64, embed_dim=8, mlp=(32, 16))``, as
``tests/test_widedeep_embedding.py::_build``, with the same parameters on
both sides (a flax tree in numpy → ``convert.params_from_flax``) and the
same batches (``SyntheticData("widedeep")``, byte-equal in both
packages). The JAX side runs ``model.apply`` / ``jax.grad`` and
``core.train.make_train_step`` + ``optax.adam`` on a one-device mesh.

Tolerances: f32 1e-5 (absolute and relative: the two frameworks sum the
MLP's products and the table gradient's duplicate ids in other orders).
bf16 (the default model dtype): the logits and the loss are f32 (the
wide half and ``deep_out`` compute in f32) and held at 1e-5 too; the MLP
computes in bf16, its bias gradients are sums over the batch of bf16
cotangents that the two frameworks accumulate at other precisions before
rounding to bf16, and the deep table's gradient is a bf16 scatter-add of
duplicate ids in both, in other orders. Every gradient is held to 2^-6
of its largest element, two bf16 ulps there (``BF16_GRAD_TOL``).
Observed on the CPU: logits 9.5e-7, loss 2.4e-7, the deep table's
gradient equal, ``mlp_0.bias`` 0.0084 of its largest element.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtf_tpu.core import train as jtr
from dtf_tpu.core.mesh import MeshConfig, make_mesh
from dtf_tpu.data import formats as jformats
from dtf_tpu.data.synthetic import SyntheticData as JSynthetic
from dtf_tpu.models import widedeep as jwd
from dtf_tpu_torch import convert, optim, train_widedeep
from dtf_tpu_torch.core import train as ttr
from dtf_tpu_torch.data import formats as tformats
from dtf_tpu_torch.data.synthetic import SyntheticData as TSynthetic
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.models import widedeep as twd

F32_TOL = 1e-5
BF16_GRAD_TOL = 2.0 ** -6
SMALL = dict(hash_buckets=64, embed_dim=8, mlp=(32, 16))
BATCH = 32


def _models(dtype, seed=1, **kw):
    """The JAX model, the port's, and one seeded tree loaded into it."""
    cfg = {**SMALL, **kw}
    jmodel = jwd.WideDeep(**cfg, dtype=jnp.float32 if dtype == "f32"
                          else jnp.bfloat16)
    tmodel = twd.WideDeep(**cfg, dtype=torch.float32 if dtype == "f32"
                          else torch.bfloat16, device="cpu")
    tree = convert.init_params_widedeep(tmodel, seed)
    tmodel.load_state_dict(convert.params_from_flax(tree))
    return jmodel, tmodel, tree


def _batch(step=0, n=BATCH):
    return JSynthetic("widedeep", n, seed=0, hash_buckets=64).batch(step)


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 2)])
def test_synthetic_batches_equal_the_jax_package(host_index, host_count):
    for step in (0, 1, 7):
        want = JSynthetic("widedeep", 16, seed=3, hash_buckets=500,
                          host_index=host_index,
                          host_count=host_count).batch(step)
        got = TSynthetic("widedeep", 16, seed=3, hash_buckets=500,
                         host_index=host_index,
                         host_count=host_count).batch(step)
        assert sorted(got) == sorted(want) == ["dense", "label", "sparse"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_init_distributions_match_make_init():
    """Std of every table and of the wide MLP kernel within 3% of JAX's
    and of 1/sqrt(embed_dim) (400 buckets: 10,400 table rows); lecun
    kernels bounded by their truncation at 2σ; zero biases."""
    jmodel, tmodel, tree = _models("f32", seed=0, hash_buckets=400)
    jtree = jax.tree.map(np.asarray, jax.jit(jwd.make_init(jmodel))(
        jax.random.PRNGKey(0))["params"])
    flat_t, flat_j = dict(convert._flatten(tree)), dict(convert._flatten(jtree))
    assert {p: v.shape for p, v in flat_t.items()} == \
        {p: v.shape for p, v in flat_j.items()}
    assert np.std(flat_t[("embed_tables_deep", "embedding")]) == \
        pytest.approx(SMALL["embed_dim"] ** -0.5, rel=0.03)
    for path in (("embed_tables_wide", "embedding"),
                 ("embed_tables_deep", "embedding"), ("mlp_0", "kernel")):
        assert np.std(flat_t[path]) == pytest.approx(np.std(flat_j[path]),
                                                     rel=0.03)
    for path, v in flat_t.items():
        if path[-1] == "bias":
            assert not v.any() and not flat_j[path].any()
        elif path[-1] == "kernel":
            bound = 2.0 / (np.sqrt(v.shape[0]) * convert._TRUNC_NORMAL_STD)
            assert np.abs(v).max() <= bound * (1 + 1e-6)
            assert np.abs(flat_j[path]).max() <= bound * (1 + 1e-6)


@pytest.mark.parametrize("model", ["gpt", "widedeep"])
def test_converter_round_trips_both_ways(model):
    """flax → the port → flax gives the tree back, leaf for leaf (the wide
    table [R, 1] stays an ``embedding``, not a transposed kernel); and the
    port's ``state_dict`` → flax → ``state_dict`` gives it back."""
    if model == "gpt":
        tmodel = tgpt.GPT(tgpt.GPTConfig.tiny(dtype=torch.float32),
                          device="cpu")
        tree = convert.init_params_flax(tmodel.cfg, seed=0)
    else:
        jmodel, tmodel, _ = _models("f32")
        tree = jax.tree.map(np.asarray, jax.jit(jwd.make_init(jmodel))(
            jax.random.PRNGKey(0))["params"])
    tmodel.load_state_dict(convert.params_from_flax(tree))
    back = dict(convert._flatten(convert.params_to_flax(
        tmodel.state_dict())))
    want = dict(convert._flatten(tree))
    assert sorted(back) == sorted(want)
    for path, v in want.items():
        np.testing.assert_array_equal(back[path], v)
    sd = tmodel.state_dict()
    again = convert.params_from_flax(convert.params_to_flax(sd))
    assert list(again) == list(sd)
    for k, v in sd.items():
        assert torch.equal(again[k], v)


def _jax_loss_and_grads(jmodel, tree, batch):
    loss_fn = jwd.make_loss(jmodel)
    params = jax.tree.map(jnp.asarray, tree)

    @jax.jit
    def run(p):
        out = jax.value_and_grad(lambda p: loss_fn(p, {}, batch, None),
                                 has_aux=True)(p)
        return out, jmodel.apply({"params": p}, batch["dense"],
                                 batch["sparse"])

    ((loss, aux), grads), logits = run(params)
    return (np.asarray(logits), float(loss),
            {k: float(v) for k, v in aux.metrics.items()},
            convert.params_from_flax(jax.tree.map(np.asarray, grads)))


def _port_loss_and_grads(tmodel, batch):
    tb = _tb(batch)
    params = dict(tmodel.named_parameters())
    loss, aux = twd.make_loss(tmodel)(params, tb, 0)
    grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        logits = tmodel(tb["dense"], tb["sparse"])
    return (logits.float().numpy(), loss.item(),
            {k: float(v) for k, v in aux.metrics.items()},
            dict(zip(params, grads)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_loss_metrics_and_grads_match_jax(dtype):
    jmodel, tmodel, tree = _models(dtype)
    batch = _batch()
    flat = batch["sparse"] + np.arange(26) * 64
    assert len(np.unique(flat)) < flat.size        # duplicate ids present
    want_l, want_loss, want_m, want_g = _jax_loss_and_grads(jmodel, tree,
                                                            batch)
    got_l, got_loss, got_m, got_g = _port_loss_and_grads(tmodel, batch)
    np.testing.assert_allclose(got_l, want_l, rtol=F32_TOL, atol=F32_TOL)
    assert got_loss == pytest.approx(want_loss, rel=F32_TOL, abs=F32_TOL)
    assert got_m["accuracy"] == want_m["accuracy"]
    assert got_m["pred_corr"] == pytest.approx(want_m["pred_corr"],
                                               abs=F32_TOL)
    assert sorted(got_g) == sorted(want_g)
    for name, g in want_g.items():
        if dtype == "f32":
            rtol, atol = F32_TOL, F32_TOL
        else:
            rtol, atol = 0.0, BF16_GRAD_TOL * float(g.abs().max())
        np.testing.assert_allclose(got_g[name].numpy(), g.numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_train_steps_match_jax():
    """Three Adam steps at the launcher's lr (1e-3), f32: loss,
    ``grad_norm`` and accuracy each step, then every parameter. (Adam
    divides by sqrt(v): a parameter whose gradient is near 0 moves by
    about lr whatever the rounding noise in that gradient, so the
    parameters are compared at the launcher's lr.)"""
    jmodel, tmodel, tree = _models("f32")
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    tx = optax.adam(1e-3)
    state, shardings = jtr.create_train_state(
        jwd.make_init(jmodel), tx, jax.random.PRNGKey(0), mesh,
        param_rules=jwd.rules)
    params = jax.tree.map(jnp.asarray, tree)
    state = state.replace(params=params, opt_state=tx.init(params))
    jstep = jtr.make_train_step(jwd.make_loss(jmodel), tx, mesh, shardings,
                                donate=False)
    ttx = optim.adam(1e-3)
    tstate = ttr.create_train_state(tmodel, ttx, 0)
    tstep = ttr.make_train_step(twd.make_loss(tmodel), ttx)
    for i in range(3):
        b = _batch(i)
        state, jm = jstep(state, b)
        tstate, tm = tstep(tstate, _tb(b))
        for k in ("loss", "grad_norm", "accuracy"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), abs=F32_TOL,
                                                 rel=F32_TOL), (i, k)
    want = convert.params_from_flax(jax.tree.map(np.asarray, state.params))
    for name, p in tmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=F32_TOL, rtol=F32_TOL, err_msg=name)


def test_make_eval_matches_jax():
    """``eval_logloss``, ``eval_accuracy``, ``eval_pred_corr``; a batch of
    one label gives ``eval_pred_corr`` 0 on both sides (``corrcoef`` is
    NaN there, ``nan_to_num`` makes it 0)."""
    jmodel, tmodel, tree = _models("f32")
    params = jax.tree.map(jnp.asarray, tree)
    constant = dict(_batch(5), label=np.ones(BATCH, np.float32))
    for batch in (_batch(4), constant):
        want = jax.jit(jwd.make_eval(jmodel))(params, {}, batch)
        with torch.no_grad():
            got = twd.make_eval(tmodel)(None, _tb(batch))
        assert sorted(got) == sorted(want)
        for k in want:
            assert float(got[k]) == pytest.approx(float(want[k]),
                                                  abs=F32_TOL, rel=F32_TOL)
    assert float(got["eval_pred_corr"]) == 0.0


def test_widedeep_learns():
    """``test_widedeep_learns``' run on the port: 25 Adam steps (lr 1e-2)
    at f32 lower the loss and beat a coin flip."""
    _, tmodel, _ = _models("f32", seed=0)
    tx = optim.adam(1e-2)
    state = ttr.create_train_state(tmodel, tx, 0)
    step = ttr.make_train_step(twd.make_loss(tmodel), tx)
    data = TSynthetic("widedeep", BATCH, seed=0, hash_buckets=64)
    losses = []
    for i in range(25):
        state, metrics = step(state, _tb(data.batch(i)))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert float(metrics["accuracy"]) > 0.55


def _criteo_tsv(path, n_rows, line_end):
    rng = np.random.default_rng(0)
    with open(path, "w", newline="") as f:
        for i in range(n_rows):
            ints = [str(int(v)) if v >= 0 else ""
                    for v in rng.integers(-2, 500, 13)]
            cats = [f"{int(v):08x}" if v % 5 else ""
                    for v in rng.integers(0, 2 ** 31, 26)]
            f.write("\t".join([str(i % 2)] + ints + cats) + line_end)


@pytest.mark.parametrize("line_end", ["\n", "\r\n"])
def test_criteo_batches_equal_the_jax_package(tmp_path, monkeypatch,
                                              line_end):
    """The same 64-row TSV through both packages' ``CriteoCsvData`` (each
    parsing its own copy: the caches must not be shared): 6 batches of 16,
    across an epoch boundary, equal byte for byte; the port's cache sits
    next to its source."""
    monkeypatch.delenv("DTF_DATA_CACHE", raising=False)
    src = tmp_path / "jax" / "train.tsv"
    src.parent.mkdir()
    _criteo_tsv(src, 64, line_end)
    (tmp_path / "port").mkdir()
    shutil.copy(src, tmp_path / "port" / "train.tsv")
    kw = dict(hash_buckets=100, seed=0)
    want = iter(jformats.CriteoCsvData(str(src.parent), 16, **kw))
    got = iter(tformats.detect_criteo_data(str(tmp_path / "port"), 16, **kw))
    for _ in range(6):
        w, g = next(want), next(got)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert os.path.isdir(str(tmp_path / "port" / "train.tsv") +
                         ".dtfcache-hb100-ns26")


def test_criteo_bad_column_count_raises(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("1," + ",".join(["3"] * 13) + ",a,b\n")
    with pytest.raises(ValueError, match="expected 40 columns"):
        tformats.CriteoCsvData(str(path), 1)


def test_train_widedeep_entry_trains_resumes_and_refuses_a_mesh(tmp_path,
                                                                capsys):
    flags = ["--device=cpu", "--hash_buckets=500", "--batch_size=64",
             f"--logdir={tmp_path / 'run'}", "--log_every=1"]
    assert train_widedeep.main(flags + ["--train_steps=2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "done: step=2"
    assert any("eval_accuracy" in ln for ln in out)
    state, writer = train_widedeep.run(flags + ["--train_steps=3"])
    assert state.step == 3
    assert [s for s, m in writer.history if "loss" in m] == [3]
    # row-sharded tables need one process per rank (they run in
    # tests/test_torch_multirank.py); one process refuses the mesh
    with pytest.raises(ValueError, match="one process per device"):
        train_widedeep.run(flags + ["--mesh_model=2"])
