"""The port's MNIST slice (BASELINE config 1) against the JAX package.

``SoftmaxRegression`` and ``MLP`` with one seeded tree on both sides
(``convert.init_params_mnist`` → the flax tree and, through
``params_from_flax``, the port's ``state_dict``): logits, loss, accuracy
and every gradient of one ``make_loss`` call, ``make_eval``, and 3 SGD
steps of ``make_train_step`` (JAX on a one-device mesh), at ``F32_TOL``
(f32 on the CPU; the frameworks sum in other orders). The IDX reader and
writer against the JAX package's, byte for byte; ``MnistData`` and the
synthetic ``mnist`` stream equal per host. Then ``python -m
dtf_tpu_torch.distributed`` in one process on synthetic data and on IDX
files this test writes (the real-data path and its test-split eval).
"""

import contextlib
import io
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtf_tpu.core import train as jtr
from dtf_tpu.core.mesh import MeshConfig, make_mesh
from dtf_tpu.data import mnist as jdata
from dtf_tpu.data.synthetic import SyntheticData as JSynthetic
from dtf_tpu.models import mnist as jmnist
from dtf_tpu_torch import convert, distributed, optim
from dtf_tpu_torch.core import train as ttr
from dtf_tpu_torch.data import mnist as tdata
from dtf_tpu_torch.data.synthetic import SyntheticData as TSynthetic
from dtf_tpu_torch.models import mnist as tmnist

F32_TOL = 1e-5
KINDS = ("softmax", "mlp")


def _models(kind, seed=0):
    jmodel = jmnist.make_model(kind)
    tmodel = tmnist.make_model(kind, device="cpu")
    tree = convert.init_params_mnist(tmodel, seed)
    tmodel.load_state_dict(convert.params_from_flax(tree))
    return jmodel, tmodel, tree


def _batch(step=0, n=16):
    return JSynthetic("mnist", n, seed=1).batch(step)


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_gradients_match_jax(kind):
    jmodel, tmodel, tree = _models(kind, seed=3)
    b = _batch()
    params = jax.tree.map(jnp.asarray, tree)
    (want, jaux), jgrads = jax.value_and_grad(
        jmnist.make_loss(jmodel), has_aux=True)(params, {}, b, None)
    loss, aux = tmnist.make_loss(tmodel)(None, _torch(b), None)
    tparams = dict(tmodel.named_parameters())
    grads = torch.autograd.grad(loss, list(tparams.values()))
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(want), atol=F32_TOL,
                               rtol=F32_TOL)
    assert float(aux.metrics["accuracy"]) == float(jaux.metrics["accuracy"])
    want_g = convert.params_from_flax(jax.tree.map(np.asarray, jgrads))
    for (n, _), g in zip(tparams.items(), grads):
        np.testing.assert_allclose(g.numpy(), want_g[n].numpy(),
                                   atol=F32_TOL, rtol=F32_TOL, err_msg=n)
    logits = jmodel.apply({"params": params}, b["image"])
    np.testing.assert_allclose(
        tmodel(torch.from_numpy(b["image"])).detach().numpy(),
        np.asarray(logits), atol=F32_TOL, rtol=F32_TOL)
    got = tmnist.make_eval(tmodel)(None, _torch(b))
    want_e = jmnist.make_eval(jmodel)(params, {}, b)
    for k in ("eval_loss", "eval_accuracy"):
        np.testing.assert_allclose(float(got[k]), float(want_e[k]),
                                   atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_three_sgd_steps_match_jax(kind):
    jmodel, tmodel, tree = _models(kind, seed=4)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    tx = optax.sgd(0.05)
    state, shardings = jtr.create_train_state(
        jmnist.make_init(jmodel), tx, jax.random.PRNGKey(0), mesh)
    params = jax.tree.map(jnp.asarray, tree)
    state = state.replace(params=params, opt_state=tx.init(params))
    jstep = jtr.make_train_step(jmnist.make_loss(jmodel), tx, mesh,
                                shardings, donate=False)
    ttx = optim.sgd(0.05)
    tstate = ttr.create_train_state(tmodel, ttx, 0)
    tstep = ttr.make_train_step(tmnist.make_loss(tmodel), ttx)
    for i in range(3):
        b = _batch(i)
        state, jm = jstep(state, b)
        tstate, tm = tstep(tstate, _torch(b))
        for k in ("loss", "grad_norm", "accuracy"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       atol=F32_TOL, rtol=F32_TOL, err_msg=k)
    want = convert.params_from_flax(jax.tree.map(np.asarray, state.params))
    for n, p in tmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=n)


def test_init_matches_make_init_distributions():
    """The port's draws are numpy's, flax's are its PRNG's: the same
    lecun-normal distribution (std within 3%) and zero biases."""
    jmodel = jmnist.make_model("mlp")
    jtree = jax.tree.map(np.asarray, jmnist.make_init(jmodel)(
        jax.random.PRNGKey(0))["params"])
    tree = convert.init_params_mnist(tmnist.MLP(device="cpu"), 0)
    for layer in ("hidden_0", "logits"):
        got, want = tree[layer]["kernel"], jtree[layer]["kernel"]
        assert got.shape == want.shape
        assert abs(got.std() / want.std() - 1) < 0.03, layer
        assert not tree[layer]["bias"].any()


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_match_the_jax_package(tmp_path, gz):
    arr = np.random.default_rng(0).integers(0, 256, (5, 4, 3), np.uint8)
    tdata.write_idx(str(tmp_path / "t"), arr, gz=gz)
    jdata.write_idx(str(tmp_path / "j"), arr, gz=gz)
    suffix = ".gz" if gz else ""
    if not gz:     # gzip stamps the file's name: compare the payloads
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    for path in ("t", "j"):
        np.testing.assert_array_equal(
            tdata.read_idx(str(tmp_path / path)), arr)
        np.testing.assert_array_equal(
            jdata.read_idx(str(tmp_path / path)), arr)
    assert (tmp_path / f"t{suffix}").exists()
    (tmp_path / "bad").write_bytes(b"\x00\x00\x0d\x01" + b"\x00" * 8)
    with pytest.raises(ValueError, match="unsupported IDX magic"):
        tdata.read_idx(str(tmp_path / "bad"))


def _write_mnist(directory, n_train=40, n_test=24, seed=0):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        path = os.path.join(directory, tdata.FILES[f"{split}_images"])
        tdata.write_idx(path, rng.integers(0, 256, (n, 28, 28), np.uint8))
        path = os.path.join(directory, tdata.FILES[f"{split}_labels"])
        tdata.write_idx(path, rng.integers(0, 10, (n,), np.uint8))


@pytest.mark.parametrize("host", [(0, 1), (0, 2), (1, 2)])
def test_mnist_data_and_synthetic_equal_jax_per_host(tmp_path, host):
    _write_mnist(str(tmp_path))
    assert tdata.available(str(tmp_path)) and jdata.available(str(tmp_path))
    kw = dict(seed=3, host_index=host[0], host_count=host[1])
    got = tdata.MnistData(str(tmp_path), 8, **kw)
    want = jdata.MnistData(str(tmp_path), 8, **kw)
    assert got.batches_per_epoch_uniform() == \
        want.batches_per_epoch_uniform()
    for g, w in zip(list(zip(range(7), got)), list(zip(range(7), want))):
        for k in ("image", "label"):
            np.testing.assert_array_equal(g[1][k], w[1][k])
    tsyn, jsyn = TSynthetic("mnist", 8, **kw), JSynthetic("mnist", 8, **kw)
    for step in (0, 5):
        for k in ("image", "label"):
            np.testing.assert_array_equal(tsyn.batch(step)[k],
                                          jsyn.batch(step)[k])


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = distributed.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def test_distributed_entry_in_one_process(tmp_path, caplog):
    flags = ["--backend=cpu", f"--logdir={tmp_path / 'a'}",
             "--train_steps=30", "--log_every=10"]
    with caplog.at_level(logging.WARNING, logger="dtf_tpu_torch"):
        rc, out = _main(flags + ["--issync=0"])
    assert rc == 0 and out[-1].startswith("done: step=30 eval_accuracy=")
    assert "issync" in caplog.text
    # the reference's model at its learning rate learns the synthetic map
    assert float(out[-1].split("=")[-1]) > 0.2
    with pytest.raises(SystemExit) as e:
        distributed.main(flags + ["--job_name=ps"])
    assert e.value.code == 0
    # real IDX files: the train split, then the whole test split's eval
    _write_mnist(str(tmp_path / "data"), n_train=64, n_test=40)
    rc, out = _main(["--backend=cpu", f"--logdir={tmp_path / 'b'}",
                     f"--data_dir={tmp_path / 'data'}", "--batch_size=16",
                     "--train_steps=5", "--model=mlp"])
    assert rc == 0 and out[-1].startswith("done: step=5 eval_accuracy=")
