"""The port's ResNet against the JAX package's, module by module, on the CPU.

Tiny models from the JAX package's own ``ResNet`` class at f32 — stage
sizes (1, 1), 4 filters, 5 classes, both stems and both block types —
on 8×8 and odd 9×9 images, batch 4, the same variables on both sides
(``convert.init_params_resnet`` with every BatchNorm scale, bias and
running statistic drawn away from its init, so no branch is dead). In
train mode against ``resnet.make_loss`` with weight decay on: logits
within ``LOGIT_TOL`` × max|logit|, the loss within ``F32_TOL``, the
BatchNorm running statistics within ``F32_TOL``, every gradient within
``GRAD_TOL`` × the leaf's max|g| (f32 on the CPU; the two frameworks sum
in other orders). Eval mode against ``make_eval``. XLA's SAME padding at
even and odd sizes; the converter both ways; the init distributions
against ``make_init``; the ``cifar``/``imagenet`` synthetic batches bit
for bit; the image readers against the JAX ones on tiny files written
here; ``resolve_loss_l2``.
"""

import argparse
import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import _torch_multirank_worker as worker
from dtf_tpu.cli import flags as jflags
from dtf_tpu.data import formats as jformats
from dtf_tpu.data.synthetic import SyntheticData as JSynthetic
from dtf_tpu.models import resnet as jresnet
from dtf_tpu_torch import convert
from dtf_tpu_torch.cli import flags as tflags
from dtf_tpu_torch.core import train as ttr
from dtf_tpu_torch.data import formats as tformats
from dtf_tpu_torch.data.synthetic import SyntheticData as TSynthetic
from dtf_tpu_torch.models import resnet as tresnet

F32_TOL = 1e-5
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4
WEIGHT_DECAY = 1e-2
#: the kernels whose std the init test holds: 3×3×32×32 and up
STD_MIN_ELEMENTS = 9216

#: (stem, block, image size): both stems, both blocks, even and odd sizes
CASES = [("cifar", "BasicBlock", 8), ("imagenet", "BottleneckBlock", 9),
         ("imagenet", "BasicBlock", 8), ("cifar", "BottleneckBlock", 9)]


def jax_model(stem, block):
    return jresnet.ResNet(stage_sizes=worker.RN_STAGES,
                          block=getattr(jresnet, block),
                          num_classes=worker.RN_CLASSES,
                          num_filters=worker.RN_FILTERS, stem=stem,
                          dtype=jnp.float32)


def models(stem, block, seed=0):
    """(JAX model, port model loaded, the flax variables of both)."""
    tmodel = worker.resnet_tiny(stem, block)
    tree = worker.resnet_vars(tmodel, seed)
    worker.load_resnet(tmodel, tree)
    return jax_model(stem, block), tmodel, tree


def batch(size, seed=1):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal(
                (worker.RN_BATCH, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, worker.RN_CLASSES,
                                  (worker.RN_BATCH,)).astype(np.int32)}


def _jvars(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close_rel(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0.0,
        atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL, err_msg=what)


def _stats_close(tmodel, jstats, what):
    got = convert.stats_from_flax(jax.tree.map(np.asarray, jstats))
    buffers = dict(tmodel.named_buffers())
    assert set(got) == set(buffers)
    for k, v in got.items():
        _close(buffers[k], v, f"{what} {k}")


@pytest.mark.parametrize("stem,block,size", CASES)
def test_train_mode_logits_loss_stats_and_grads_match_jax(stem, block, size):
    jmodel, tmodel, tree = models(stem, block)
    b = batch(size)
    logits, new_vars = jax.jit(functools.partial(
        jmodel.apply, train=True, mutable=["batch_stats"]))(
        _jvars(tree), b["image"])
    tmodel.train()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(b["image"]))
    _close_rel(got, logits, LOGIT_TOL, "train-mode logits")
    _stats_close(tmodel, new_vars["batch_stats"], "running statistics")

    # the loss with weight decay, and every gradient (a fresh load: the
    # forward above moved the statistics)
    worker.load_resnet(tmodel, tree)
    jloss_fn = jresnet.make_loss(jmodel, weight_decay=WEIGHT_DECAY)
    extra = {"batch_stats": _jvars(tree["batch_stats"])}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))(
        _jvars(tree["params"]), extra, b, jax.random.PRNGKey(0))
    params = dict(tmodel.named_parameters())
    tloss, taux = tresnet.make_loss(tmodel, weight_decay=WEIGHT_DECAY)(
        params, {k: torch.from_numpy(v) for k, v in b.items()}, 0)
    grads = dict(zip(params, torch.autograd.grad(tloss,
                                                 list(params.values()))))
    _close(tloss.detach(), jloss, "loss")
    _close(taux.metrics["accuracy"], jaux.metrics["accuracy"], "accuracy")
    _stats_close(tmodel, jaux.extra["batch_stats"], "statistics of the loss")
    want = convert.params_from_flax(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for k, g in want.items():
        _close_rel(grads[k], g, GRAD_TOL, f"grad {k}")


@pytest.mark.parametrize("stem,block,size", CASES[:2])
def test_eval_mode_matches_make_eval(stem, block, size):
    """Eval mode normalizes with the running statistics, which stay;
    ``make_eval_step(model=)`` restores train mode after."""
    jmodel, tmodel, tree = models(stem, block)
    b = batch(size, seed=2)
    want = jresnet.make_eval(jmodel)(_jvars(tree["params"]),
                                     {"batch_stats": _jvars(
                                         tree["batch_stats"])}, b)
    logits = jmodel.apply(_jvars(tree), b["image"], train=False)
    tmodel.train()
    state = ttr.TrainState(0, dict(tmodel.named_parameters()), None, 0)
    step = ttr.make_eval_step(tresnet.make_eval(tmodel), model=tmodel)
    got = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert tmodel.training
    _close(got["eval_loss"], want["eval_loss"], "eval_loss")
    _close(got["eval_accuracy"], want["eval_accuracy"], "eval_accuracy")
    tmodel.eval()
    with torch.no_grad():
        _close_rel(tmodel(torch.from_numpy(b["image"])), logits, LOGIT_TOL,
                   "eval-mode logits")
    _stats_close(tmodel, tree["batch_stats"], "statistics after eval")


@pytest.mark.parametrize("size", [8, 9, 7])
@pytest.mark.parametrize("k,s", [(3, 2), (7, 2), (1, 2), (3, 1)])
def test_same_padding_matches_xla(size, k, s):
    """Conv and the stem's max-pool against flax's SAME at even and odd
    sizes: symmetric padding alone would shift strided windows."""
    rng = np.random.default_rng(size * 10 + k)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    kernel = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    want = nn.Conv(4, (k, k), (s, s), padding="SAME", use_bias=False,
                   dtype=jnp.float32).apply({"params": {"kernel": kernel}},
                                            x)
    conv = tresnet.Conv(3, 4, k, s, dtype=torch.float32)
    conv.load_state_dict(convert.params_from_flax({"kernel": kernel}))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = conv(xt).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if (k, s) == (3, 2):
        want = nn.max_pool(x, (3, 3), (2, 2), padding="SAME")
        xp, pad = tresnet._pad_same(xt, 3, 2, value=-float("inf"))
        got = torch.nn.functional.max_pool2d(xp, 3, 2, padding=pad)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("stem,block", [("cifar", "BasicBlock"),
                                        ("imagenet", "BottleneckBlock")])
def test_converter_round_trips_both_ways(stem, block):
    """flax → the port → flax, params and batch_stats, leaf for leaf; and
    the port's state_dict → flax → state_dict."""
    jmodel, tmodel, _ = models(stem, block)
    tree = jax.tree.map(np.asarray, jax.jit(jresnet.make_init(
        jmodel, (8, 8, 3)))(jax.random.PRNGKey(0)))
    worker.load_resnet(tmodel, tree)
    sd = tmodel.state_dict()
    params = {k: v for k, v in sd.items() if not k.endswith((".mean",
                                                             ".var"))}
    stats = {k: v for k, v in sd.items() if k.endswith((".mean", ".var"))}
    for got, want in ((convert.params_to_flax(params), tree["params"]),
                      (convert.stats_to_flax(stats), tree["batch_stats"])):
        got, want = dict(convert._flatten(got)), dict(convert._flatten(want))
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], str(path))
    back = {**convert.params_from_flax(convert.params_to_flax(params)),
            **convert.stats_from_flax(convert.stats_to_flax(stats))}
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_init_distributions_match_make_init():
    """ResNet-20 at full width: the std of every kernel of at least
    ``STD_MIN_ELEMENTS`` elements within 3% of JAX's and of
    1/sqrt(fan_in) (a sample std's own spread there is 0.74%); every
    kernel bounded by the truncation at 2σ; BatchNorm scale 1,
    0 on each block's last one, bias 0, running mean 0 and variance 1."""
    tmodel = tresnet.resnet20(dtype=torch.float32, device="cpu")
    tree = convert.init_params_resnet(tmodel, seed=0)
    jtree = jax.tree.map(np.asarray, jax.jit(jresnet.make_init(
        jresnet.resnet20(dtype=jnp.float32), (32, 32, 3)))(
        jax.random.PRNGKey(0)))
    for col in ("params", "batch_stats"):
        flat_t = dict(convert._flatten(tree[col]))
        flat_j = dict(convert._flatten(jtree[col]))
        assert {p: v.shape for p, v in flat_t.items()} == \
            {p: v.shape for p, v in flat_j.items()}, col
        for path, v in flat_t.items():
            if path[-1] == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                if v.size >= STD_MIN_ELEMENTS:
                    assert np.std(v) == pytest.approx(fan_in ** -0.5,
                                                      rel=0.03)
                    assert np.std(v) == pytest.approx(np.std(flat_j[path]),
                                                      rel=0.03)
                bound = 2.0 / (np.sqrt(fan_in) * convert._TRUNC_NORMAL_STD)
                assert np.abs(v).max() <= bound * (1 + 1e-6)
            else:                 # scale, bias, mean, var: constants
                np.testing.assert_array_equal(v, flat_j[path], str(path))
    last = [p for p in dict(convert._flatten(tree["params"]))
            if p[1] == "BatchNorm_1" and p[-1] == "scale"]
    assert len(last) == 9


@pytest.mark.parametrize("kind,batch_size", [("cifar", 8), ("imagenet", 2)])
def test_image_synthetic_batches_equal_jax_bitwise(kind, batch_size):
    for host in range(2):
        got = TSynthetic(kind, batch_size, seed=3, host_index=host,
                         host_count=2).batch(5)
        want = JSynthetic(kind, batch_size, seed=3, host_index=host,
                          host_count=2).batch(5)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _write_npy(d, n, prefix=""):
    rng = np.random.default_rng(len(prefix) + n)
    np.save(os.path.join(d, f"{prefix}images.npy"),
            rng.integers(0, 256, (n, 6, 6, 3)).astype(np.uint8))
    np.save(os.path.join(d, f"{prefix}labels.npy"),
            rng.integers(0, 10, (n,)).astype(np.int64))


def _write_cifar(d, name, n, seed):
    rng = np.random.default_rng(seed)
    rec = rng.integers(0, 256, (n, 1 + 3 * 32 * 32)).astype(np.uint8)
    rec[:, 0] %= 10
    rec.tofile(os.path.join(d, name))


def _same_batches(got, want, n=4):
    for a, b in zip(list(zip(range(n), got)), list(zip(range(n), want))):
        assert set(a[1]) == set(b[1])
        for k in b[1]:
            assert a[1][k].dtype == b[1][k].dtype, k
            np.testing.assert_array_equal(a[1][k], b[1][k])


def test_image_readers_equal_jax(tmp_path):
    """images.npy (uint8 scaled to [0, 1)) and CIFAR .bin batches, train
    and test splits, host 1 of 2, against the JAX readers batch for batch;
    a directory with TFRecords only raises "not yet ported"."""
    npy, cifar, tfr = (tmp_path / n for n in ("npy", "cifar", "tfr"))
    for d in (npy, cifar, tfr):
        d.mkdir()
    _write_npy(str(npy), 20)
    _write_npy(str(npy), 12, prefix="test_")
    _write_cifar(str(cifar), "data_batch_1.bin", 9, 1)
    _write_cifar(str(cifar), "data_batch_2.bin", 7, 2)
    _write_cifar(str(cifar), "test_batch.bin", 8, 3)
    kw = dict(seed=4, host_index=1, host_count=2)
    for d, cls in ((npy, tformats.NpyImageData),
                   (cifar, tformats.CifarBinData)):
        for detect in ("detect_image_data", "detect_image_eval_data"):
            got = getattr(tformats, detect)(str(d), 4, **kw)
            want = getattr(jformats, detect)(str(d), 4, **kw)
            assert isinstance(got, cls), (d, detect)
            assert got.batches_per_epoch_uniform() == \
                want.batches_per_epoch_uniform()
            _same_batches(iter(got), iter(want), n=6)
    (tfr / "train-0.tfrecord").write_bytes(b"")
    assert tformats.detect_image_eval_data(str(tfr), 4) is None
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tformats.detect_image_data(str(tfr), 4)
    assert tformats.detect_image_data("", 4) is None
    assert tformats.detect_image_data(str(tmp_path), 4) is None


@pytest.mark.parametrize("optimizer,wd", [("", -1.0), ("", 5e-4),
                                          ("momentum", -1.0),
                                          ("adamw", -1.0), ("adamw", 1e-2)])
def test_resolve_loss_l2_matches_jax(optimizer, wd, caplog):
    """The recipe's loss-side L2 unless a decoupled-decay optimizer takes
    it; an unset --weight_decay then inherits the recipe's value, with a
    warning."""
    got_args = argparse.Namespace(optimizer=optimizer, weight_decay=wd)
    want_args = argparse.Namespace(optimizer=optimizer, weight_decay=wd)
    with caplog.at_level(logging.WARNING, logger="dtf_tpu_torch"):
        got = tflags.resolve_loss_l2(got_args, recipe_l2=1e-4)
    assert got == jflags.resolve_loss_l2(want_args, recipe_l2=1e-4)
    assert got_args.weight_decay == want_args.weight_decay
    promoted = optimizer in tflags.DECOUPLED_DECAY_OPTIMIZERS and wd < 0
    assert promoted == ("drops the recipe's loss-side L2" in caplog.text)
    assert tflags.DECOUPLED_DECAY_OPTIMIZERS == \
        jflags.DECOUPLED_DECAY_OPTIMIZERS

