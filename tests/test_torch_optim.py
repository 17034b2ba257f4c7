"""The port's optimizers against optax, one update at a time.

Both sides are built by their package's launcher helper
(``dtf_tpu.cli.flags.make_optimizer`` / ``dtf_tpu_torch.optim
.make_optimizer``) from the same flags, and take the same seeded numpy
gradients for five updates; the parameters must agree at rel 1e-6 after
each. The schedules (constant, constant with warmup, linear and cosine
with the auto warmup) are compared step by step, and the first update
under warmup must leave the parameters unchanged (lr 0 at count 0).
"""

import argparse

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtf_tpu.cli import flags as jflags
from dtf_tpu_torch import optim

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"w": (4, 3), "b": (3,), "ln": (5,)}


def _args(optimizer, sched, **kw):
    kind, warm = {"constant": ("constant", -1),
                  "constant_warmup": ("constant", 2),
                  "linear": ("linear", -1),
                  "cosine": ("cosine", -1)}[sched]
    base = dict(learning_rate=0.1, lr_schedule=kind, warmup_steps=warm,
                lr_min_ratio=0.1, train_steps=8, optimizer=optimizer,
                weight_decay=-1.0, clip_grad_norm=0.0)
    base.update(kw)
    return argparse.Namespace(**base)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("sched", ["constant", "constant_warmup", "linear",
                                   "cosine"])
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_updates_match_optax(name, sched):
    args = _args(name, sched)
    jtx = jflags.make_optimizer(args, recipe=None)
    ttx = optim.make_optimizer(args, recipe=None)
    p0 = _params()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jst, tst = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        g = _grads(step)
        ju, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                             jst, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tst = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                             tst, tp)
        optim.apply_updates(tp, tu)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} after update {step}")
        if step == 0 and sched != "constant":
            for k in SHAPES:                   # warmup: lr 0 at count 0
                np.testing.assert_array_equal(tp[k].numpy(), p0[k])


@pytest.mark.parametrize("sched", ["constant_warmup", "linear", "cosine"])
def test_schedule_matches_optax(sched):
    args = _args("adamw", sched, train_steps=20)
    js, ts = jflags.make_lr_schedule(args), optim.make_lr_schedule(args)
    for count in range(25):
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=RTOL,
                                   atol=1e-9, err_msg=f"count {count}")


@pytest.mark.parametrize("norm", [0.5, 3.0])
def test_clip_by_global_norm_matches_optax(norm):
    g = _grads(0)
    total = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))
    g = {k: (v * (norm / total)).astype(np.float32) for k, v in g.items()}
    want, _ = optax.clip_by_global_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in g.items()}, optax.EmptyState())
    tx = optim.clip_by_global_norm(1.0)
    got, _ = tx.update({k: torch.from_numpy(v) for k, v in g.items()},
                       tx.init(None))
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)
        if norm < 1.0:
            np.testing.assert_array_equal(got[k].numpy(), g[k])


def test_wrap_optimizer_clips_before_the_update():
    args = _args("sgd", "constant", clip_grad_norm=0.25)
    jtx = jflags.make_optimizer(args, recipe=None)
    ttx = optim.make_optimizer(args, recipe=None)
    p, g = _params(), _grads(1)
    ju, _ = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                       jtx.init({k: jnp.asarray(v) for k, v in p.items()}))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tu, _ = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                       ttx.init(tp), tp)
    for k in p:
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                   rtol=RTOL, atol=ATOL)


def test_recipe_and_weight_decay_rules():
    # the GPT recipe: adamw(wd=0.1) when --optimizer is empty
    args = _args("", "cosine", weight_decay=0.1)
    tx = optim.make_optimizer(
        args, lambda s: optim.adamw(s, weight_decay=0.1), recipe_uses_wd=True)
    assert len(tx.init({"w": torch.zeros(2)})) == 3
    with pytest.raises(ValueError, match="weight_decay"):
        optim.make_optimizer(_args("sgd", "constant", weight_decay=0.1),
                             recipe=None)
    with pytest.raises(ValueError, match="weight_decay"):
        optim.make_optimizer(_args("", "constant", weight_decay=0.1),
                             lambda s: optim.sgd(s))
    with pytest.raises(ValueError, match="unknown"):
        optim.make_optimizer(_args("rmsprop", "constant"), recipe=None)


@pytest.mark.parametrize("name", ["lamb", "adafactor"])
def test_unported_optimizers_raise(name):
    """lamb and adafactor are ported; over a model axis (row-sharded
    leaves, whose per-leaf statistics need the model group) they are
    not, and say so at the first update."""
    tx = optim.make_optimizer(_args(name, "constant"), recipe=None)
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    g = optim.ShardedTree({k: torch.ones_like(v) for k, v in p.items()},
                          None, model={"w": 0})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tx.update(g, tx.init(p), p)


#: lamb's and adafactor's tree: a leaf that factors (both dims >= 128,
#: the second-largest 128), a 2-D one that does not, a 1-D one, a scalar
SHAPES_LA = {"big": (128, 160), "w": (4, 130), "b": (7,), "s": ()}
#: f32 ulps of O(1) parameters: the per-leaf norms and means sum in other
#: orders than XLA's
RTOL_LA, ATOL_LA = 1e-5, 1e-6


@pytest.mark.parametrize("case", ["constant", "cosine_wd", "cosine_clip",
                                  "constant_wd_clip"])
@pytest.mark.parametrize("name", ["lamb", "adafactor"])
def test_lamb_and_adafactor_match_optax(name, case):
    """Five updates from the launcher's flags, one at a time, against
    optax 0.2's ``lamb`` / ``adafactor`` on the same seeded gradients:
    parameters within RTOL_LA after each update; under a decaying
    schedule (the first update's lr is 0), with and without weight decay
    and global-norm clipping."""
    sched = "constant" if case.startswith("constant") else "cosine"
    args = _args(name, sched, weight_decay=0.05 if "wd" in case else -1.0,
                 clip_grad_norm=0.5 if "clip" in case else 0.0)
    jtx = jflags.make_optimizer(args, recipe=None)
    ttx = optim.make_optimizer(args, recipe=None)
    rng = np.random.default_rng(3)
    p0 = {k: np.asarray(rng.standard_normal(s), np.float32)
          for k, s in SHAPES_LA.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jst, tst = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        g = {k: np.asarray(rng.standard_normal(s) * (1 + step), np.float32)
             for k, s in SHAPES_LA.items()}
        ju, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                             jst, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tst = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                             tst, tp)
        optim.apply_updates(tp, tu)
        for k in SHAPES_LA:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL_LA, atol=ATOL_LA,
                                       err_msg=f"{k} after update {step}")
    if name == "adafactor":        # the factored leaf keeps row/col only
        fac = tst[-1][0] if "clip" in case else tst[0]
        assert fac["v_row"]["big"].shape == (128, 1)
        assert fac["v_col"]["big"].shape == (1, 160)
        assert fac["v"]["w"].shape == (4, 130) and fac["v"]["big"].ndim == 0
