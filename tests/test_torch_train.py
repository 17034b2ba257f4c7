"""The port's train step against the JAX package's, step by step.

``GPTConfig.tiny(dtype=float32)``, the same parameters on both sides
(``convert.init_params_flax`` → the flax tree and, through
``params_from_flax``, the port's ``state_dict``) and the same
``SyntheticData("gpt")`` batches. The JAX side is
``core.train.make_train_step(gpt.make_loss(model), tx, mesh, ...)`` on a
one-device mesh with ``optax.adamw`` under the launcher's cosine schedule
with warmup (``cli.flags.make_lr_schedule`` / ``wrap_optimizer``); the
port's is ``core.train.make_train_step`` with ``optim``'s AdamW built the
same way. Three steps: loss and ``grad_norm`` each step, then every
parameter, at atol 1e-5 (f32 on the CPU; the two frameworks sum in other
orders). The fused and chunked LM losses (``loss_pallas``,
``loss_chunk_tokens``, ``loss_chunk``) are held the same way: loss and
every gradient of one ``make_loss`` call, ``make_eval``, and three train
steps with ``loss_pallas`` (the JAX side runs its Pallas kernels in
interpret mode on the CPU).
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtf_tpu.cli import flags as jflags
from dtf_tpu.core import train as jtr
from dtf_tpu.core.mesh import MeshConfig, make_mesh
from dtf_tpu.data.synthetic import SyntheticData
from dtf_tpu.models import gpt as jgpt
from dtf_tpu.ops import losses as jlosses
from dtf_tpu_torch import convert, optim
from dtf_tpu_torch.core import train as ttr
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.ops import losses as tlosses

ATOL = 1e-5
SEQ, BATCH, STEPS = 16, 4, 3


def _args(**kw):
    base = dict(learning_rate=1e-2, lr_schedule="cosine", warmup_steps=-1,
                lr_min_ratio=0.1, train_steps=10, clip_grad_norm=0.0,
                optimizer="", weight_decay=-1.0)
    base.update(kw)
    return argparse.Namespace(**base)


def _batches():
    data = SyntheticData("gpt", BATCH, seed=3, seq_len=SEQ, vocab_size=128)
    return [data.batch(i) for i in range(STEPS)]


def _jax_run(jcfg, tree, args, grad_accum, loss_opts=None):
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    model, init_fn = jgpt.make_init(jcfg, None, seq_len=SEQ)
    tx = jflags.wrap_optimizer(
        optax.adamw(jflags.make_lr_schedule(args), weight_decay=0.1), args)
    state, shardings = jtr.create_train_state(
        init_fn, tx, jax.random.PRNGKey(0), mesh)
    params = jax.tree.map(jnp.asarray, tree)
    state = state.replace(params=params, opt_state=tx.init(params))
    step = jtr.make_train_step(jgpt.make_loss(model, **(loss_opts or {})),
                               tx, mesh, shardings, grad_accum=grad_accum,
                               donate=False)
    losses, norms = [], []
    for b in _batches():
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, convert.params_from_flax(
        jax.tree.map(np.asarray, state.params))


def _port_run(tcfg, tree, args, grad_accum, loss_opts=None):
    model = tgpt.GPT(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree))
    tx = optim.wrap_optimizer(
        optim.adamw(optim.make_lr_schedule(args), weight_decay=0.1), args)
    state = ttr.create_train_state(model, tx, 0)
    step = ttr.make_train_step(tgpt.make_loss(model, **(loss_opts or {})),
                               tx, grad_accum=grad_accum)
    losses, norms = [], []
    for b in _batches():
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {k: v.detach() for k, v in model.state_dict().items()}


CASES = {
    "plain": dict(cfg={}, args={}, accum=1),
    "grad_accum2": dict(cfg={}, args={}, accum=2),
    "clip_grad_norm": dict(cfg={}, args={"clip_grad_norm": 0.5}, accum=1),
    "gqa_window": dict(cfg={"kv_heads": 2, "attn_window": 6,
                            "attn_global_every": 2}, args={}, accum=1),
    "flash_attn": dict(cfg={"attn_impl": "flash"}, args={}, accum=1),
    "loss_pallas": dict(cfg={}, args={}, accum=1,
                        loss={"loss_pallas": True}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_steps_match_jax(name):
    case = CASES[name]
    args = _args(**case["args"])
    jkw = {k: v for k, v in case["cfg"].items() if k != "attn_impl"}
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, **jkw)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32, **case["cfg"])
    tree = convert.init_params_flax(tcfg, seed=1)
    want_l, want_n, want_p = _jax_run(jcfg, tree, args, case["accum"],
                                      case.get("loss"))
    got_l, got_n, got_p = _port_run(tcfg, tree, args, case["accum"],
                                    case.get("loss"))
    np.testing.assert_allclose(got_l, want_l, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_n, want_n, atol=ATOL, rtol=0)
    if name == "clip_grad_norm":
        assert min(want_n) > 0.5          # the clip really fired
    assert set(got_p) == set(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_p[k].numpy(), want_p[k].numpy(),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_remat_equals_no_remat():
    args = _args()
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32, dropout=0.1)
    tree = convert.init_params_flax(cfg, seed=2)
    plain = _port_run(cfg, tree, args, 1)
    remat = _port_run(dataclasses.replace(cfg, remat=True), tree, args, 1)
    assert plain[0] == remat[0] and plain[1] == remat[1]
    for k in plain[2]:
        assert torch.equal(plain[2][k], remat[2][k]), k


def test_dropout_masks_follow_the_step_seed():
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32, dropout=0.5)
    model = tgpt.GPT(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(
        convert.init_params_flax(cfg, 0)))
    ids = torch.from_numpy(_batches()[0]["input_ids"])
    a, b = model(ids, dropout_seed=7), model(ids, dropout_seed=7)
    c = model(ids, dropout_seed=8)
    off = model(ids)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, off)


def test_make_eval_matches_jax():
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    tree = convert.init_params_flax(tcfg, seed=4)
    b = _batches()[1]
    model, _ = jgpt.make_init(jcfg, None, seq_len=SEQ)
    want = jax.jit(jgpt.make_eval(model))(jax.tree.map(jnp.asarray, tree),
                                           {}, b)
    tmodel = tgpt.GPT(tcfg, device="cpu")
    tmodel.load_state_dict(convert.params_from_flax(tree))
    state = ttr.create_train_state(tmodel, optim.sgd(0.1), 0)
    got = ttr.make_eval_step(tgpt.make_eval(tmodel))(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("eval_loss", "eval_ppl"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   rtol=1e-6)


@pytest.mark.parametrize("ignore", ["none", "some", "all"])
def test_softmax_cross_entropy_matches_jax(ignore):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    if ignore == "some":
        labels[0, :3] = -100
    elif ignore == "all":
        labels[:] = -100
    idx = None if ignore == "none" else -100
    want = jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels),
                                         ignore_index=idx)
    got = tlosses.softmax_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels),
                                        ignore_index=idx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), atol=1e-6, rtol=1e-6)
    if ignore == "all":
        assert float(got[0]) == 0.0 and float(got[1]) == 1.0


def test_zero_weight_microbatch_is_selected_out():
    """A microbatch of weight 0 whose loss is NaN leaves the mean
    gradient, the loss and the metrics finite."""
    w = torch.zeros(1, requires_grad=True)

    def loss_fn(params, batch, rng):
        x = batch["x"]
        dead = bool((x == 0).all())
        loss = (params["w"] * x).sum() * (float("nan") if dead else 1.0)
        return loss, ttr.LossAux(metrics={"m": loss.detach()},
                                 weight=0.0 if dead else 1.0)

    step = ttr.make_train_step(loss_fn, optim.sgd(0.1), grad_accum=2)
    state = ttr.TrainState(step=0, params={"w": w},
                           opt_state=optim.sgd(0.1).init({"w": w}), rng=0)
    batch = {"x": torch.tensor([[1.0], [0.0]])}
    state, m = step(state, batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["m"])
    assert float(m["grad_norm"]) == pytest.approx(1.0)
    assert float(w.detach()) == pytest.approx(-0.1)


#: the fused / chunked loss options, each against the JAX option of the
#: same name; the chunks leave ragged tails (V 128, N 64)
FUSED_LOSSES = {"loss_pallas": {"loss_pallas": True},
                "loss_chunk_tokens": {"loss_chunk_tokens": 24},
                "loss_chunk": {"loss_chunk": 48}}


def _fused_models(seed):
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    tree = convert.init_params_flax(tcfg, seed=seed)
    jmodel, _ = jgpt.make_init(jcfg, None, seq_len=SEQ)
    tmodel = tgpt.GPT(tcfg, device="cpu")
    tmodel.load_state_dict(convert.params_from_flax(tree))
    return jmodel, tmodel, jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("name", sorted(FUSED_LOSSES))
def test_fused_make_loss_and_eval_match_jax(name):
    """Loss, lm_tokens and every gradient of one make_loss call, then
    make_eval, on the fused / chunked path against JAX's same option."""
    opts = FUSED_LOSSES[name]
    jmodel, tmodel, params = _fused_models(5)
    b = _batches()[2]
    jloss_fn = jgpt.make_loss(jmodel, **opts)
    (want, jaux), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, {}, b, jax.random.PRNGKey(0)),
        has_aux=True)(params)
    jgrads = convert.params_from_flax(jax.tree.map(np.asarray, jgrads))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tparams = dict(tmodel.named_parameters())
    got, aux = tgpt.make_loss(tmodel, **opts)(tparams, tb, 0)
    grads = torch.autograd.grad(got, list(tparams.values()))
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=0)
    assert float(aux.metrics["lm_tokens"]) == float(
        jaux.metrics["lm_tokens"])
    for k, g in zip(tparams, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[k].numpy(), atol=ATOL,
                                   rtol=0, err_msg=k)
    want_eval = jgpt.make_eval(jmodel, **opts)(params, {}, b)
    got_eval = tgpt.make_eval(tmodel, **opts)(tparams, tb)
    np.testing.assert_allclose(float(got_eval["eval_loss"]),
                               float(want_eval["eval_loss"]), atol=ATOL,
                               rtol=0)
    # ppl = exp(loss): a loss within ATOL is a ppl within ATOL relative
    np.testing.assert_allclose(float(got_eval["eval_ppl"]),
                               float(want_eval["eval_ppl"]), rtol=ATOL)


def test_fused_loss_options_are_mutually_exclusive():
    model = tgpt.GPT(tgpt.GPTConfig.tiny(dtype=torch.float32), device="cpu")
    for opts in ({"loss_chunk": 48, "loss_pallas": True},
                 {"loss_chunk_tokens": 8, "loss_chunk": 48},
                 {"loss_chunk_tokens": 8, "loss_pallas": True}):
        with pytest.raises(ValueError, match="mutually exclusive"):
            tgpt.make_loss(model, **opts)
        with pytest.raises(ValueError, match="mutually exclusive"):
            tgpt.make_eval(model, **opts)
