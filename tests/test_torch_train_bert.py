"""The port's BERT train step and launcher against the JAX package's.

Three train steps of ``BertConfig.tiny`` at f32 (dense attention on both
sides, batch 4 of 16 tokens, one row's tail padded) through
``core.train.make_train_step`` with the launcher's recipe (AdamW, weight
decay 0.01, cosine with warmup) against ``dtf_tpu.core.train
.make_train_step`` on a one-device mesh, at ``grad_accum`` 1 and 2 and
with ``--mlm_gather`` covering every row: the losses within ``F32_TOL``
each step, ``grad_norm`` within ``NORM_TOL`` and every parameter within
``F32_TOL`` after. Then ``python -m dtf_tpu_torch.train_bert
--device=cpu --size=tiny``: 2 steps, a relaunch that resumes to 3, equal
bit for bit to a straight 3-step run, with the held-out eval; the flags
that are not ported raise and the reference's usage errors exit 2.
"""

import argparse

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
from dtf_tpu.models import bert as jbert
from dtf_tpu_torch import convert, optim, train_bert
from dtf_tpu_torch.core import train as ttr
from dtf_tpu_torch.models import bert as tbert

F32_TOL = 1e-5
#: the reference step's grad_norm metric (``jnp.vdot`` a leaf under
#: XLA:CPU) is itself ~1.2e-4 off the norm of its ``jax.value_and_grad``
#: gradient on these batches; the port's is within 1e-7 of that norm
NORM_TOL = 2e-4
#: the key projection's bias: an analytic gradient of 0 (the softmax
#: ignores a per-query shift) whose rounding noise AdamW scales into
#: lr-sized steps; it moves nothing else, so it is not compared
NOISE_LEAF = "attention.key.bias"
STEPS, BATCH, SEQ = 3, 4, 16


def _args():
    return argparse.Namespace(
        learning_rate=1e-2, lr_schedule="cosine", warmup_steps=-1,
        lr_min_ratio=0.0, train_steps=10, optimizer="", weight_decay=-1.0,
        clip_grad_norm=0.0)


def _batches():
    data = SyntheticData("bert", BATCH, seed=4, seq_len=SEQ, vocab_size=128)
    out = []
    for i in range(STEPS):
        b = data.batch(i)
        b["attention_mask"][2, 9:] = 0
        out.append(b)
    return out


def _jax_run(tree, accum, loss_opts):
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    model, init_fn = jbert.make_init(jbert.BertConfig.tiny(
        dtype=jnp.float32), seq_len=SEQ)
    args = _args()
    tx = jflags.make_optimizer(args, lambda s: optax.adamw(
        s, weight_decay=0.01), recipe_uses_wd=True)
    state, shardings = jtr.create_train_state(
        init_fn, tx, jax.random.PRNGKey(0), mesh,
        param_rules=jbert.tp_rules, zero1=True)
    params = jax.tree.map(jnp.asarray, tree)
    state = jax.device_put(
        state.replace(params=params, opt_state=tx.init(params)), shardings)
    step = jtr.make_train_step(jbert.make_loss(model, **loss_opts), tx,
                               mesh, shardings, grad_accum=accum,
                               donate=False)
    losses, norms = [], []
    for b in _batches():
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, convert.params_from_flax(
        jax.tree.map(np.asarray, state.params))


def _port_run(tree, accum, loss_opts):
    model = tbert.BertMLM(tbert.BertConfig.tiny(dtype=torch.float32),
                          device="cpu")
    model.load_state_dict(convert.params_from_flax(tree))
    tx = optim.make_optimizer(_args(), lambda s: optim.adamw(
        s, weight_decay=0.01), recipe_uses_wd=True)
    state = ttr.create_train_state(model, tx, 0)
    step = ttr.make_train_step(tbert.make_loss(model, **loss_opts), tx,
                               grad_accum=accum)
    losses, norms = [], []
    for b in _batches():
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, dict(model.state_dict())


@pytest.mark.parametrize("accum,loss_opts", [
    (1, {}), (2, {}), (2, {"mlm_gather": SEQ, "loss_chunk": 48})],
    ids=["accum1", "accum2", "accum2_gather_chunk"])
def test_train_steps_match_jax(accum, loss_opts):
    tree = convert.init_params_bert(tbert.BertMLM(
        tbert.BertConfig.tiny(dtype=torch.float32), device="meta"), 3)
    want = _jax_run(tree, accum, loss_opts)
    got = _port_run(tree, accum, loss_opts)
    np.testing.assert_allclose(got[0], want[0], rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=NORM_TOL)
    assert set(got[2]) == set(want[2])
    for k, v in want[2].items():
        if not k.endswith(NOISE_LEAF):
            np.testing.assert_allclose(got[2][k].numpy(), v.numpy(),
                                       rtol=F32_TOL, atol=F32_TOL, err_msg=k)


def _cli(logdir, steps, *extra):
    return ["--device=cpu", "--size=tiny", "--batch_size=8", "--seq_len=32",
            f"--train_steps={steps}", "--log_every=1",
            "--checkpoint_every=2", f"--logdir={logdir}", *extra]


def test_launcher_runs_resumes_and_equals_a_straight_run(tmp_path, capsys):
    assert train_bert.main(_cli(tmp_path / "a", 2, "--grad_accum=2")) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "done: step=2"
    state, writer = train_bert.run(_cli(tmp_path / "a", 3, "--grad_accum=2"))
    resumed = [s for s, m in writer.history if "loss" in m]
    assert state.step == 3 and resumed == [3]
    evals = [m for _, m in writer.history if "eval_mlm_loss" in m]
    assert len(evals) == 1 and np.isfinite(evals[0]["eval_mlm_ppl"])
    straight, _ = train_bert.run(_cli(tmp_path / "b", 3, "--grad_accum=2"))
    assert set(state.params) == set(straight.params)
    for k in straight.params:
        assert torch.equal(state.params[k], straight.params[k]), k


@pytest.mark.parametrize("flag", ["--mesh_model=2", "--mesh_seq=2",
                                  "--telemetry", "--profile_steps=3"])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train_bert.run(_cli(tmp_path, 1, flag))


@pytest.mark.parametrize("flags", [
    ["--mesh_model=2", "--mlm_gather=8"],
    ["--mesh_model=2", "--loss_chunk_vocab=64"],
    ["--mesh_seq=2", "--mlm_gather=8"], ["--size=large"]])
def test_usage_errors_exit_2(tmp_path, flags):
    with pytest.raises(SystemExit) as e:
        train_bert.run(_cli(tmp_path, 1, *flags))
    assert e.value.code == 2
