"""The port's ResNet train step and launcher against the JAX package's.

Three train steps of a tiny f32 ResNet (``test_torch_resnet``'s models,
batch 4 of 16×16 images) through ``core.train.make_train_step`` with the
launcher's recipe — nesterov SGD 0.1, momentum 0.9, a loss-side L2 —
against ``dtf_tpu.core.train.make_train_step`` on a one-device mesh,
with ``grad_accum`` 1 and 2 (the BatchNorm statistics chained over the
microbatches in order): the losses and ``grad_norm`` each step, then
every parameter and running statistic, within ``F32_TOL``. Then
``python -m dtf_tpu_torch.train_resnet --device=cpu``: 2 steps, a
relaunch that resumes to 3, equal bit for bit to a straight 3-step run
(the BatchNorm statistics come back from the checkpoint); a checkpoint
refuses a target whose buffers differ; the unported flags raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_multirank_worker as worker
from dtf_tpu.core import train as jtr
from dtf_tpu.core.mesh import MeshConfig, make_mesh
from dtf_tpu.models import resnet as jresnet
from dtf_tpu_torch import convert, optim, train_resnet
from dtf_tpu_torch.checkpoint import Checkpointer
from dtf_tpu_torch.core import train as ttr
from dtf_tpu_torch.models import resnet as tresnet
from test_torch_resnet import batch, jax_model

F32_TOL = 1e-5
STEPS = 3
#: at 8×8 the ImageNet stem leaves 1×1 pixels to the last stage, whose
#: BatchNorm then normalizes over 4 values a channel (2 under grad_accum
#: 2): three SGD steps carry f32 rounding past 1e-5 there (one element
#: of BottleneckBlock_0.Conv_1 at 1.6e-5). At 16×16 it sees 16 (8).
SIZE = 16
WEIGHT_DECAY = 1e-2
#: (stem, block) of the step cases
STEP_CASES = [("cifar", "BasicBlock"), ("imagenet", "BottleneckBlock")]


def _jax_run(stem, block, tree, accum):
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jmodel = jax_model(stem, block)
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    state, shardings = jtr.create_train_state(
        jresnet.make_init(jmodel, (SIZE, SIZE, 3)), tx, jax.random.PRNGKey(0),
        mesh)
    params = jax.tree.map(jnp.asarray, tree["params"])
    state = state.replace(
        params=params, opt_state=tx.init(params),
        extra={"batch_stats": jax.tree.map(jnp.asarray,
                                           tree["batch_stats"])})
    step = jtr.make_train_step(
        jresnet.make_loss(jmodel, weight_decay=WEIGHT_DECAY), tx, mesh,
        shardings, grad_accum=accum, donate=False)
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, batch(SIZE, seed=10 + i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    whole = {**convert.params_from_flax(jax.tree.map(np.asarray,
                                                     state.params)),
             **convert.stats_from_flax(jax.tree.map(
                 np.asarray, state.extra["batch_stats"]))}
    return losses, norms, whole


def _port_run(stem, block, tree, accum):
    model = worker.resnet_tiny(stem, block)
    worker.load_resnet(model, tree)
    tx = optim.sgd(0.1, momentum=0.9, nesterov=True)
    state = ttr.create_train_state(model, tx, 0)
    assert set(state.extra) == {n for n, _ in model.named_buffers()}
    step = ttr.make_train_step(
        tresnet.make_loss(model, weight_decay=WEIGHT_DECAY), tx,
        grad_accum=accum, model=model)
    model.eval()                       # the step puts it in train mode
    losses, norms = [], []
    for i in range(STEPS):
        b = batch(SIZE, seed=10 + i)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, dict(model.state_dict())


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("stem,block", STEP_CASES)
def test_train_steps_match_jax(stem, block, accum):
    tree = worker.resnet_vars(worker.resnet_tiny(stem, block), seed=5)
    want = _jax_run(stem, block, tree, accum)
    got = _port_run(stem, block, tree, accum)
    np.testing.assert_allclose(got[0], want[0], rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=F32_TOL, atol=F32_TOL)
    assert set(got[2]) == set(want[2])
    for k, v in want[2].items():
        np.testing.assert_allclose(got[2][k].numpy(), v.numpy(),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)


def _cli(logdir, steps, *extra):
    return ["--device=cpu", "--config=cifar", "--batch_size=8",
            f"--train_steps={steps}", "--log_every=1",
            "--checkpoint_every=2", f"--logdir={logdir}", *extra]


def test_launcher_runs_resumes_and_equals_a_straight_run(tmp_path, capsys):
    assert train_resnet.main(_cli(tmp_path / "a", 2)) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "done: step=2"
    assert (tmp_path / "a" / "ckpt" / "2" / "extra.pt").exists()
    state, writer = train_resnet.run(_cli(tmp_path / "a", 3))
    resumed = [s for s, m in writer.history if "loss" in m]
    assert state.step == 3 and resumed == [3]
    assert any("eval_accuracy" in m for _, m in writer.history)
    straight, _ = train_resnet.run(_cli(tmp_path / "b", 3))
    for got, want in ((state.params, straight.params),
                      (state.extra, straight.extra)):
        assert set(got) == set(want) and got
        for k in want:
            assert torch.equal(got[k], want[k]), k
    # the statistics moved from their init
    assert not torch.equal(state.extra["stem_bn.var"],
                           torch.ones_like(state.extra["stem_bn.var"]))


def test_checkpoint_refuses_other_buffers(tmp_path):
    model = worker.resnet_tiny("cifar", "BasicBlock")
    tx = optim.sgd(0.1)
    state = ttr.create_train_state(model, tx, 0)
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, state)
    other = ttr.create_train_state(model, tx, 0)
    other.extra = {k: v for k, v in other.extra.items()
                   if not k.startswith("stem_bn")}
    with pytest.raises(KeyError, match="buffers"):
        ckpt.restore(other)
    with torch.no_grad():
        state.extra["stem_bn.mean"].fill_(3.0)
    restored = ckpt.restore(state)
    assert float(restored.extra["stem_bn.mean"].abs().max()) == 0.0


@pytest.mark.parametrize("flag", ["--mesh_model=2", "--telemetry",
                                  "--profile_steps=3"])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train_resnet.run(_cli(tmp_path, 1, flag))
