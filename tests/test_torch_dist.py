"""The port's cluster, mesh and placement pieces against the JAX package.

- the cluster-flag collapse (``core/dist.collapse_cluster_flags``) field
  for field against ``dtf_tpu.core.dist``'s, on the cases of
  ``tests/test_dist.py``;
- ``MeshConfig.resolve`` and ``HostView.batch_rows`` against
  ``dtf_tpu.core.mesh``'s;
- the ZeRO-1 leaf rule (``core/sharding.make_layout``) against
  ``dtf_tpu.core.sharding._zero1_leaf_spec`` on the GPT tiny tree and on
  Wide&Deep's with its tables on the model axis: the same elements per
  rank, the dim mapped through the port's transposed kernels;
- the launcher's refusals (unported axes, a mesh of one process);
- a world of ONE over gloo in this process: the step still runs its
  collectives, equal to the step with no group within ``F32_TOL``
  (``(n·g)/n`` is not bitwise ``g`` in f32); and a save and restore
  through the collective checkpointer, exactly.
"""

import argparse
import contextlib

import jax
import numpy as np
import pytest
import torch

from dtf_tpu.core import dist as jdist
from dtf_tpu.core import mesh as jmesh
from dtf_tpu.core import sharding as jshd
from dtf_tpu.models import widedeep as jwd
from dtf_tpu_torch import convert, optim
from dtf_tpu_torch.checkpoint import Checkpointer
from dtf_tpu_torch.cli import launch
from dtf_tpu_torch.core import dist as tdist
from dtf_tpu_torch.core import mesh as tmesh
from dtf_tpu_torch.core import sharding as tshd
from dtf_tpu_torch.core import train as ttr
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.models import widedeep as twd

F32_TOL = 1e-5

CLUSTERS = {
    "single": {},
    "worker_collapse": dict(ps_hosts=["p0:2222"],
                            worker_hosts=["w0:2223", "w1:2224"],
                            job_name="worker", task_index=1),
    "chief": dict(worker_hosts=["w0", "w1"], task_index=0),
    "ps": dict(ps_hosts=["p0", "p1"], worker_hosts=["w0"], job_name="ps",
               task_index=1),
    "ps_index_out_of_range": dict(ps_hosts=["p0"], worker_hosts=["w0"],
                                  job_name="ps", task_index=5),
    "worker_index_out_of_range": dict(worker_hosts=["w0"], task_index=3),
}


@pytest.mark.parametrize("case", sorted(CLUSTERS))
def test_cluster_collapse_matches_jax(case):
    kw = CLUSTERS[case]
    try:
        want = jdist.collapse_cluster_flags(**kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" for ")[-1]):
            tdist.collapse_cluster_flags(**kw)
        return
    got = tdist.collapse_cluster_flags(**kw)
    for f in ("num_processes", "process_id", "is_chief", "should_exit",
              "coordinator_address", "host_count", "participates_in_save"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.local_host_ids() == want.local_host_ids()


MESHES = [((), 8), (dict(seq=2, model=2), 8), (dict(data=4, model=2), 8),
          (dict(pipe=4), 8), (dict(model=2), 2), ((), 1),
          (dict(data=3), 8), (dict(model=0), 8), (dict(pipe=16), 8)]


@pytest.mark.parametrize("kw,n", MESHES)
def test_mesh_config_resolve_matches_jax(kw, n):
    kw = dict(kw)
    try:
        want = jmesh.MeshConfig(**kw).resolve(n)
    except ValueError:
        with pytest.raises(ValueError):
            tmesh.MeshConfig(**kw).resolve(n)
        return
    assert tmesh.MeshConfig(**kw).resolve(n) == want
    assert tmesh.AXES == jmesh.AXES


@pytest.mark.parametrize("k,n,rows", [(0, 1, 8), (1, 2, 8), (3, 4, 12),
                                      (1, 2, 7), (2, 2, 8), (0, 0, 8)])
def test_host_view_matches_jax(k, n, rows):
    try:
        want = jmesh.HostView(k, n).batch_rows(rows)
    except ValueError:
        with pytest.raises(ValueError):
            tmesh.HostView(k, n).batch_rows(rows)
        return
    assert tmesh.HostView(k, n).batch_rows(rows) == want


def _fake_mesh(data, model):
    """The sizes a layout reads (its groups are never used here)."""
    return tmesh.Mesh(data_size=data, model_size=model, data_index=0,
                      model_index=0, data_group=None, model_group=None,
                      device=torch.device("cpu"))


def _jax_zero1_dims(tree, rules, data):
    """{state_dict name: the torch dim JAX shards over data, or None}."""
    specs = jshd.tree_specs(tree, rules)
    out = {}
    flat = jax.tree_util.tree_leaves_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(flat, spec_leaves):
        shape = tuple(np.shape(leaf))
        z = jshd._zero1_leaf_spec(spec, shape, data, "data",
                                  param_shape=shape)
        dim = list(z).index("data") if "data" in tuple(z) else None
        keys = [p.key for p in path]
        name = next(iter(convert.params_from_flax(
            convert._unflatten([(tuple(keys), np.zeros(shape))]))))
        if dim is not None:                     # flax dim → the port's
            dim = convert.flax_dims(name, len(shape))[dim]
        out[name] = dim
    return out


@pytest.mark.parametrize("model,data,model_size", [
    ("gpt", 2, 1), ("gpt", 4, 1), ("gpt", 3, 1), ("widedeep", 2, 1),
    ("widedeep", 4, 1), ("widedeep", 2, 2), ("widedeep", 3, 1),
    ("resnet", 2, 1), ("resnet", 4, 1)])
def test_zero1_leaf_rule_matches_jax(model, data, model_size):
    """Data 3 divides no dim of the GPT or Wide&Deep tree: all replicated.
    ResNet-20's convolution kernels ([kh, kw, in, out] in flax, [out, in,
    kh, kw] in the port) split where JAX splits them."""
    if model == "gpt":
        cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
        tree = convert.init_params_flax(cfg, 0)
        rules_j, rules_t = (), ()
    elif model == "resnet":
        from dtf_tpu_torch.models import resnet as trn

        tree = convert.init_params_resnet(trn.resnet20(device="cpu"),
                                          0)["params"]
        rules_j, rules_t = (), ()
    else:
        small = twd.WideDeep(hash_buckets=64, embed_dim=8, mlp=(32, 16),
                             device="cpu")
        tree = convert.init_params_widedeep(small, 0)
        rules_j, rules_t = jwd.rules, twd.rules
    want = _jax_zero1_dims(tree, rules_j, data)
    local = {}
    specs = tshd.param_specs(convert.params_from_flax(tree), rules_t)
    for n, t in convert.params_from_flax(tree).items():
        shape = list(t.shape)
        if "model" in specs[n]:
            shape[specs[n].index("model")] //= model_size
        local[n] = torch.empty(shape)
    layout = tshd.make_layout(local, _fake_mesh(data, model_size), rules_t,
                              zero1=True)
    got = {n: layout.zero1_dims.get(n) for n in local}
    assert got == want
    assert any(d is not None for d in got.values()) == (data != 3)
    if model == "widedeep" and model_size > 1:
        assert layout.model_dims == {"embed_tables_wide.weight": 0,
                                     "embed_tables_deep.weight": 0}
    assert not tshd.make_layout(local, _fake_mesh(data, model_size),
                                rules_t).zero1_dims


def _launch_args(**kw):
    base = dict(ps_hosts="", worker_hosts="", job_name="worker",
                task_index=0, issync=True, backend="cpu", device="cpu",
                devices_per_host=0, mesh_data=-1, mesh_seq=1, mesh_model=1,
                mesh_pipe=1, mesh_expert=1)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw,err,match", [
    (dict(mesh_seq=2), NotImplementedError, "not yet ported"),
    (dict(mesh_pipe=2), NotImplementedError, "not yet ported"),
    (dict(mesh_expert=2), NotImplementedError, "not yet ported"),
    (dict(devices_per_host=2), NotImplementedError, "not yet ported"),
    (dict(mesh_data=2), ValueError, "one process per device"),
    (dict(mesh_model=2), ValueError, "one process per device")])
def test_setup_refuses(kw, err, match):
    with pytest.raises(err, match=match):
        launch.setup(_launch_args(**kw))


def test_setup_without_a_group_is_one_process():
    device, info, mesh = launch.setup(_launch_args())
    assert device == torch.device("cpu") and mesh is None
    assert info.num_processes == 1 and info.is_chief


@contextlib.contextmanager
def _world_of_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _gpt_run(mesh, steps=3, ckpt=None):
    cfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    model = tgpt.GPT(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(
        convert.init_params_flax(cfg, 1)))
    tx = optim.adamw(1e-2, weight_decay=0.1)
    layout = (tshd.make_layout(dict(model.named_parameters()), mesh,
                               zero1=True) if mesh else None)
    state = ttr.create_train_state(model, tx, 0, mesh=mesh, layout=layout)
    step = ttr.make_train_step(tgpt.make_loss(model, loss_pallas=True,
                                              mesh=mesh), tx, mesh=mesh)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        ids = torch.from_numpy(rng.integers(0, 128, (2, 8)).astype(np.int32))
        state, m = step(state, {"input_ids": ids, "labels": ids})
        losses.append(float(m["loss"]))
    if ckpt is not None:
        ckpt.save(state.step, state)
    return state, losses


def test_world_of_one_runs_the_collectives(tmp_path):
    _, want = _gpt_run(None)
    with _world_of_one(tmp_path):
        _, info, mesh = launch.setup(_launch_args())
        assert mesh is not None and info.is_chief
        assert (mesh.data_size, mesh.model_size) == (1, 1)
        ckpt = Checkpointer(tmp_path / "ckpt", mesh=mesh)
        state, got = _gpt_run(mesh, ckpt=ckpt)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        # the collective save and restore round-trip exactly
        target, _ = _gpt_run(mesh, steps=0)
        back = ckpt.restore(target)
        assert back.step == 3
        for n, p in state.params.items():
            assert torch.equal(back.params[n], p), n
        mu, mu_back = state.opt_state[0]["mu"], back.opt_state[0]["mu"]
        for n in mu:
            assert torch.equal(mu[n], mu_back[n]), n


def test_two_nccl_ranks_on_one_device_are_refused_before_nccl():
    """NCCL needs a GPU a rank (this box has none): a clear error before
    init_process_group; gloo takes any number of ranks."""
    with pytest.raises(RuntimeError, match="one GPU per rank"):
        tdist.check_nccl_devices("nccl", 2)
    tdist.check_nccl_devices("gloo", 2)
    assert tdist.rank_device(3, "cpu") == torch.device("cpu")
