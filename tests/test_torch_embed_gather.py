"""The port's embedding-row gather (B8's contract) and masked lookup against
the JAX package.

Mirrors ``tests/test_embed_gather.py``: the gather equals ``take`` for ids
of any rank, its gradient scatter-adds duplicate ids, and a table that is
not 2-D is refused. Then the same seeded numpy inputs go through JAX's
``gather_rows(..., interpret=True)`` (the Pallas kernel, interpreted on
the CPU) and ``jax.grad`` of it, and through the port's ``gather_rows``
(its plain version on CPU tensors): values and gradients at 1e-6 (f32;
a gather copies, and the gradient sums the same few cotangents in
another order).

The masked lookup: the port's per-shard ``masked_lookup`` on each of 4
row shards of a [64, 16] table, summed by hand, against JAX's
``masked_lookup_sharded(..., use_kernel=True)`` on the 8-device CPU
simulation (data 2 × model 4), values and gradients at 1e-6; rows a
shard does not own are exactly 0 and get no gradient; and the port's
single-device ``masked_lookup_sharded`` on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dtf_tpu.core.mesh import MeshConfig, make_mesh
from dtf_tpu.ops import embed_gather as jeg
from dtf_tpu.parallel.embedding import masked_lookup_sharded as jlookup
from dtf_tpu_torch.ops import embed_gather as teg
from dtf_tpu_torch.parallel import embedding as temb

TOL = 1e-6


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _grad(fn, table, ct):
    t = torch.from_numpy(table).requires_grad_()
    (fn(t) * torch.from_numpy(ct)).sum().backward()
    return t.grad.numpy()


def test_gather_rows_matches_take():
    table = _np(0, 64, 16)
    ids = np.asarray([0, 5, 63, 5, 17, 2, 2, 40], np.int32)
    got = teg.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), table[ids])


def test_gather_rows_any_rank():
    table = _np(0, 32, 8)
    ids = np.random.default_rng(1).integers(0, 32, (4, 6), np.int32)
    got = teg.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    assert tuple(got.shape) == (4, 6, 8)
    np.testing.assert_array_equal(got.numpy(), table[ids])


def test_gather_rows_grad_scatter_adds_duplicates():
    table, ct = _np(0, 32, 8), _np(1, 4, 8)
    ids = torch.tensor([3, 3, 3, 7], dtype=torch.int32)
    got = _grad(lambda t: teg.gather_rows(t, ids), table, ct)
    want = np.zeros_like(table)
    np.add.at(want, ids.numpy(), ct)
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_gather_rows_rejects_bad_rank():
    with pytest.raises(ValueError, match="expected table"):
        teg.gather_rows(torch.zeros(4), torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("shape", [(8,), (3, 5)])
def test_gather_rows_matches_jax_interpret(shape):
    table = _np(2, 40, 16)
    ids = np.random.default_rng(3).integers(0, 12, shape, np.int32)
    ct = _np(4, *shape, 16)
    want = jeg.gather_rows(jnp.asarray(table), jnp.asarray(ids),
                           interpret=True)
    want_g = jax.grad(lambda t: jnp.sum(jeg.gather_rows(
        t, jnp.asarray(ids), interpret=True) * ct))(jnp.asarray(table))
    tids = torch.from_numpy(ids)
    got = teg.gather_rows(torch.from_numpy(table), tids)
    got_g = _grad(lambda t: teg.gather_rows(t, tids), table, ct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=TOL,
                               atol=TOL)


def test_out_of_range_ids_give_nan_rows_and_no_gradient():
    """Outside the JAX contract [0, R): an id >= R gives a NaN row, as
    ``jnp.take`` fills it; so does a negative id (``jnp.take`` wraps it
    once, the Pallas kernel would read before the table). The backward
    drops those rows' cotangents, as ``.at[ids].add`` drops out-of-range
    updates."""
    table, ct = _np(5, 10, 4), _np(6, 4, 4)
    ids = np.asarray([-1, 3, 10, 3], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    assert np.isnan(want[2]).all()
    tids = torch.from_numpy(ids)
    got = teg.gather_rows(torch.from_numpy(table), tids).numpy()
    assert np.isnan(got[[0, 2]]).all()
    np.testing.assert_array_equal(got[[1, 3]], table[[3, 3]])
    g = _grad(lambda t: teg.gather_rows(t, tids), table, ct)
    want_g = np.zeros_like(table)
    want_g[3] = ct[1] + ct[3]
    np.testing.assert_allclose(g, want_g, rtol=TOL)


def _sharded_inputs():
    table = _np(7, 64, 16)
    ids = np.random.default_rng(8).integers(0, 64, (8,), np.int32)
    return table, ids, _np(9, 8, 16)


def _port_shards_summed(t, ids, shards=4):
    n_local = t.shape[0] // shards
    return sum(temb.masked_lookup(t[s * n_local:(s + 1) * n_local], ids, s,
                                  gather_fn=teg.gather_rows)
               for s in range(shards))


def test_masked_lookup_shards_match_jax_sharded_kernel():
    mesh = make_mesh(MeshConfig(data=2, model=4))
    table, ids, ct = _sharded_inputs()
    table_s = jax.device_put(jnp.asarray(table),
                             NamedSharding(mesh, P("model", None)))
    ids_s = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P("data")))

    def f(t):
        return jnp.sum(jlookup(t, ids_s, mesh, use_kernel=True) * ct)

    want = jax.jit(lambda t: jlookup(t, ids_s, mesh, use_kernel=True))(
        table_s)
    want_g = jax.jit(jax.grad(f))(table_s)
    tids = torch.from_numpy(ids)
    got = _port_shards_summed(torch.from_numpy(table), tids)
    got_g = _grad(lambda t: _port_shards_summed(t, tids), table, ct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=TOL,
                               atol=TOL)


def test_masked_lookup_rows_outside_the_shard_are_zero_without_gradient():
    table = _np(10, 16, 4)
    ids = torch.tensor([0, 3, 4, 7, 8, 15], dtype=torch.int32)
    t = torch.from_numpy(table[4:8]).requires_grad_()       # shard 1 of 4
    out = temb.masked_lookup(t, ids, 1, gather_fn=teg.gather_rows)
    outside = torch.tensor([True, True, False, False, True, True])
    assert torch.count_nonzero(out[outside]).item() == 0
    np.testing.assert_array_equal(out[~outside].detach().numpy(),
                                  table[[4, 7]])
    out.sum().backward()
    # the out-of-range ids clip to the shard's rows 0 and 3, which get
    # only the in-range ids' gradient
    np.testing.assert_array_equal(t.grad.numpy(),
                                  np.asarray([[1] * 4, [0] * 4, [0] * 4,
                                              [1] * 4], np.float32))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_masked_lookup_sharded_on_one_device(use_kernel):
    table, ids, _ = _sharded_inputs()
    teg.reset_launch_counts()
    got = temb.masked_lookup_sharded(torch.from_numpy(table),
                                     torch.from_numpy(ids.reshape(2, 4)),
                                     use_kernel=use_kernel)
    np.testing.assert_array_equal(got.numpy(), table[ids.reshape(2, 4)])
    # CPU tensors run the plain version: the kernel never launched
    assert teg.launch_counts == {"embed_gather": 0}
