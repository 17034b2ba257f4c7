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

The masked form of B8 (``masked_gather_rows``, one launch for up to two
tables, the cast folded into the store): its plain version on every
shard of 2 and 4, f32 and with the bf16 cast, against JAX's
``masked_lookup_sharded(..., use_kernel=True)`` on a table that is zero
outside that shard (the psum then returns the shard's contribution
alone): values exactly, ids outside the global range included; the
shard's gradient at 1e-6 (f32), or 2^-6 relative with the cast (Queue
C's bf16 tolerance: XLA adds a duplicate id's bf16 cotangents in bf16,
the port in f32 and rounds once; 4 copies of one id differ by 2^-7).
Then the grouped lookup against today's per-table composite
(``masked_lookup`` of the cast table with ``gather_rows``), one and two
tables, with and without the cast, on every shard: outputs and gradients
bit for bit; the shards' outputs sum to ``take``; the CUDA wrappers
refuse CPU tensors.
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


#: ids of the masked-lookup checks: duplicates (one id 4 times), both ends
#: of the table and ids outside the global range [0, 64)
MASKED_IDS = np.asarray([0, 63, 5, 5, 5, 5, 17, 40, -3, 64, 70, 31, 32, 33,
                         48, 15], np.int32)
BF16_GRAD_REL_TOL = 2.0 ** -6


def _bf16_exact(x):
    """``x`` rounded to bf16 and back: a cotangent both packages see alike."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("cast", [False, True])
def test_masked_reference_matches_jax_masked_lookup_every_shard(shards,
                                                                cast):
    dtype = torch.bfloat16 if cast else torch.float32
    jdtype = jnp.bfloat16 if cast else jnp.float32
    mesh = make_mesh(MeshConfig(data=8 // shards, model=shards))
    table, ids = _np(20, 64, 16), MASKED_IDS
    ct = _bf16_exact(_np(21, len(ids), 16))
    n_local = 64 // shards
    ids_s = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P("data")))

    def jfwd(t):
        return jlookup(t.astype(jdtype), ids_s, mesh, use_kernel=True)

    fwd = jax.jit(jfwd)
    grad = jax.jit(jax.grad(lambda t: jnp.sum(
        jfwd(t).astype(jnp.float32) * ct)))
    for k in range(shards):
        rows = slice(k * n_local, (k + 1) * n_local)
        alone = np.zeros_like(table)
        alone[rows] = table[rows]
        alone_s = jax.device_put(jnp.asarray(alone),
                                 NamedSharding(mesh, P("model", None)))
        want = np.asarray(fwd(alone_s).astype(jnp.float32))
        want_g = np.asarray(grad(alone_s))[rows]
        shard = torch.from_numpy(table[rows].copy()).requires_grad_()
        (got,) = teg.masked_gather_rows((shard,), torch.from_numpy(ids), k,
                                        (dtype,))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.detach().float().numpy(), want)
        (got_g,) = torch.autograd.grad(
            (got.float() * torch.from_numpy(ct)).sum(), shard)
        np.testing.assert_allclose(got_g.numpy(), want_g,
                                   rtol=BF16_GRAD_REL_TOL if cast else TOL,
                                   atol=TOL)
        # rows outside the shard (and outside the table) are exactly 0
        outside = (ids < k * n_local) | (ids >= (k + 1) * n_local)
        assert not got.detach()[torch.from_numpy(outside)].any()


def _composite(tables, dtypes, ids, shard):
    """Today's per-table path: each table cast, then masked_lookup with
    the plain-contract gather between the eager mask ops."""
    return tuple(temb.masked_lookup(t.to(d), ids, shard,
                                    gather_fn=teg.gather_rows)
                 for t, d in zip(tables, dtypes))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("cast", [False, True])
@pytest.mark.parametrize("names", [("deep",), ("wide", "deep")])
def test_grouped_lookup_equals_per_table_composite_bitwise(shards, cast,
                                                           names):
    """Wide&Deep's pair of tables (wide [R, 1] f32, deep [R, 16] at f32 or
    bf16) over every shard: the one-launch lookup's outputs and gradients
    equal today's composite bit for bit (the 4 copies of id 5 sum in the
    same order in both backwards)."""
    full = {"wide": _np(22, 64, 1), "deep": _np(23, 64, 16)}
    dtypes = tuple(torch.bfloat16 if (cast and n == "deep")
                   else torch.float32 for n in names)
    ids = torch.from_numpy(MASKED_IDS.reshape(4, 4))
    n_local = 64 // shards
    for k in range(shards):
        got, want = [], []
        for fn in (lambda ts: teg.masked_gather_rows(ts, ids, k, dtypes),
                   lambda ts: _composite(ts, dtypes, ids, k)):
            tables = [torch.from_numpy(full[n][k * n_local:
                                               (k + 1) * n_local].copy())
                      .requires_grad_() for n in names]
            outs = fn(tables)
            cts = [torch.from_numpy(_np(24 + i, *o.shape)).to(o.dtype)
                   for i, o in enumerate(outs)]
            grads = torch.autograd.grad(
                sum((o.float() * c.float()).sum()
                    for o, c in zip(outs, cts)), tables)
            got.append([o.detach() for o in outs])
            want.append(list(grads))
        for (o1, o2), (g1, g2) in zip(zip(*got), zip(*want)):
            assert o1.dtype == o2.dtype and torch.equal(o1, o2)
            assert g1.dtype == g2.dtype == torch.float32
            assert torch.equal(g1, g2)


def test_grouped_lookup_shards_sum_to_take_and_launch_nothing_on_cpu():
    """Over 4 shards the outputs summed equal ``take`` of the cast tables
    (0 for ids outside the table); one shard holding the whole table
    (``group`` None) equals it alone; CPU tensors never reach the
    kernel."""
    wide, deep = _np(25, 64, 1), _np(26, 64, 16)
    ids = torch.from_numpy(MASKED_IDS)
    dtypes = (torch.float32, torch.bfloat16)
    inside = torch.from_numpy((MASKED_IDS >= 0) & (MASKED_IDS < 64))[:, None]
    want = [torch.where(inside, torch.from_numpy(t).to(d)[
        ids.clamp(0, 63).long()], 0) for t, d in zip((wide, deep), dtypes)]
    teg.reset_launch_counts()
    whole = temb.masked_lookup_grouped(
        (torch.from_numpy(wide), torch.from_numpy(deep)), ids, None, dtypes)
    parts = [teg.masked_gather_rows(
        (torch.from_numpy(wide[k * 16:(k + 1) * 16]),
         torch.from_numpy(deep[k * 16:(k + 1) * 16])), ids, k, dtypes)
        for k in range(4)]
    for t, w in enumerate(want):
        assert whole[t].dtype == w.dtype and torch.equal(whole[t], w)
        # a sum of zeros and one row: exact in bf16 too
        assert torch.equal(sum(p[t] for p in parts), w)
    assert teg.launch_counts == {"embed_gather": 0}


def test_cuda_wrappers_refuse_cpu_tensors_and_three_tables():
    table = torch.zeros(8, 4)
    ids = torch.zeros(3, dtype=torch.int32)
    teg.reset_launch_counts()
    with pytest.raises(ValueError, match="one GPU"):
        teg.masked_gather_rows_cuda((table, table), ids, 0)
    with pytest.raises(ValueError, match="one GPU"):
        teg.gather_rows_cuda(table, ids)
    with pytest.raises(ValueError, match="one or two"):
        teg.masked_gather_rows_cuda((table,) * 3, ids, 0)
    with pytest.raises(ValueError, match="out dtypes"):
        teg.masked_gather_rows((table,), ids, 0, (torch.float32,) * 2)
    assert teg.launch_counts == {"embed_gather": 0}
