"""Weights across the packages: the flax GPT param tree <-> the port.

The round trip is bit-exact, every flax leaf lands on a port parameter of
the right shape (kernels transposed to torch's [out, in]), and the
``.npz`` file keeps the flat ``/``-joined keys either package can read.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.models import gpt as jgpt
from dtf_tpu_torch import convert
from dtf_tpu_torch.models import gpt as tgpt


def _tree(**kw):
    """A seeded tree with every leaf distinct (jittered init_params)."""
    tree = convert.init_params(tgpt.GPTConfig.tiny(**kw), seed=0)
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: a + rng.normal(0, 0.1, a.shape).astype(np.float32), tree)


def _jax_shapes(**kw):
    """The JAX model's param tree, abstractly (shapes and dtypes only)."""
    cfg = jgpt.GPTConfig.tiny(dtype=jnp.float32, **kw)
    return jax.eval_shape(lambda: jgpt.GPT(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))["params"]


def _leaves(tree):
    return dict(convert._flatten(tree))


@pytest.mark.parametrize("kw", [{}, {"kv_heads": 2}])
def test_round_trip_is_bit_exact(kw):
    tree = _tree(**kw)
    back = convert.params_to_flax(convert.params_from_flax(tree))
    a, b = _leaves(tree), _leaves(back)
    assert sorted(a) == sorted(b)
    for path, val in a.items():
        assert b[path].dtype == np.float32
        np.testing.assert_array_equal(b[path], val)


@pytest.mark.parametrize("kw", [{}, {"kv_heads": 2}])
def test_flax_tree_loads_into_the_port_module(kw):
    tree = _tree(**kw)
    sd = convert.params_from_flax({"params": tree})    # wrapped form too
    model = tgpt.GPT(tgpt.GPTConfig.tiny(dtype=torch.float32, **kw),
                     device="cpu")
    model.load_state_dict(sd)                          # strict: all keys
    np.testing.assert_array_equal(
        model.layer_0.attention.query.weight.detach().numpy(),
        tree["layer_0"]["attention"]["query"]["kernel"].T)
    np.testing.assert_array_equal(
        model.lm_head.weight.detach().numpy(), tree["lm_head"]["kernel"].T)
    np.testing.assert_array_equal(
        model.ln_f.weight.detach().numpy(), tree["ln_f"]["scale"])
    np.testing.assert_array_equal(
        model.token_embed.weight.detach().numpy(),
        tree["token_embed"]["embedding"])
    # and back out of the module, bit-exact
    back = _leaves(convert.params_to_flax(model.state_dict()))
    for path, val in _leaves(tree).items():
        np.testing.assert_array_equal(back[path], val)


@pytest.mark.parametrize("kw", [{}, {"kv_heads": 2}])
def test_init_params_has_the_jax_tree_structure(kw):
    cfg = tgpt.GPTConfig.tiny(**kw)
    mine = _leaves(convert.init_params(cfg, seed=3))
    theirs = _leaves(_jax_shapes(**kw))
    assert sorted(mine) == sorted(theirs)
    for path in theirs:
        assert mine[path].shape == theirs[path].shape, path
        assert mine[path].dtype == np.float32
    again = _leaves(convert.init_params(cfg, seed=3))
    for path in mine:
        np.testing.assert_array_equal(again[path], mine[path])
    other = convert.init_params(cfg, seed=4)
    assert not np.array_equal(other["lm_head"]["kernel"],
                              mine[("lm_head", "kernel")])


def test_npz_save_load(tmp_path):
    tree = _tree()
    path = str(tmp_path / "params.npz")
    convert.save_npz(path, tree)
    with np.load(path) as z:
        assert "layer_1/attention/attn_out/kernel" in z.files
        assert "token_embed/embedding" in z.files
    back = convert.load_npz(path)
    a, b = _leaves(tree), _leaves(back)
    assert sorted(a) == sorted(b)
    for p in a:
        np.testing.assert_array_equal(b[p], a[p])


def test_unknown_leaves_raise():
    with pytest.raises(KeyError, match="unknown flax param leaf"):
        convert.params_from_flax({"blk": {"mystery": np.zeros(3)}})
    with pytest.raises(ValueError, match="2-D kernel"):
        convert.params_from_flax({"blk": {"kernel": np.zeros((2, 2, 2))}})
