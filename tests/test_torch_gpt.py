"""The port's GPT (dtf_tpu_torch.models.gpt) against the JAX model.

Both packages get the same seeded numpy weights (carried into the port by
``convert.params_from_flax``) and the same token ids, at
``GPTConfig.tiny`` in float32 on the CPU. Full-sequence logits agree to
1e-5; greedy ``generate`` streams are identical token for token.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.models import gpt as jgpt
from dtf_tpu_torch import convert
from dtf_tpu_torch.models import gpt as tgpt
from dtf_tpu_torch.ops import flash_attention as tfa


def _tree(cfg, seed):
    """init_params with every leaf jittered, so biases and LayerNorm
    affines are not the trivial 0 / 1."""
    tree = convert.init_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), tree)


def _pair(**kw):
    """(JAX config, port config) of the same tiny f32 model."""
    return (jgpt.GPTConfig.tiny(dtype=jnp.float32, **kw),
            tgpt.GPTConfig.tiny(dtype=torch.float32, **kw))


def _port(tcfg, tree):
    model = tgpt.GPT(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree))
    return model.eval()


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kw", [{}, {"kv_heads": 2, "attn_window": 5,
                                     "attn_global_every": 2}])
def test_full_sequence_logits_match_jax(impl, kw):
    jcfg, tcfg = _pair(attn_impl=impl, **kw)
    tree = _tree(tcfg, 0)
    ids = np.random.default_rng(3).integers(0, 128, (2, 19))
    want = jgpt.GPT(jcfg).apply({"params": tree}, jnp.asarray(ids))
    tfa.reset_launch_counts()
    with torch.no_grad():
        got = _port(tcfg, tree)(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # on CPU tensors the flash path is the plain reference, never a launch
    assert sum(tfa.launch_counts.values()) == 0


def test_bf16_forward_runs_in_bf16():
    _, tcfg = _pair()
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (1, 8)))
    with torch.no_grad():
        model = _port(tcfg, _tree(tcfg, 0))
        hidden = model(ids, return_hidden=True)
        logits = model(ids)
    assert hidden.dtype == torch.float32 and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("shape,positions", [
    ((2, 3, 5, 8), np.arange(5)),
    ((2, 3, 1, 8), np.array([37])),
    ((2, 3, 4, 8), np.array([[0, 1, 2, 3], [9, 10, 11, 12]])),
])
def test_rope_matches_jax(shape, positions):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jgpt.rope(jnp.asarray(x), jnp.asarray(positions), 10000.0)
    got = tgpt.rope(torch.from_numpy(x), torch.from_numpy(positions),
                    10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.7),
                                         (4, 0.8), (50, 0.5)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(2).standard_normal(
        (3, 40)).astype(np.float32)
    logits[0, [4, 9, 17, 30]] = 2.5       # a 4-way tie at the top
    logits[1, [1, 2]] = -7.0
    want = jgpt.filter_logits(jnp.asarray(logits), top_k=top_k, top_p=top_p)
    got = tgpt.filter_logits(torch.from_numpy(logits), top_k=top_k,
                             top_p=top_p)
    np.testing.assert_array_equal(np.isneginf(got.numpy()),
                                  np.isneginf(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_filter_logits_tie_keeps_lowest_index():
    logits = torch.tensor([[0.0, 1.0, 1.0, 1.0, -1.0]])
    got = tgpt.filter_logits(logits, top_k=2)
    assert torch.isfinite(got[0]).tolist() == [False, True, True, False,
                                               False]


def _generate_pair(prompt_len=7, n_new=6, gen_kw=None, **cfg_kw):
    gen_kw = gen_kw or {}
    total = prompt_len + n_new
    jcfg, tcfg = _pair(decode_len=total, **cfg_kw)
    tree = _tree(tcfg, 4)
    prompt = np.random.default_rng(5).integers(0, 128, (2, prompt_len))
    want = jgpt.generate(jgpt.GPT(jcfg), tree,
                         jnp.asarray(prompt, jnp.int32), n_new, **gen_kw)
    got = tgpt.generate(_port(tcfg, tree), torch.from_numpy(prompt), n_new,
                        **gen_kw)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("cfg_kw,gen_kw", [
    ({}, {}),                                                     # MHA
    ({"kv_heads": 2}, {}),                                        # GQA
    ({"attn_window": 3, "attn_global_every": 2}, {}),   # wraps mid-prompt
    ({"kv_cache_dtype": "int8"}, {}),
    # two equal chunks (one set of shapes for JAX to compile); the second
    # wraps the 4-slot rolling buffer
    ({"attn_window": 4, "kv_heads": 2, "prompt_len": 8, "n_new": 5},
     {"prefill_chunk": 4}),
], ids=["mha", "gqa", "window_wrap", "int8", "prefill_chunk"])
def test_greedy_generate_matches_jax(cfg_kw, gen_kw):
    want, got = _generate_pair(gen_kw=gen_kw, **cfg_kw)
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got, want)


def test_greedy_generate_eos_pad_matches_jax():
    _, tcfg = _pair(decode_len=13)
    prompt = np.random.default_rng(5).integers(0, 128, (2, 7))
    plain = tgpt.generate(_port(tcfg, _tree(tcfg, 4)),
                          torch.from_numpy(prompt), 6)
    eos = int(plain[0, 8])                 # row 0's second new token
    want, got = _generate_pair(gen_kw={"eos_id": eos, "pad_id": 127})
    np.testing.assert_array_equal(got, want)
    row = got[0, 7:].tolist()
    stop = row.index(eos)
    assert row[stop + 1:] == [127] * (len(row) - stop - 1)


def test_flash_generate_equals_dense_generate_on_cpu():
    _, tcfg = _pair(decode_len=14, attn_window=3, attn_global_every=2)
    tree = _tree(tcfg, 6)
    prompt = torch.from_numpy(
        np.random.default_rng(7).integers(0, 128, (2, 8)))
    outs = [tgpt.generate(_port(dataclasses.replace(tcfg, attn_impl=impl),
                                tree), prompt, 6)
            for impl in ("dense", "flash")]
    assert torch.equal(outs[0], outs[1])


def test_sampled_generate_is_deterministic_per_generator_seed():
    _, tcfg = _pair(decode_len=16)
    model = _port(tcfg, _tree(tcfg, 8))
    prompt = torch.tensor([[1, 2, 3, 4]])

    def run(seed):
        return tgpt.generate(model, prompt, 12, seed=seed,
                             temperature=0.8, top_k=20, top_p=0.9)

    a, b = run(11), run(11)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < 128)).all()
    assert any(not torch.equal(a, run(s)) for s in range(12, 16))


def test_generate_argument_checks():
    _, tcfg = _pair(decode_len=6)
    model = _port(tcfg, _tree(tcfg, 0))
    prompt = torch.tensor([[1, 2, 3, 4]])
    with pytest.raises(ValueError, match="decode_len"):
        tgpt.generate(model, prompt, 3)
    with pytest.raises(ValueError, match="n_new"):
        tgpt.generate(model, prompt, 0)
    # sharded decode is ported since (tests/test_torch_tp_serve.py): the
    # batch must split over the data axis, as the reference's
    mesh = types.SimpleNamespace(data_size=2, model_size=1, data_index=0,
                                 model_index=0)
    with pytest.raises(ValueError, match="not divisible"):
        tgpt.generate(model, prompt, 2, mesh=mesh)


def test_config_checks():
    with pytest.raises(ValueError, match="kv_heads"):
        tgpt.GPTConfig.tiny(kv_heads=3)
    with pytest.raises(NotImplementedError, match="moe"):
        tgpt.GPTConfig.tiny(moe_every=2)
    with pytest.raises(ValueError, match="flash_block_h"):
        tgpt.GPTConfig.tiny(flash_block_h=3)
    with pytest.raises(KeyError, match="unknown GPT size"):
        tgpt.GPTConfig.by_name("huge")
    for name in ("small", "medium", "draft", "tiny"):
        j, t = jgpt.GPTConfig.by_name(name), tgpt.GPTConfig.by_name(name)
        assert (j.vocab_size, j.d_model, j.layers, j.heads, j.d_ff) == (
            t.vocab_size, t.d_model, t.layers, t.heads, t.d_ff)
    cfg = tgpt.GPTConfig.tiny(attn_window=4, attn_global_every=2)
    assert [cfg.layer_window(i) for i in range(4)] == [4, 0, 4, 0]
    assert tgpt.effective_attn_impl("auto", "cpu") == "dense"
    assert tgpt.effective_attn_impl("auto", "cuda") == "flash"


def test_cuda_entry_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgpt.GPT(tgpt.GPTConfig.tiny())
