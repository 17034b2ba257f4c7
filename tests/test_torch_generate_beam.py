"""The port's beam search (``dtf_tpu_torch.models.gpt.generate_beam``)
against the JAX package's ``generate_beam``, on the CPU at
``GPTConfig.tiny`` in float32 with the same seeded numpy weights: the
returned tokens are EXACTLY equal for 1, 3 and 4 beams, an eos with its
pad, length penalties 0 and 1, a chunked prefill, and GQA + a sliding
window + the int8 cache (whose scale leaves are reordered too). One beam
is greedy ``generate``; the reference's argument errors are raised; a
cache key that is neither batch-led nor known raises; ``generate_gpt
--num_beams`` prints JAX's rows."""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.models import gpt as jgpt
from dtf_tpu_torch import convert, generate_gpt
from dtf_tpu_torch.models import gpt as tgpt

N_NEW, DECODE_LEN = 10, 20
GQA_WINDOW_INT8 = dict(kv_heads=2, attn_window=5, attn_global_every=2,
                       kv_cache_dtype="int8")


def _tree(cfg, seed):
    tree = convert.init_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), tree)


def _pair(**kw):
    return (jgpt.GPTConfig.tiny(dtype=jnp.float32, decode_len=DECODE_LEN,
                                **kw),
            tgpt.GPTConfig.tiny(dtype=torch.float32, decode_len=DECODE_LEN,
                                **kw))


def _port(tcfg, tree):
    model = tgpt.GPT(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree))
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    _, tcfg = _pair()
    tree = _tree(tcfg, 0)
    prompt = np.random.default_rng(3).integers(0, 128, (2, 7))
    return tree, prompt


def _both(tree, prompt, cfg_kw=None, **beam_kw):
    jcfg, tcfg = _pair(**(cfg_kw or {}))
    if cfg_kw:                      # GQA: other projection shapes
        tree = _tree(tcfg, 0)
    want = jgpt.generate_beam(jgpt.GPT(jcfg), tree, jnp.asarray(prompt),
                              N_NEW, **beam_kw)
    got = tgpt.generate_beam(_port(tcfg, tree), torch.from_numpy(prompt),
                             N_NEW, **beam_kw)
    return np.asarray(want), got


@pytest.mark.parametrize("cfg_kw,beam_kw", [
    ({}, dict(num_beams=1)),
    ({}, dict(num_beams=3)),
    ({}, dict(num_beams=4)),
    ({}, dict(num_beams=3, length_penalty=1.0)),
    ({}, dict(num_beams=3, prefill_chunk=3)),
    (GQA_WINDOW_INT8, dict(num_beams=3)),
], ids=["beams1", "beams3", "beams4", "length_penalty1", "prefill_chunk",
        "gqa_window_int8"])
def test_tokens_equal_jax(tiny, cfg_kw, beam_kw):
    tree, prompt = tiny
    want, got = _both(tree, prompt, cfg_kw, **beam_kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_eos_freezes_and_pads_as_jax(tiny):
    """eos := the first token the best beam of row 0 emits without one:
    with eos on, that beam freezes after one token while its rivals keep
    paying log-probs, so the freeze and the pad are on the path."""
    tree, prompt = tiny
    _, tcfg = _pair()
    free = tgpt.generate_beam(_port(tcfg, tree), torch.from_numpy(prompt),
                              N_NEW, num_beams=3)
    eos = int(free[0, prompt.shape[1]])
    want, got = _both(tree, prompt, num_beams=3, eos_id=eos, pad_id=0)
    np.testing.assert_array_equal(got.numpy(), want)
    row = got[0, prompt.shape[1]:].tolist()
    assert eos in row and all(t == 0 for t in row[row.index(eos) + 1:])


def test_one_beam_is_greedy(tiny):
    _, prompt = tiny
    _, tcfg = _pair(**GQA_WINDOW_INT8)
    model = _port(tcfg, _tree(tcfg, 0))
    ids = torch.from_numpy(prompt)
    assert torch.equal(tgpt.generate_beam(model, ids, N_NEW, num_beams=1),
                       tgpt.generate(model, ids, N_NEW))


def test_scores_are_the_returned_beams_log_probs(tiny):
    """``return_scores``: the same tokens, their sum of log-probs under a
    full forward of the same model, and a non-negative margin a step."""
    tree, prompt = tiny
    _, tcfg = _pair()
    model = _port(tcfg, tree)
    ids = torch.from_numpy(prompt)
    toks, scores, margins = tgpt.generate_beam(model, ids, N_NEW,
                                               num_beams=3,
                                               return_scores=True)
    assert torch.equal(toks, tgpt.generate_beam(model, ids, N_NEW,
                                                num_beams=3))
    with torch.no_grad():
        logits = _port(dataclasses.replace(tcfg, decode_len=0), tree)(toks)
    t_p = prompt.shape[1]
    want = torch.log_softmax(logits[:, t_p - 1:-1], -1).gather(
        -1, toks[:, t_p:, None])[..., 0].sum(-1)
    np.testing.assert_allclose(scores.numpy(), want.numpy(), atol=1e-4)
    assert margins.shape == (N_NEW, 2) and bool((margins >= 0).all())


@pytest.mark.parametrize("n_new,beam_kw,match", [
    (N_NEW, dict(num_beams=0), "num_beams"),
    (0, dict(num_beams=2), "n_new"),
    (DECODE_LEN, dict(num_beams=2), "decode_len"),
], ids=["no_beams", "no_tokens", "short_decode_len"])
def test_argument_errors_as_jax(tiny, n_new, beam_kw, match):
    tree, prompt = tiny
    jcfg, tcfg = _pair()
    with pytest.raises(ValueError, match=match) as want:
        jgpt.generate_beam(jgpt.GPT(jcfg), tree, jnp.asarray(prompt), n_new,
                           **beam_kw)
    with pytest.raises(ValueError, match=match) as got:
        tgpt.generate_beam(_port(tcfg, tree), torch.from_numpy(prompt),
                           n_new, **beam_kw)
    assert str(got.value) == str(want.value)


def test_unknown_cache_key_raises(tiny):
    tree, prompt = tiny
    _, tcfg = _pair()
    model = _port(tcfg, tree)
    plain = model.init_cache

    def init_cache(batch):
        cache = plain(batch)
        cache[1]["cached_bias"] = torch.zeros(batch, 3)
        return cache

    model.init_cache = init_cache
    with pytest.raises(ValueError, match="unknown cache leaf 'cached_bias'"):
        tgpt.generate_beam(model, torch.from_numpy(prompt), 3, num_beams=2)


def test_cli_rows_equal_jax(tmp_path):
    """``generate_gpt --num_beams=3 --length_penalty=1`` on a bf16 tiny
    model prints the rows of JAX's ``generate_beam`` on the same tree."""
    cfg = tgpt.GPTConfig.tiny()
    tree = convert.init_params(cfg, 2)
    path = str(tmp_path / "p.npz")
    convert.save_npz(path, tree)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = generate_gpt.main([
            "--size=tiny", f"--params_npz={path}", "--device=cpu",
            "--batch=2", "--prompt=9,8,7", "--n_new=8", "--num_beams=3",
            "--length_penalty=1.0"])
    assert rc == 0
    want = jgpt.generate_beam(
        jgpt.GPT(jgpt.GPTConfig.tiny(decode_len=11)), tree,
        jnp.asarray([[9, 8, 7]] * 2), 8, num_beams=3, length_penalty=1.0)
    assert buf.getvalue().split() == [",".join(map(str, r))
                                      for r in np.asarray(want).tolist()]
