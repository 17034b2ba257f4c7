"""The port's BERT against the JAX package's, on the CPU.

``BertConfig.tiny`` at f32 (4 heads of 8, 2 layers, vocab 128), sequence
16, a batch of 4 whose key-padding mask pads the tail of one row and
every key of another, the same weights on both sides
(``convert.init_params_bert`` with the LayerNorms and ``mlm_bias`` drawn
away from their init). Train mode, dense and flash (JAX's flash in
Pallas interpret mode, the port's its plain version): logits within
``LOGIT_TOL`` × max|logit|, the loss within ``F32_TOL``, every gradient
within ``GRAD_TOL`` × the leaf's max|g|. At bf16 within ``BF16_TOL``.
``make_eval``; the vocab-chunked loss against full logits; the masked
gather (budget covering every row: the full path's loss; without a key:
JAX's indices); the converter both ways, the init distributions and
BERT-base's parameter count; the ``bert`` synthetic batches and
``TokenBinData(mode="mlm")`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.data import formats as jformats
from dtf_tpu.data.synthetic import SyntheticData as JSynthetic
from dtf_tpu.models import bert as jbert
from dtf_tpu_torch import convert
from dtf_tpu_torch.data import formats as tformats
from dtf_tpu_torch.data.synthetic import SyntheticData as TSynthetic
from dtf_tpu_torch.models import bert as tbert

F32_TOL = 1e-5
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4
#: bf16 compute on both sides, rounded at other points (XLA's fused
#: elementwise chains against torch's op by op): loss relative, logits
#: against max|logit|
BF16_TOL = 2e-2
SEQ, BATCH = 16, 4
#: the key projection's bias adds q·b to every score of a query: the
#: softmax does not see it, so its gradient is 0 up to rounding. Both
#: sides' must be within this of 0, relative to the largest gradient
ZERO_GRAD_TOL = 1e-6


def tiny(dtype=torch.float32, **kw):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (jbert.BertConfig.tiny(dtype=jdt, **kw),
            tbert.BertConfig.tiny(dtype=dtype, **kw))


def tree_for(tmodel, seed=0):
    """The trainer's init with LayerNorms and ``mlm_bias`` drawn away
    from 1 / 0 (no branch is dead)."""
    tree = convert.init_params_bert(tmodel, seed)
    rng = np.random.default_rng(seed + 50)
    flat = []
    for path, v in convert._flatten(tree):
        if path[-1] in ("scale", "bias", "mlm_bias") and \
                path[0].startswith(("ln", "layer", "mlm")):
            base = 1.0 if path[-1] == "scale" else 0.0
            v = (base + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        flat.append((path, v))
    return convert._unflatten(flat)


def batch(seed=0, n=BATCH, vocab=128):
    b = JSynthetic("bert", n, seed=seed, seq_len=SEQ,
                   vocab_size=vocab).batch(0)
    b["attention_mask"][0, SEQ // 2 + 3:] = 0      # a padded tail
    b["attention_mask"][1, :] = 0                  # every key padded
    b["segment_ids"][2, SEQ // 2:] = 1
    return b


def port(cfg, tree):
    model = tbert.BertMLM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(tree))
    return model


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close_rel(got, want, tol, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=0.0,
        atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _close(got, want, what, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


def _grads_close(got, want, what):
    """Every gradient within GRAD_TOL × its leaf's max|g|; the key bias's
    (identically 0) within ZERO_GRAD_TOL × the largest of the model."""
    assert set(got) == set(want)
    top = max(float(np.abs(np.asarray(g)).max()) for g in want.values())
    for k, g in want.items():
        if k.endswith("attention.key.bias"):
            for x in (got[k], g):
                assert float(np.abs(np.asarray(x)).max()) <= \
                    ZERO_GRAD_TOL * top, (what, k)
            continue
        _close_rel(got[k], g, GRAD_TOL, f"{what} grad {k}")


def _jax_loss_and_grads(jmodel, tree, b, **kw):
    loss_fn = jbert.make_loss(jmodel, **kw)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), {}, b, jax.random.PRNGKey(0))
    return loss, aux, convert.params_from_flax(
        jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(tmodel, b, **kw):
    params = dict(tmodel.named_parameters())
    loss, aux = tbert.make_loss(tmodel, **kw)(params, _t(b), 7)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), aux, dict(zip(params, grads))


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_train_mode_logits_loss_and_grads_match_jax(impl):
    jcfg, tcfg = tiny(attn_impl=impl)
    jmodel, _ = jbert.make_init(jcfg, seq_len=SEQ)
    tree = tree_for(tbert.BertMLM(tcfg, device="cpu"), 0)
    tmodel = port(tcfg, tree)
    b = batch()
    mask = b["attention_mask"].astype(bool)
    logits = jax.jit(jmodel.apply)(
        {"params": jax.tree.map(jnp.asarray, tree)}, b["input_ids"],
        b["segment_ids"], mask)
    with torch.no_grad():
        got = tmodel(*tbert._inputs(_t(b)))
    assert got.dtype == torch.float32 and got.shape == (BATCH, SEQ, 128)
    _close_rel(got, logits, LOGIT_TOL, f"{impl} logits")
    jloss, jaux, jgrads = _jax_loss_and_grads(jmodel, tree, b)
    tloss, taux, tgrads = _port_loss_and_grads(tmodel, b)
    _close(tloss, jloss, "loss")
    assert float(taux.weight) == float(jaux.weight) == float(
        (b["mlm_labels"] != -100).sum())
    _grads_close(tgrads, jgrads, impl)


def test_bf16_loss_and_logits_match_jax():
    jcfg, tcfg = tiny(dtype=torch.bfloat16)
    jmodel, _ = jbert.make_init(jcfg, seq_len=SEQ)
    tree = tree_for(tbert.BertMLM(tcfg, device="cpu"), 1)
    tmodel = port(tcfg, tree)
    b = batch(seed=1)
    logits = jax.jit(jmodel.apply)(
        {"params": jax.tree.map(jnp.asarray, tree)}, b["input_ids"],
        b["segment_ids"], b["attention_mask"].astype(bool))
    with torch.no_grad():
        got = tmodel(*tbert._inputs(_t(b)))
    _close_rel(got, logits, BF16_TOL, "bf16 logits")
    jloss, _, _ = _jax_loss_and_grads(jmodel, tree, b)
    tloss, _, _ = _port_loss_and_grads(tmodel, b)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=BF16_TOL)


@pytest.mark.parametrize("kw", [{}, {"loss_chunk": 48},
                                {"mlm_gather": 5}],
                         ids=["full", "chunk48", "gather5"])
def test_make_eval_matches_jax(kw):
    jcfg, tcfg = tiny()
    jmodel, _ = jbert.make_init(jcfg, seq_len=SEQ)
    tree = tree_for(tbert.BertMLM(tcfg, device="cpu"), 2)
    tmodel = port(tcfg, tree)
    b = batch(seed=2)
    want = jax.jit(jbert.make_eval(jmodel, **kw))(
        jax.tree.map(jnp.asarray, tree), {}, b)
    with torch.no_grad():
        got = tbert.make_eval(tmodel, **kw)(None, _t(b))
    assert set(got) == set(want) == {"eval_mlm_loss", "eval_mlm_ppl"}
    for k in want:
        _close(got[k], want[k], k)


def test_chunked_loss_equals_full_logits_and_jax():
    """Vocab chunks of 48 over V 128 (the last one cut at 32) against
    the full logits, loss and every gradient; and against JAX's chunked
    path."""
    jcfg, tcfg = tiny()
    jmodel, _ = jbert.make_init(jcfg, seq_len=SEQ)
    tree = tree_for(tbert.BertMLM(tcfg, device="cpu"), 3)
    tmodel = port(tcfg, tree)
    b = batch(seed=3)
    full, _, gfull = _port_loss_and_grads(tmodel, b)
    chunk, _, gchunk = _port_loss_and_grads(tmodel, b, loss_chunk=48)
    jchunk, _, jgrads = _jax_loss_and_grads(jmodel, tree, b, loss_chunk=48)
    _close(chunk, full, "chunked vs full")
    _close(chunk, jchunk, "chunked vs JAX chunked")
    _grads_close(gchunk, gfull, "chunked vs full")
    _grads_close(gchunk, jgrads, "chunked vs JAX chunked")


def test_mlm_gather_covering_every_row_equals_the_full_path_and_jax():
    """A budget of the whole sequence keeps every masked position: the
    loss and gradients of the full path (the CE mean does not depend on
    order), with and without a vocab chunk, and JAX's gathered loss."""
    jcfg, tcfg = tiny()
    jmodel, _ = jbert.make_init(jcfg, seq_len=SEQ)
    tree = tree_for(tbert.BertMLM(tcfg, device="cpu"), 4)
    tmodel = port(tcfg, tree)
    b = batch(seed=4)
    full, faux, gfull = _port_loss_and_grads(tmodel, b)
    for kw in ({"mlm_gather": SEQ}, {"mlm_gather": SEQ, "loss_chunk": 48}):
        got, aux, grads = _port_loss_and_grads(tmodel, b, **kw)
        jloss, _, _ = _jax_loss_and_grads(jmodel, tree, b, **kw)
        _close(got, full, f"{kw} vs full")
        _close(got, jloss, f"{kw} vs JAX")
        assert float(aux.weight) == float(faux.weight)
        _grads_close(grads, gfull, str(kw))


def test_gather_picks_what_the_reference_picks():
    """Without a key: the first ``budget`` valid positions of each row,
    exactly JAX's ``_gather_masked(rng=None)``. With a key: every valid
    position ahead of every invalid one, at most ``budget`` a row, the
    same on both ranks' halves as on the whole rows (the key is drawn for
    the global microbatch)."""
    rng = np.random.default_rng(5)
    labels = np.where(rng.random((6, SEQ)) < 0.4,
                      rng.integers(0, 128, (6, SEQ)), -100).astype(np.int32)
    labels[0] = -100                                  # nothing masked
    labels[1] = 3                                     # everything masked
    h = rng.standard_normal((6, SEQ, 4)).astype(np.float32)
    for budget in (3, 5, SEQ):
        jh, jl = jbert._gather_masked(jnp.asarray(h), jnp.asarray(labels),
                                      budget, None)
        th, tl = tbert.gather_masked(torch.from_numpy(h),
                                     torch.from_numpy(labels), budget)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        key = tbert.DropoutKey(11)
        _, kl = tbert.gather_masked(torch.from_numpy(h),
                                    torch.from_numpy(labels), budget, key)
        n_valid = (labels != -100).sum(1)
        assert ((kl.numpy() != -100).sum(1) ==
                np.minimum(n_valid, budget)).all()
        halves = [tbert.gather_masked(
            torch.from_numpy(h[r * 3:(r + 1) * 3]),
            torch.from_numpy(labels[r * 3:(r + 1) * 3]), budget,
            tbert.DropoutKey(11, r, 2))[1] for r in range(2)]
        assert torch.equal(torch.cat(halves), kl)


def test_converter_round_trips_both_ways():
    _, tcfg = tiny()
    tmodel = tbert.BertMLM(tcfg, device="cpu")
    tree = tree_for(tmodel, 6)
    sd = convert.params_from_flax(tree)
    assert set(sd) == set(dict(tmodel.named_parameters()))
    assert "mlm_bias" in sd and tuple(sd["mlm_bias"].shape) == (128,)
    back = dict(convert._flatten(convert.params_to_flax(sd)))
    want = dict(convert._flatten(tree))
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))
    tmodel.load_state_dict(sd)
    again = convert.params_from_flax(convert.params_to_flax(
        tmodel.state_dict()))
    for k, v in tmodel.state_dict().items():
        assert torch.equal(again[k], v), k
    # the tied decoder is the token embedding itself: no second table
    assert not any("decoder" in k or "lm_head" in k for k in sd)


def test_init_distributions_and_base_param_count_match_make_init():
    """Leaf by leaf against ``make_init``: zeros and ones exactly, std
    within 3% on leaves of >= 65k draws; BERT-base's parameter count
    (counted on the meta device) equals JAX's."""
    kw = dict(vocab_size=512, hidden=256, layers=1, heads=4,
              intermediate=512, max_positions=256)
    _, init_fn = jbert.make_init(jbert.BertConfig(dropout=0.0, **kw),
                                 seq_len=8)
    want = convert.params_from_flax(jax.tree.map(
        np.asarray, jax.jit(init_fn)(jax.random.PRNGKey(0))["params"]))
    got = convert.params_from_flax(convert.init_params_bert(
        tbert.BertMLM(tbert.BertConfig(dropout=0.0, **kw), device="meta"),
        seed=0))
    assert set(got) == set(want)
    for k in want:
        w, g = want[k].double(), got[k].double()
        assert g.shape == w.shape, k
        if w.ndim == 1:
            assert torch.equal(g, w), k
        elif w.numel() >= 65536:
            assert abs(g.std().item() / w.std().item() - 1) < 0.03, k
    jbase, jinit = jbert.make_init(jbert.BertConfig.base(), seq_len=128)
    jcount = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(jinit, jax.random.PRNGKey(0))))
    tbase = tbert.BertMLM(tbert.BertConfig.base(), device="meta")
    assert sum(p.numel() for p in tbase.parameters()) == jcount


def test_synthetic_bert_batches_equal_the_jax_package():
    for host, count in ((0, 1), (1, 2)):
        kw = dict(seed=5, seq_len=24, vocab_size=97, host_index=host,
                  host_count=count)
        j, t = JSynthetic("bert", 4, **kw), TSynthetic("bert", 4, **kw)
        for step in (0, 3):
            want, got = j.batch(step), t.batch(step)
            assert set(want) == set(got)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("vocab", [500, 0])
def test_token_bin_mlm_batches_and_examples_equal_the_jax_package(
        tmp_path, vocab):
    rng = np.random.default_rng(1)
    rng.integers(0, 500, 3000).astype(np.uint16).tofile(tmp_path / "train.bin")
    for host, count in ((0, 1), (1, 2)):
        kw = dict(mode="mlm", vocab_size=vocab, seed=3, host_index=host,
                  host_count=count)
        j = jformats.detect_token_data(str(tmp_path), 4, 32, **kw)
        t = tformats.detect_token_data(str(tmp_path), 4, 32, **kw)
        for want, got in ((j.batch(4), t.batch(4)),
                          (j.example(17), t.example(17))):
            assert set(want) == set(got) == {"input_ids", "segment_ids",
                                             "attention_mask", "mlm_labels"}
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])
