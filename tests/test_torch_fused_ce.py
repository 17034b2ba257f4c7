"""The port's fused and chunked LM losses against the JAX package's.

Fused (``dtf_tpu_torch.ops.fused_ce``, CPU → its plain versions) against
``pallas_lm_cross_entropy`` run in interpret mode as
``tests/test_fused_ce.py`` runs it, with that file's tolerances: loss
rtol 1e-6, count exact, dx and dW rtol 2e-5 / atol 2e-6. Chunked
(``dtf_tpu_torch.ops.losses``) against ``chunked_lm_cross_entropy`` and
``token_chunked_lm_cross_entropy`` at 1e-5. Inputs are seeded numpy; the
port's head is [V, D], the JAX kernel [D, V].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.ops import losses as jlosses
from dtf_tpu.ops.fused_ce import _run_fwd, pallas_lm_cross_entropy
from dtf_tpu_torch.ops import fused_ce as tfc
from dtf_tpu_torch.ops import losses as tlosses

B, T, D, V = 3, 5, 16, 103          # N = 15: unaligned to block_n 8


def _data(seed=0, b=B, t=T, d=D, v=V):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)       # JAX layout
    labels = rng.integers(0, v, (b, t)).astype(np.int32)
    return x, w, labels


def _jax_grads(fn, x, w):
    loss, cnt = fn(jnp.asarray(x), jnp.asarray(w))
    gx, gw = jax.grad(lambda a, b: fn(a, b)[0], (0, 1))(jnp.asarray(x),
                                                        jnp.asarray(w))
    return float(loss), float(cnt), np.asarray(gx), np.asarray(gw)


def _port_grads(fn, x, w, dtype=torch.float32):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    wt = torch.tensor(np.ascontiguousarray(w.T), requires_grad=True)
    loss, cnt = fn(xt, wt)
    loss.backward()
    return loss, cnt, xt.grad, wt.grad.t()


def _jax_pallas(labels, ignore):
    return lambda x, w: pallas_lm_cross_entropy(
        x, w, jnp.asarray(labels), ignore_index=ignore, block_n=8,
        block_v=32, interpret=True)


@pytest.mark.parametrize("ignore", [None, -100])
def test_plain_fused_ce_matches_pallas_interpret(ignore):
    """Loss, count and both gradients, with unaligned N and V, ignored
    positions and an out-of-range label at once."""
    x, w, labels = _data()
    if ignore is not None:
        labels[0, 1] = labels[2, 3] = ignore
    labels[1, 4] = 200                       # out of range: picks nothing
    want = _jax_grads(_jax_pallas(labels, ignore), x, w)
    loss, cnt, dx, dw = _port_grads(
        lambda a, b: tfc.fused_lm_cross_entropy(
            a, b, torch.from_numpy(labels), ignore_index=ignore), x, w)
    np.testing.assert_allclose(loss.item(), want[0], rtol=1e-6)
    assert float(cnt) == want[1] == (13.0 if ignore else 15.0)
    for got, ref, name in ((dx, want[2], "dx"), (dw, want[3], "dw")):
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-6,
                                   err_msg=name)


def test_all_ignored_is_zero_not_nan():
    x, w, labels = _data(seed=1)
    labels[:] = -100
    loss, cnt, dx, dw = _port_grads(
        lambda a, b: tfc.fused_lm_cross_entropy(
            a, b, torch.from_numpy(labels), ignore_index=-100), x, w)
    want = _jax_grads(_jax_pallas(labels, -100), x, w)
    assert loss.item() == want[0] == 0.0 and float(cnt) == want[1] == 1.0
    assert torch.count_nonzero(dx).item() == 0
    assert torch.count_nonzero(dw).item() == 0


def test_bf16_activations_f32_head():
    """bf16 x with an f32 head: computed in f32, dx returned in bf16."""
    x, w, labels = _data(seed=2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, _ = jlosses.softmax_cross_entropy(
        xb.astype(jnp.float32) @ jnp.asarray(w), jnp.asarray(labels),
        ignore_index=-100)
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32)),
                      dtype=torch.bfloat16, requires_grad=True)
    wt = torch.tensor(np.ascontiguousarray(w.T), requires_grad=True)
    loss, _ = tfc.fused_lm_cross_entropy(xt, wt, torch.from_numpy(labels),
                                         ignore_index=-100)
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-2)
    loss.backward()
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    assert torch.isfinite(xt.grad.float()).all()
    assert torch.isfinite(wt.grad).all()


def test_fused_ce_gradcheck_f64():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((7, 6)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((11, 6)), requires_grad=True)
    labels = torch.tensor([0, 3, -100, 10, 12, 5, 5])     # 12 out of range
    assert torch.autograd.gradcheck(
        lambda a, b: tfc._FusedCE.apply(a, b, labels, -100)[0], (x, w))


def test_plain_versions_are_the_kernel_contracts():
    """(lse, tgt) and (dx, dW) of the plain versions against JAX's full
    path: lse is the logsumexp, tgt the label's logit (0 out of range),
    and the backward is dce·(softmax − onehot) through both products."""
    x, w, labels = _data(seed=4)
    labels[0, 0] = 103                      # the first index past V
    xf, lab = x.reshape(-1, D), labels.reshape(-1)
    logits = xf @ w
    lse, tgt = tfc.fused_ce_fwd_reference(
        torch.from_numpy(xf), torch.from_numpy(np.ascontiguousarray(w.T)),
        torch.from_numpy(lab))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(
        jnp.asarray(logits), axis=-1)), rtol=1e-6)
    live = lab < V
    np.testing.assert_allclose(
        tgt.numpy(), np.where(live, logits[np.arange(len(lab)),
                                           np.minimum(lab, V - 1)], 0.0),
        rtol=1e-6)
    dce = np.random.default_rng(5).standard_normal(len(lab)).astype(
        np.float32)
    dx, dw = tfc.fused_ce_bwd_reference(
        torch.from_numpy(xf), torch.from_numpy(np.ascontiguousarray(w.T)),
        torch.from_numpy(lab), lse, torch.from_numpy(dce))
    p = np.exp(logits - lse.numpy()[:, None])
    hot = np.arange(V)[None, :] == lab[:, None]
    dl = dce[:, None] * (p - hot)
    np.testing.assert_allclose(dx.numpy(), dl @ w.T, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(dw.numpy(), dl.T @ xf, rtol=2e-5, atol=2e-6)


def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing_on_cpu():
    x, w, labels = _data(seed=6, d=768)
    xt = torch.from_numpy(x.reshape(-1, 768)).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    lab = torch.from_numpy(labels.reshape(-1))
    stats = torch.zeros(xt.shape[0])
    tfc.reset_launch_counts()
    for call in (lambda: tfc.fused_ce_fwd_cuda(xt, wt, lab),
                 lambda: tfc.fused_ce_fwd_parts_cuda(xt, wt, lab),
                 lambda: tfc.fused_ce_split_cuda(xt, wt),
                 lambda: tfc.fused_ce_dx_cuda(xt, wt, lab, stats, stats),
                 lambda: tfc.fused_ce_dw_cuda(xt, wt, lab, stats, stats)):
        with pytest.raises(ValueError, match="the kernel takes one GPU"):
            call()
    with pytest.raises(ValueError, match="on one GPU"):
        tfc.fused_ce_merge_cuda(torch.zeros(2, 3, xt.shape[0]))
    loss, _ = tfc.fused_lm_cross_entropy(xt, wt, lab, ignore_index=-100)
    loss.backward()
    assert tfc.launch_counts == {"fused_ce_fwd": 0, "fused_ce_merge": 0,
                                 "fused_ce_split": 0, "fused_ce_dx": 0,
                                 "fused_ce_dw": 0}
    # the token-sharded variant is ported (tests/test_torch_multirank.py);
    # the vocab stays whole, so a model axis is refused
    from dtf_tpu_torch.core.mesh import Mesh

    tp = Mesh(data_size=1, model_size=2, data_index=0, model_index=0,
              data_group=None, model_group=None, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="model"):
        tfc.fused_lm_cross_entropy(xt, wt, lab, mesh=tp)


def _tf32_rna_numpy(a):
    """Round to 11 significant bits (1 implicit + 10 explicit), ties away
    from zero, by frexp: an independent statement of cvt.rna.tf32.f32."""
    m, e = np.frexp(a.astype(np.float64))          # a = m·2^e, |m| in [.5, 1)
    s = m * 2.0 ** 11
    r = np.sign(s) * np.floor(np.abs(s) + 0.5)
    return np.ldexp(r, e - 11).astype(np.float32)


def test_tf32_round_keeps_exactly_10_explicit_mantissa_bits():
    """The rounding B6/B7's split uses (cvt.rna.tf32.f32): the low 13 of
    the 23 explicit mantissa bits are 0, the 10 above them are kept and
    used, ties round away from zero."""
    rng = np.random.default_rng(11)
    a = np.concatenate([
        rng.standard_normal(100_000).astype(np.float32),
        (rng.standard_normal(1000) * 1e-30).astype(np.float32),
        (rng.standard_normal(1000) * 1e30).astype(np.float32),
        # exact ties: 1 + 2^-11 (+ 2^-10 for an odd kept bit), both signs
        np.float32([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -10 + 2 ** -11,
                    -(1 + 2 ** -10 + 2 ** -11)])])
    got = tfc.tf32_round(torch.from_numpy(a)).numpy()
    bits = got.view(np.int32)
    assert not (bits & 0x1FFF).any()
    assert np.array_equal(got, _tf32_rna_numpy(a))
    assert np.array_equal(got[-4:], np.float32(
        [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, -(1 + 2 ** -9)]))
    # each of the 10 kept bits is set somewhere: none is dropped
    for bit in range(13, 23):
        assert ((bits >> bit) & 1).any(), bit
    # the half-ulp bound of a 10-bit mantissa
    _, e = np.frexp(a)
    assert (np.abs(got.astype(np.float64) - a)
            <= np.ldexp(1.0, e - 12) * (1 + 1e-12)).all()


def test_split_reference_is_the_kernels_layout():
    """hi + lo is the value to 2^-22 relative; the transposed halves hold
    row PERM8[p] of every group of 8 at position p, the pad 0."""
    a = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (13, 64)).astype(np.float32))
    hi, lo, t_hi, t_lo = tfc.fused_ce_split_reference(a)
    assert torch.equal(hi, tfc.tf32_round(a))
    assert ((hi.double() + lo.double() - a.double()).abs()
            <= a.double().abs() * 2.0 ** -22).all()
    assert t_hi.shape == t_lo.shape == (64, 16)
    order = [8 * (p // 8) + tfc.PERM8[p % 8] for p in range(16)]
    for p, r in enumerate(order):
        if r < 13:
            assert torch.equal(t_hi[:, p], hi[r])
            assert torch.equal(t_lo[:, p], lo[r])
        else:
            assert not t_hi[:, p].any() and not t_lo[:, p].any()


def _mm_3xtf32(a, b):
    """a @ b as B6/B7 compute it: tf32 hi/lo splits (each product of two
    tf32 values exact in f32), hi·hi + hi·lo + lo·hi summed in f32."""
    ah, al = tfc.split_tf32(a)
    bh, bl = tfc.split_tf32(b)
    return ah @ bh + ah @ bl + al @ bh


def _mm_1xtf32(a, b):
    return tfc.tf32_round(a) @ tfc.tf32_round(b)


def test_3xtf32_backward_products_are_f32_accurate():
    """The precision choice of B6/B7, held where no card runs: both
    products of the backward (the logits recompute and dX / dW) emulated
    in 3xTF32 with f32 sums agree with the f64 plain version within 1e-6
    relative; one TF32 pass (~11 bits) would not. chip_smoke.py's input
    scales: x ~ N(0, 1), W ~ N(0, 0.05²), some labels ignored."""
    rng = np.random.default_rng(13)
    n, d, v = 64, 768, 300
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((v, d)) * 0.05).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, v, n))
    labels[::7] = -100
    valid = (labels != -100).double()
    dce = valid / valid.sum()
    lse, _ = tfc.fused_ce_fwd_reference(x.double(), w.double(), labels)
    want_dx, want_dw = tfc.fused_ce_bwd_reference(
        x.double(), w.double(), labels, lse, dce)

    def emulate(mm):
        logits = mm(x, w.t())
        hot = (torch.arange(v)[None, :] == labels[:, None]).float()
        dl = dce.float()[:, None] * (torch.exp(logits - lse.float()[:, None])
                                     - hot)
        return mm(dl, w), mm(dl.t(), x)

    def rel(got, want):
        return ((got.double() - want).norm() / want.norm()).item()

    dx, dw = emulate(_mm_3xtf32)
    assert rel(dx, want_dx) <= 1e-6 and rel(dw, want_dw) <= 1e-6, (
        rel(dx, want_dx), rel(dw, want_dw))
    dx1, dw1 = emulate(_mm_1xtf32)
    assert rel(dx1, want_dx) > 1e-4 and rel(dw1, want_dw) > 1e-4


PART_CASES = [
    # N not a multiple of 128, a ragged last part (103 = 3 x 32 + 7),
    # labels out of range and ignored
    (15, 103, 32, "out_of_range"),
    # one part holding the whole vocab; every label ignored
    (130, 97, 128, "all_ignored"),
    # parts that divide the vocab; a label on each part's first and last
    # column
    (5, 64, 16, "part_edges"),
]


@pytest.mark.parametrize("n,v,part_rows,labelling", PART_CASES)
def test_vocab_parts_merged_in_order_equal_the_pallas_forward(
        n, v, part_rows, labelling):
    """B5's arithmetic on the CPU: per-part (m, l, tgt) and their merge in
    part order give the lse and target logit of fused_ce_fwd_reference
    and of the Pallas forward (``_run_fwd`` in interpret mode)."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((n, D)).astype(np.float32)
    w = rng.standard_normal((D, v)).astype(np.float32)      # JAX layout
    labels = rng.integers(0, v, n).astype(np.int32)
    if labelling == "out_of_range":
        labels[0], labels[1], labels[2], labels[3] = v, v + 40, -100, -1
    elif labelling == "all_ignored":
        labels[:] = -100
    else:
        labels[:4] = [0, part_rows - 1, part_rows, v - 1]
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    lab = torch.from_numpy(labels)
    ws = tfc.fused_ce_parts_reference(xt, wt, lab, part_rows)
    assert ws.shape == (-(-v // part_rows), 3, n)
    lse, tgt = tfc.fused_ce_merge_reference(ws)
    want_lse, want_tgt = tfc.fused_ce_fwd_reference(xt, wt, lab)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-6)
    np.testing.assert_allclose(tgt.numpy(), want_tgt.numpy(), rtol=1e-6,
                               atol=1e-6)
    jlse, jtgt = _run_fwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                          8, 32, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=1e-6,
                               atol=1e-6)
    live = (labels >= 0) & (labels < v)
    assert not tgt.numpy()[~live].any()


def test_merge_takes_parts_with_no_live_column():
    """A part with no live column (m −inf, l 0, tgt 0) changes no bit of
    the merge, wherever it stands; with no live column at all, lse is −inf
    (the reference's ``_finalize``: l read as 1) and nothing is NaN."""
    x, w, labels = _data(seed=16)
    ws = tfc.fused_ce_parts_reference(
        torch.from_numpy(x.reshape(-1, D)),
        torch.from_numpy(np.ascontiguousarray(w.T)),
        torch.from_numpy(labels.reshape(-1)), 32)
    empty = torch.zeros_like(ws[:1])
    empty[:, 0] = -torch.inf
    want = tfc.fused_ce_merge_reference(ws)
    for at in (0, 2, ws.shape[0]):
        got = tfc.fused_ce_merge_reference(torch.cat([ws[:at], empty,
                                                      ws[at:]]))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    lse, tgt = tfc.fused_ce_merge_reference(torch.cat([empty, empty]))
    assert (lse == -torch.inf).all() and not tgt.any()


@pytest.mark.parametrize("w_std", [0.05, 0.2])
def test_3xtf32_forward_logits_are_f32_accurate(w_std, monkeypatch):
    """The precision of B5, held where no card runs: its logits emulated
    as the kernel forms them (x split as the registers split it, W's
    stored hi/lo from the split pass; hi·hi' + hi·lo' + lo·hi' in f32)
    are within 1e-6 (relative) of f64, and the parts and their merge
    built on them give lse and tgt within a quarter of chip_smoke.py's
    1e-4 gate; one TF32 pass is ~300× further off. chip_smoke.py's
    input scales (W std 0.05) and its larger-logit case (0.2)."""
    rng = np.random.default_rng(17)
    n, d, v = 64, 768, 4000
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((v, d)) * w_std).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, v, n))
    labels[::7] = -100
    want = x.double() @ w.double().t()
    want_lse, want_tgt = tfc.fused_ce_fwd_reference(x.double(), w.double(),
                                                    labels)

    def b5_logits(a, b, acc):
        ah, al = tfc.split_tf32(a)
        bh, bl = tfc.fused_ce_split_reference(b)[:2]
        return ah @ bh.t() + ah @ bl.t() + al @ bh.t()

    def one_pass(a, b, acc):
        return tfc.tf32_round(a) @ tfc.tf32_round(b).t()

    def rel(got):
        return ((got.double() - want).norm() / want.norm()).item()

    assert rel(b5_logits(x, w, None)) <= 1e-6
    assert rel(one_pass(x, w, None)) > 1e-4
    monkeypatch.setattr(tfc, "_logits", b5_logits)
    lse, tgt = tfc.fused_ce_merge_reference(
        tfc.fused_ce_parts_reference(x, w, labels))
    assert (lse.double() - want_lse).abs().max().item() <= 2.5e-5
    assert (tgt.double() - want_tgt).abs().max().item() <= 2.5e-5


CHUNKED = {
    "vocab": (jlosses.chunked_lm_cross_entropy,
              tlosses.chunked_lm_cross_entropy, 32),
    "tokens": (jlosses.token_chunked_lm_cross_entropy,
               tlosses.token_chunked_lm_cross_entropy, 4),
}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("axis", sorted(CHUNKED))
def test_chunked_losses_match_jax(axis, bias):
    """Unaligned V (103, chunk 32) and N (15, chunk 4), a bias, −100 and
    out-of-range labels — one in the pad band [V, V_pad) of the vocab
    chunking, one past it: loss, count and both gradients."""
    jfn, tfn, chunk = CHUNKED[axis]
    x, w, labels = _data(seed=7)
    labels[0, 1] = labels[2, 3] = -100
    labels[1, 4], labels[0, 4] = 110, 300
    b = (np.random.default_rng(8).standard_normal(V).astype(np.float32)
         if bias else None)
    want = _jax_grads(lambda a, k: jfn(
        a, k, jnp.asarray(labels), chunk=chunk, ignore_index=-100,
        bias=None if b is None else jnp.asarray(b)), x, w)
    loss, cnt, dx, dw = _port_grads(lambda a, k: tfn(
        a, k, torch.from_numpy(labels), chunk=chunk, ignore_index=-100,
        bias=None if b is None else torch.from_numpy(b)), x, w)
    np.testing.assert_allclose(loss.item(), want[0], rtol=1e-5)
    assert float(cnt) == want[1] == 13.0
    for got, ref in ((dx, want[2]), (dw, want[3])):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", sorted(CHUNKED))
def test_chunked_losses_without_ignore_equal_the_full_path(axis):
    """No ignore_index: the mean is over every token (count N), an
    out-of-range label's CE is its lse, and the result is the monolithic
    softmax_cross_entropy's (the port's own) at 1e-5."""
    _, tfn, chunk = CHUNKED[axis]
    x, w, labels = _data(seed=9)
    xt, wt = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T))
    lab = torch.from_numpy(labels)
    loss, cnt = tfn(xt, wt, lab, chunk=chunk)
    want, n = tlosses.softmax_cross_entropy(xt @ wt.t(), lab)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert float(cnt) == float(n) == 15.0
    labels[0, 0] = 1000
    loss, _ = tfn(xt, wt, torch.from_numpy(labels), chunk=chunk)
    jwant, _ = jlosses.softmax_cross_entropy(jnp.asarray(x @ w),
                                             jnp.asarray(labels))
    np.testing.assert_allclose(float(loss), float(jwant), rtol=1e-5)
