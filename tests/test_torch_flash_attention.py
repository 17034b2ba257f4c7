"""The port's flash-attention forward against the JAX package's.

``flash_attention_reference`` (the plain PyTorch forward the CUDA kernel is
held against on the card) is compared, in float32 on the CPU, with the
Pallas kernel run in interpret mode (``block_q = block_k = 32``, so the
ragged and multi-block paths are exercised) and with the dense reference,
at atol 1e-5 — ``out`` and the ``lse`` residual the backward reads. The CUDA kernel itself only runs on the card
(``chip_smoke.py``); here its wrapper must refuse CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.ops import attention as jatt
from dtf_tpu.ops import flash_attention as jfa
from dtf_tpu_torch.ops import attention as tatt
from dtf_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


def _qkv(b, h, t_q, t_k, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t_q, d)).astype(np.float32)
    k = rng.standard_normal((b, h, t_k, d)).astype(np.float32)
    v = rng.standard_normal((b, h, t_k, d)).astype(np.float32)
    return q, k, v


def _jax_fwd(q, k, v, *, causal=False, window=0, kv_mask=None,
             sm_scale=None):
    """JAX ``_fwd`` (the Pallas forward, interpret mode) → (out, lse)."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    bias = (None if kv_mask is None
            else jfa._mask_bias(jnp.asarray(kv_mask), b, t_k, 32))
    out, lse = jfa._fwd(
        jnp.asarray(q).reshape(b * h, t_q, d),
        jnp.asarray(k).reshape(b * h, t_k, d),
        jnp.asarray(v).reshape(b * h, t_k, d), bias, sm_scale=scale,
        causal=causal, window=window, block_q=min(32, t_q),
        block_k=min(32, t_k), interpret=True)
    return np.asarray(out), np.asarray(lse)


def _port_ref(q, k, v, *, causal=False, window=0, kv_mask=None,
              sm_scale=None):
    b, _, _, d = q.shape
    t_k = k.shape[2]
    bias = (None if kv_mask is None
            else tfa._mask_bias(torch.from_numpy(kv_mask), b, t_k))
    out, lse = tfa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), bias,
        sm_scale=sm_scale if sm_scale is not None else d ** -0.5,
        causal=causal, window=window)
    return out.numpy(), lse.numpy()


def _mask(b, t_k, dead_row=None):
    m = np.ones((b, t_k), bool)
    m[0, t_k - 20:] = False                  # a masked tail across a block
    if dead_row is not None:
        m[dead_row, :] = False               # every key masked
    return m


# head dim 8: shapes no other test compiles, so the Pallas interpret
# programs here never collide with another test's persistent-cache entries
CASES = {
    "aligned": dict(shape=(2, 3, 64, 64, 8), kw={}),
    "aligned_causal": dict(shape=(2, 3, 64, 64, 8), kw={"causal": True}),
    "ragged": dict(shape=(2, 3, 45, 45, 8), kw={}),
    "ragged_causal": dict(shape=(2, 3, 45, 45, 8), kw={"causal": True}),
    "window": dict(shape=(2, 2, 64, 64, 8),
                   kw={"causal": True, "window": 24}),
    "window_ragged": dict(shape=(1, 2, 50, 50, 8),
                          kw={"causal": True, "window": 17}),
    "window_geq_t": dict(shape=(1, 2, 40, 40, 8),
                         kw={"causal": True, "window": 48}),
    "tq_ne_tk": dict(shape=(1, 2, 33, 50, 8), kw={}),
    "tq_ne_tk_causal": dict(shape=(1, 2, 50, 33, 8), kw={"causal": True}),
    "sm_scale": dict(shape=(1, 2, 32, 32, 8), kw={"sm_scale": 0.5}),
    "kv_mask": dict(shape=(2, 2, 48, 48, 8), kw={"kv_mask": "dead"}),
    "kv_mask_causal_window": dict(shape=(2, 2, 48, 48, 8),
                                  kw={"kv_mask": "tail", "causal": True,
                                      "window": 20}),
}


def _resolve(name):
    case = CASES[name]
    b, h, t_q, t_k, d = case["shape"]
    kw = dict(case["kw"])
    if kw.get("kv_mask") == "dead":
        kw["kv_mask"] = _mask(b, t_k, dead_row=1)
    elif kw.get("kv_mask") == "tail":
        kw["kv_mask"] = _mask(b, t_k)
    return _qkv(b, h, t_q, t_k, d, seed=len(name)), kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_fwd_out_and_lse(name):
    (q, k, v), kw = _resolve(name)
    want_out, want_lse = _jax_fwd(q, k, v, **kw)
    got_out, got_lse = _port_ref(q, k, v, **kw)
    b, h, t_q, d = q.shape
    assert got_out.shape == (b * h, t_q, d) and got_lse.shape == (b * h, t_q)
    assert got_lse.dtype == np.float32
    np.testing.assert_allclose(got_out, want_out, atol=ATOL, rtol=0)
    # -inf rows must agree exactly; finite ones to the tolerance
    np.testing.assert_array_equal(np.isneginf(got_lse),
                                  np.isneginf(want_lse))
    fin = np.isfinite(want_lse)
    np.testing.assert_allclose(got_lse[fin], want_lse[fin], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["aligned_causal", "ragged", "window",
                                  "tq_ne_tk", "kv_mask"])
def test_public_flash_matches_jax_flash_and_dense(name):
    (q, k, v), kw = _resolve(name)
    jkw = dict(kw)
    if "kv_mask" in jkw:
        jkw["kv_mask"] = jnp.asarray(jkw["kv_mask"])
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), block_q=32, block_k=32,
                               interpret=True, **jkw)
    tkw = dict(kw)
    if "kv_mask" in tkw:
        tkw["kv_mask"] = torch.from_numpy(tkw["kv_mask"])
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **tkw)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    bias = None
    if "kv_mask" in kw:
        bias = np.where(kw["kv_mask"][:, None, None, :], 0.0, -np.inf)
    dense = jatt.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=kw.get("causal", False), window=kw.get("window", 0),
        bias=None if bias is None else jnp.asarray(bias, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=ATOL,
                               rtol=0)


def test_all_masked_row_gives_zero_and_neg_inf_lse():
    (q, k, v), kw = _resolve("kv_mask")
    out, lse = _port_ref(q, k, v, **kw)
    h = q.shape[1]
    np.testing.assert_array_equal(out[h:2 * h], 0.0)      # batch row 1
    assert np.isneginf(lse[h:2 * h]).all()
    assert np.isfinite(lse[:h]).all()


def test_window_at_least_t_equals_full_causal():
    q, k, v = _qkv(1, 2, 40, 40, 16, seed=9)
    full, _ = _port_ref(q, k, v, causal=True)
    win, _ = _port_ref(q, k, v, causal=True, window=40)
    np.testing.assert_array_equal(win, full)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (True, 7)])
def test_dense_attention_matches_jax(causal, window):
    q, k, v = _qkv(2, 2, 21, 21, 8, seed=3)
    bias = np.zeros((2, 1, 1, 21), np.float32)
    bias[1, ..., 15:] = -np.inf
    want = jatt.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                window=window, bias=jnp.asarray(bias))
    got = tatt.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window, bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_dense_attention_dead_row_is_zero():
    q, k, v = _qkv(1, 1, 4, 4, 8, seed=0)
    bias = np.full((1, 1, 1, 4), -np.inf, np.float32)
    got = tatt.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               bias=torch.from_numpy(bias))
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("block_h", [1, 2, 4])
def test_block_h_accepted_when_it_divides_heads(block_h):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 16, 16, 8, seed=2))
    base = tfa.flash_attention(q, k, v, causal=True)
    got = tfa.flash_attention(q, k, v, causal=True, block_h=block_h)
    assert torch.equal(got, base)


def test_argument_checks():
    q = torch.zeros(2, 3, 16, 8)
    with pytest.raises(ValueError, match="block_h"):
        tfa.flash_attention(q, q, q, block_h=2)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, q, q, causal=True, window=-1)
    with pytest.raises(ValueError, match="kv_mask"):
        tfa.flash_attention(q, q, q, kv_mask=torch.ones(2, 8, dtype=bool))
    with pytest.raises(ValueError, match=r"\[B, H, T, D\]"):
        tfa.flash_attention(q[0], q[0], q[0])
    # tensors that require grad are taken: the backward is ported
    out = tfa.flash_attention(q.clone().requires_grad_(), q, q)
    assert out.requires_grad


def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    tfa.reset_launch_counts()
    q = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cpu"):
        tfa.flash_attention_cuda(q, q, q, sm_scale=0.125)
    assert tfa.launch_counts == {"flash_fwd": 0, "flash_fwd_hfold": 0,
                                 "flash_dq": 0, "flash_dkv": 0}


# The kernels' grids: B·H/block_h head groups in grid x (up to 2³¹ − 1),
# ⌈T_q/64⌉ q-blocks (and, in the backward, ⌈T_k/64⌉ k-blocks) in grid y
# (up to 65,535). The Pallas grids take any B·H.
Y_MAX_ROWS = 64 * 65535


@pytest.mark.parametrize("b,h,t_q,t_k,block_h,backward", [
    (4097, 16, 1, 1, 1, False),            # B·H 65,552: past the old limit
    (4097, 16, 2, 2, 1, True),
    (2 ** 20, 2 ** 11, 1, 1, 2, False),     # B·H 2³¹, halved by block_h
    (1, 1, Y_MAX_ROWS, Y_MAX_ROWS, 1, True),
    (1, 1, 64, Y_MAX_ROWS + 1, 1, False),   # the forward's grid has no T_k
])
def test_grid_rule_accepts(b, h, t_q, t_k, block_h, backward):
    tfa.check_grid(b, h, t_q, t_k, block_h=block_h, backward=backward)


@pytest.mark.parametrize("b,h,t_q,t_k,block_h,backward,match", [
    (1, 1, Y_MAX_ROWS + 1, 1, 1, False, r"T_q = 4194241 .*y limit \(65535\)"),
    (1, 1, Y_MAX_ROWS + 1, 1, 1, True, r"T_q .*y limit \(65535\)"),
    (1, 1, 64, Y_MAX_ROWS + 1, 1, True, r"T_k = 4194241 .*y limit \(65535\)"),
    (2 ** 20, 2 ** 11, 1, 1, 1, False, r"x limit \(2147483647\)"),
])
def test_grid_rule_refuses(b, h, t_q, t_k, block_h, backward, match):
    with pytest.raises(ValueError, match=match):
        tfa.check_grid(b, h, t_q, t_k, block_h=block_h, backward=backward)
