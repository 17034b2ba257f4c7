"""The port's flash-attention backward against the JAX package's.

``flash_attention_bwd_reference`` (the plain PyTorch backward the CUDA
kernels are held against on the card) is compared, in float32 on the CPU,
with ``jax.vjp`` through ``dtf_tpu.ops.flash_attention.flash_attention``
run in interpret mode (``block_q = block_k = 32``, so the ragged and
multi-block paths of ``_dq_kernel`` / ``_dkv_kernel`` are exercised) at
atol 1e-5, on the grad cases of ``tests/test_flash_attention.py``. The
port's autograd path is checked against autograd through its
``dense_attention``, and the reference backward against finite
differences (``gradcheck``, float64). The CUDA kernels themselves run only
on the card (``chip_smoke.py`` phase ``kernels_bwd``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtf_tpu.ops import flash_attention as jfa
from dtf_tpu_torch.ops import attention as tatt
from dtf_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5


def _inputs(b, h, t_q, t_k, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t_q, d)).astype(np.float32)
    k = rng.standard_normal((b, h, t_k, d)).astype(np.float32)
    v = rng.standard_normal((b, h, t_k, d)).astype(np.float32)
    g = rng.standard_normal((b, h, t_q, d)).astype(np.float32)
    return q, k, v, g


def _mask(b, t_k, dead_row=None):
    m = np.ones((b, t_k), bool)
    m[0, t_k - 20:] = False                  # a masked tail across a block
    if dead_row is not None:
        m[dead_row, :] = False               # every key masked
    return m


# head dim 8: shapes no other test compiles, so the Pallas interpret
# programs here never collide with another test's persistent-cache entries
CASES = {
    "aligned": dict(shape=(2, 2, 64, 64, 8), kw={}),
    "aligned_causal": dict(shape=(2, 2, 64, 64, 8), kw={"causal": True}),
    "ragged_causal": dict(shape=(1, 2, 41, 41, 8), kw={"causal": True}),
    "window": dict(shape=(1, 2, 64, 64, 8),
                   kw={"causal": True, "window": 24}),
    "tq_ne_tk": dict(shape=(1, 2, 33, 50, 8), kw={}),
    "tq_ne_tk_causal": dict(shape=(1, 2, 50, 33, 8), kw={"causal": True}),
    "sm_scale": dict(shape=(1, 2, 32, 32, 8), kw={"sm_scale": 0.5}),
    "kv_mask_dead_row": dict(shape=(2, 2, 48, 48, 8),
                             kw={"kv_mask": "dead"}),
}


def _resolve(name):
    case = CASES[name]
    b, h, t_q, t_k, d = case["shape"]
    kw = dict(case["kw"])
    if kw.get("kv_mask") == "dead":
        kw["kv_mask"] = _mask(b, t_k, dead_row=1)
    return _inputs(b, h, t_q, t_k, d, seed=len(name)), kw


def _jax_grads(q, k, v, g, kw):
    jkw = dict(kw)
    if "kv_mask" in jkw:
        jkw["kv_mask"] = jnp.asarray(jkw["kv_mask"])

    def fn(q, k, v):
        return jfa.flash_attention(q, k, v, block_q=32, block_k=32,
                                   interpret=True, **jkw)

    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_bwd_reference(q, k, v, g, kw):
    """The port's plain forward for (out, lse), then its plain backward."""
    b, _, _, d = q.shape
    t_k = k.shape[2]
    bias = (None if "kv_mask" not in kw else tfa._mask_bias(
        torch.from_numpy(kw["kv_mask"]), b, t_k))
    opts = dict(sm_scale=kw.get("sm_scale", d ** -0.5),
                causal=kw.get("causal", False), window=kw.get("window", 0))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = tfa.flash_attention_reference(tq, tk, tv, bias, **opts)
    return [x.numpy() for x in tfa.flash_attention_bwd_reference(
        tq, tk, tv, bias, out, lse, tg, **opts)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_reference_matches_jax_grad(name):
    (q, k, v, g), kw = _resolve(name)
    want = _jax_grads(q, k, v, g, kw)
    got = _port_bwd_reference(q, k, v, g, kw)
    for w, x, which in zip(want, got, ("dq", "dk", "dv")):
        assert x.shape == w.shape and x.dtype == np.float32
        np.testing.assert_allclose(x, w, atol=ATOL, rtol=0, err_msg=which)


def test_dead_row_gradient_is_zero_not_nan():
    (q, k, v, g), kw = _resolve("kv_mask_dead_row")
    dq, dk, dv = _port_bwd_reference(q, k, v, g, kw)
    for x in (dq, dk, dv):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x[1], 0.0)            # batch row 1


@pytest.mark.parametrize("name", ["aligned_causal", "window", "tq_ne_tk",
                                  "kv_mask_dead_row"])
def test_autograd_flash_matches_autograd_dense(name):
    (q, k, v, g), kw = _resolve(name)
    b, _, t_q, _ = q.shape
    t_k = k.shape[2]

    def grads(fn):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*xs) * torch.from_numpy(g)).sum().backward()
        return [x.grad for x in xs]

    tkw = dict(kw)
    dkw = {"causal": kw.get("causal", False), "window": kw.get("window", 0),
           "sm_scale": kw.get("sm_scale")}
    if "kv_mask" in kw:
        tkw["kv_mask"] = torch.from_numpy(kw["kv_mask"])
        dkw["bias"] = torch.where(tkw["kv_mask"][:, None, None, :], 0.0,
                                  float("-inf")).expand(b, 1, t_q, t_k)
    flash = grads(lambda q, k, v: tfa.flash_attention(q, k, v, **tkw))
    dense = grads(lambda q, k, v: tatt.dense_attention(q, k, v, **dkw))
    for f, d_, which in zip(flash, dense, ("dq", "dk", "dv")):
        np.testing.assert_allclose(f.numpy(), d_.numpy(), atol=ATOL, rtol=0,
                                   err_msg=which)


@pytest.mark.parametrize("causal,window,masked", [(False, 0, False),
                                                  (True, 0, False),
                                                  (True, 3, True)])
def test_gradcheck_reference_backward_f64(causal, window, masked):
    rng = np.random.default_rng(5)
    b, h, t, d = 2, 2, 7, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d)))
               .requires_grad_() for _ in range(3))
    kv_mask = None
    if masked:
        m = np.ones((b, t), bool)
        m[0, 5:] = False
        kv_mask = torch.from_numpy(m)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal,
                                            window=window, kv_mask=kv_mask),
        (q, k, v), eps=1e-6, atol=1e-6)


def test_bias_gets_a_zero_gradient():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 16, 8, 1))
    bias = torch.zeros(1, 1, 16, requires_grad=True)
    out = tfa._Flash.apply(q, k, v, bias, 0.25, True, 0, 1)
    (out * g).sum().backward()
    assert torch.equal(bias.grad, torch.zeros_like(bias))


def test_cuda_backward_wrapper_refuses_cpu_tensors_and_counts_nothing():
    tfa.reset_launch_counts()
    q = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    lse = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="cpu"):
        tfa.flash_attention_bwd_cuda(q, q, q, None, q, lse, q, sm_scale=0.125)
    assert tfa.launch_counts == {"flash_fwd": 0, "flash_fwd_hfold": 0,
                                 "flash_dq": 0, "flash_dkv": 0}
