"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips when there is no CUDA device (decided in
the ``cuda`` fixture, never at import). The file imports torch only, so
it also runs on the GPU machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py

Tolerances are ``chip_smoke.py``'s, with its reasons: bf16 inputs, P and
dS rounded to bf16 in both versions but from sums taken in other orders.
"""

import pytest
import torch

from dtf_tpu_torch.ops import attention as tatt
from dtf_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.gpu

OUT_ATOL, LSE_ATOL, GRAD_REL_TOL = 3e-2, 1e-3, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(cuda, b, h, t_q, t_k, d, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(b, h, t, d, generator=g, device=cuda,
                        dtype=torch.bfloat16) for t in (t_q, t_k, t_k)]


def _rel(x, y):
    return ((x.float() - y.float()).norm() / y.float().norm()).item()


CASES = [((2, 4, 200, 200, 64), True, 0, False),
         ((2, 4, 130, 257, 64), False, 0, True),
         ((2, 2, 300, 300, 128), True, 48, True)]


@pytest.mark.parametrize("shape,causal,window,masked", CASES)
def test_forward_and_backward_kernels_match_plain(cuda, shape, causal,
                                                  window, masked):
    b, h, t_q, t_k, d = shape
    q, k, v = _qkv(cuda, b, h, t_q, t_k, d)
    bias = None
    if masked:
        m = torch.ones(b, t_k, dtype=torch.bool, device=cuda)
        m[-1, :] = False
        bias = tfa._mask_bias(m, b, t_k)
    opts = dict(sm_scale=d ** -0.5, causal=causal, window=window)
    out, lse = tfa.flash_attention_cuda(q, k, v, bias, **opts)
    want_out, want_lse = tfa.flash_attention_reference(q, k, v, bias, **opts)
    assert (out.float() - want_out.float()).abs().max().item() <= OUT_ATOL
    live = ~torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), ~live)
    assert (lse - want_lse)[live].abs().max().item() <= LSE_ATOL
    do = torch.randn(b, t_q, h, d, device=cuda,
                     dtype=torch.bfloat16).transpose(1, 2)
    got = tfa.flash_attention_bwd_cuda(q, k, v, bias, out, lse, do, **opts)
    want = tfa.flash_attention_bwd_reference(q, k, v, bias, out, lse, do,
                                             **opts)
    for x, y in zip(got, want):
        assert torch.isfinite(x).all() and _rel(x, y) <= GRAD_REL_TOL
        if masked:
            assert torch.count_nonzero(x[-1]).item() == 0


def test_autograd_on_cuda_counts_each_kernel_once(cuda):
    q, k, v = (x.requires_grad_() for x in _qkv(cuda, 2, 4, 128, 128, 64))
    g = torch.randn_like(q)
    tfa.reset_launch_counts()
    (tfa.flash_attention(q, k, v, causal=True) * g).sum().backward()
    assert tfa.launch_counts == {"flash_fwd": 1, "flash_fwd_hfold": 0,
                                 "flash_dq": 1, "flash_dkv": 1}
    flash = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    (tatt.dense_attention(q, k, v, causal=True) * g).sum().backward()
    for f, dn in zip(flash, (q.grad, k.grad, v.grad)):
        assert _rel(f, dn) <= GRAD_REL_TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 2, 16, 16, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention_cuda(q.float(), k.float(), v.float(),
                                 sm_scale=0.125)
    q32, k32, v32 = _qkv(cuda, 1, 2, 16, 16, 32)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_bwd_cuda(q32, k32, v32, None, q32,
                                     torch.zeros(2, 16, device=cuda), q32,
                                     sm_scale=0.1)
