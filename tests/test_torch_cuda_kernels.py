"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips when there is no CUDA device (decided in
the ``cuda`` fixture, never at import). The file imports torch only, so
it also runs on the GPU machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernels.py

Tolerances are ``chip_smoke.py``'s, with its reasons: for flash, bf16
inputs, P and dS rounded to bf16 in both versions but from sums taken in
other orders; for the fused CE (B5–B7), f32 operands with TF32 off, the
same products summed in another order (3xTF32, ~2^-21 a product). B5
(with the merge of its vocab parts), B6 and B7 sum in a fixed order with
no atomics: two launches are bitwise equal. The embedding gather (B8) copies: it equals its
plain version exactly, in its masked form too (one launch for one or two
tables of a row shard, f32 rounded to bf16 to nearest even as it is
stored), and the masked lookup's table gradients equal today's per-table
composite bit for bit (index_add_ deterministic).
"""

import pytest
import torch

from dtf_tpu_torch.ops import attention as tatt
from dtf_tpu_torch.ops import embed_gather as teg
from dtf_tpu_torch.ops import flash_attention as tfa
from dtf_tpu_torch.ops import fused_ce as tfc

pytestmark = pytest.mark.gpu

OUT_ATOL, LSE_ATOL, GRAD_REL_TOL = 3e-2, 1e-3, 1e-2
CE_STAT_ATOL, CE_GRAD_REL_TOL, CE_BF16_DX_REL_TOL = 1e-4, 1e-4, 4e-3
CE_MERGE_ATOL = 1e-5


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
         ((2, 2, 300, 300, 128), True, 48, True),
         # the backward's tile edges: one row past a 64- and a 128-row
         # block, one query against 1024 keys, D 128 ragged with a window
         ((1, 2, 65, 65, 64), True, 0, False),
         ((1, 2, 129, 129, 64), True, 0, False),
         ((2, 4, 1, 1024, 64), False, 0, False),
         ((1, 2, 1000, 1000, 128), True, 200, False),
         # D 128 ragged with a window and a dead kv_mask row; B·H 65,552
         # in grid x (T 2: at T 1, dQ and dK are 0 up to rounding)
         ((2, 2, 1000, 1000, 128), True, 200, True),
         ((4097, 16, 2, 2, 64), False, 0, False)]


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


@pytest.mark.parametrize("d", (64, 128))
def test_backward_kernels_are_bitwise_repeatable(cuda, d):
    # no atomics, one write per element: the same inputs give the same bits
    q, k, v = _qkv(cuda, 2, 4, 300, 300, d)
    do = torch.randn(2, 300, 4, d, device=cuda,
                     dtype=torch.bfloat16).transpose(1, 2)
    opts = dict(sm_scale=d ** -0.5, causal=True)
    out, lse = tfa.flash_attention_cuda(q, k, v, **opts)
    first = tfa.flash_attention_bwd_cuda(q, k, v, None, out, lse, do, **opts)
    again = tfa.flash_attention_bwd_cuda(q, k, v, None, out, lse, do, **opts)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d", (64, 128))
def test_forward_kernel_is_bitwise_repeatable_and_head_folding_equal(cuda, d):
    # the training shape (D 128 at half the heads): one write per element,
    # and block_h = 2 runs block_h = 1's per-head code
    q, k, v = _qkv(cuda, 8, 12 * 64 // d, 1024, 1024, d)
    opts = dict(sm_scale=d ** -0.5, causal=True)
    first = tfa.flash_attention_cuda(q, k, v, **opts)
    again = tfa.flash_attention_cuda(q, k, v, **opts)
    folded = tfa.flash_attention_cuda(q, k, v, block_h=2, **opts)
    for x, y, z in zip(first, again, folded):
        assert torch.equal(x, y) and torch.equal(x, z)


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


def _ce_inputs(cuda, n, d, v, x_dtype=torch.float32, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=cuda).to(x_dtype)
    w = torch.randn(v, d, generator=g, device=cuda) * 0.05
    labels = torch.randint(0, v, (n,), generator=g, device=cuda)
    return x, w, labels


CE_CASES = [(1000, 768, 50257, "out_of_range", torch.float32),
            (5, 768, 50304, "", torch.float32),
            (64, 768, 5003, "all_ignored", torch.float32),
            (256, 768, 3001, "some_ignored", torch.bfloat16),
            (300, 1024, 4097, "out_of_range", torch.float32),
            (700, 384, 5003, "out_of_range", torch.float32)]


@pytest.mark.parametrize("n,d,v,labelling,x_dtype", CE_CASES)
def test_fused_ce_kernels_match_plain(cuda, n, d, v, labelling, x_dtype):
    x, w, labels = _ce_inputs(cuda, n, d, v, x_dtype)
    if labelling == "out_of_range":
        labels[0], labels[1], labels[2] = v, v + 40, -100
    elif labelling == "some_ignored":
        labels[::5] = -100
    elif labelling == "all_ignored":
        labels[:] = -100
    valid = (labels != -100).float()
    dce = valid / valid.sum().clamp_min(1.0)
    lse, tgt = tfc.fused_ce_fwd_cuda(x, w, labels)
    want_lse, want_tgt = tfc.fused_ce_fwd_reference(x, w, labels)
    assert (lse - want_lse).abs().max().item() <= CE_STAT_ATOL
    assert (tgt - want_tgt).abs().max().item() <= CE_STAT_ATOL
    dx = tfc.fused_ce_dx_cuda(x, w, labels, lse, dce)
    dw = tfc.fused_ce_dw_cuda(x, w, labels, lse, dce)
    want_dx, want_dw = tfc.fused_ce_bwd_reference(x, w, labels, lse, dce)
    assert dx.dtype == x_dtype and dw.dtype == torch.float32
    if labelling == "all_ignored":
        assert torch.count_nonzero(dx).item() == 0
        assert torch.count_nonzero(dw).item() == 0
        return
    dx_tol = CE_BF16_DX_REL_TOL if x_dtype == torch.bfloat16 \
        else CE_GRAD_REL_TOL
    assert _rel(dx, want_dx) <= dx_tol
    assert _rel(dw, want_dw) <= CE_GRAD_REL_TOL


def test_fused_ce_autograd_on_cuda_counts_each_kernel_once(cuda):
    x, w, labels = _ce_inputs(cuda, 300, 768, 5003)
    labels[:7] = -100
    x.requires_grad_()
    w.requires_grad_()
    tfc.reset_launch_counts()
    loss, cnt = tfc.fused_lm_cross_entropy(x, w, labels, ignore_index=-100)
    loss.backward()
    assert tfc.launch_counts == {"fused_ce_fwd": 1, "fused_ce_merge": 1,
                                 "fused_ce_split": 1, "fused_ce_dx": 1,
                                 "fused_ce_dw": 1}
    assert cnt.item() == 293.0
    fused = (loss.item(), x.grad.clone(), w.grad.clone())
    x.grad = w.grad = None
    logits = x @ w.t()
    want = torch.nn.functional.cross_entropy(logits, labels,
                                             ignore_index=-100)
    want.backward()
    assert abs(fused[0] - want.item()) <= 1e-5 * abs(want.item())
    assert _rel(fused[1], x.grad) <= CE_GRAD_REL_TOL
    assert _rel(fused[2], w.grad) <= CE_GRAD_REL_TOL


@pytest.mark.parametrize("n,d,v", [(4096, 768, 50304), (700, 384, 5003)])
def test_fused_ce_backward_is_bitwise_repeatable(cuda, n, d, v):
    """No atomics and a fixed order of every sum (the cluster's partial
    logits in rank order): two launches of B6 and of B7 give the same
    bits, and the split pass equals its plain version bit for bit."""
    x, w, labels = _ce_inputs(cuda, n, d, v, seed=3)
    labels[::9] = -100
    valid = (labels != -100).float()
    dce = valid / valid.sum()
    lse, _ = tfc.fused_ce_fwd_cuda(x, w, labels)
    split = tfc.fused_ce_split_cuda(x, w)
    for got, want in zip((*split.x, *split.w),
                         (*tfc.fused_ce_split_reference(x),
                          *tfc.fused_ce_split_reference(w))):
        assert torch.equal(got, want)
    for fn in (tfc.fused_ce_dx_cuda, tfc.fused_ce_dw_cuda):
        assert torch.equal(fn(x, w, labels, lse, dce, split),
                           fn(x, w, labels, lse, dce, split))


@pytest.mark.parametrize("n,d,v,w_std", [(8192, 768, 50304, 0.05),
                                         (4096, 768, 50304, 0.2),
                                         (300, 1024, 4097, 0.05)])
def test_fused_ce_forward_parts_merge_and_bitwise_repeat(cuda, n, d, v,
                                                         w_std):
    """B5's parts against fused_ce_parts_reference (each part's max,
    logsumexp and target logit), the merge against its plain version on
    B5's parts, lse and tgt against fused_ce_fwd_reference, at chip_smoke's
    gate, with larger logits too (W std 0.2); two B5 launches give the
    same bits."""
    x, w, labels = _ce_inputs(cuda, n, d, v, seed=4)
    w = w * (w_std / 0.05)
    labels[::9] = -100
    labels[1] = v
    split = tfc.fused_ce_split_cuda(x, w, for_fwd=True, for_dx=False,
                                    for_dw=False)
    assert split.x is None and split.w[2] is None and split.w[3] is None
    ws = tfc.fused_ce_fwd_parts_cuda(x, w, labels, split)
    assert torch.equal(ws, tfc.fused_ce_fwd_parts_cuda(x, w, labels, split))
    want_ws = tfc.fused_ce_parts_reference(x, w, labels)
    assert ws.shape == want_ws.shape == (-(-v // tfc.FWD_PART_ROWS), 3, n)
    for i in (0, 2):
        assert (ws[:, i] - want_ws[:, i]).abs().max().item() <= CE_STAT_ATOL
    own_lse = ws[:, 0] + ws[:, 1].log()
    want_own = want_ws[:, 0] + want_ws[:, 1].log()
    assert (own_lse - want_own).abs().max().item() <= CE_STAT_ATOL
    lse, tgt = tfc.fused_ce_merge_cuda(ws)
    m_lse, m_tgt = tfc.fused_ce_merge_reference(ws)
    assert (lse - m_lse).abs().max().item() <= CE_MERGE_ATOL
    assert (tgt - m_tgt).abs().max().item() <= CE_MERGE_ATOL
    want_lse, want_tgt = tfc.fused_ce_fwd_reference(x, w, labels)
    assert (lse - want_lse).abs().max().item() <= CE_STAT_ATOL
    assert (tgt - want_tgt).abs().max().item() <= CE_STAT_ATOL
    assert tgt[1].item() == 0.0


def test_fused_ce_without_grad_splits_w_alone(cuda):
    """Under no_grad (an eval batch) the forward launches the split pass
    for W's stored pair only, B5 and the merge, and nothing else."""
    x, w, labels = _ce_inputs(cuda, 300, 768, 5003)
    x.requires_grad_()
    w.requires_grad_()
    tfc.reset_launch_counts()
    with torch.no_grad():
        loss, _ = tfc.fused_lm_cross_entropy(x, w, labels)
    assert tfc.launch_counts == {"fused_ce_fwd": 1, "fused_ce_merge": 1,
                                 "fused_ce_split": 1, "fused_ce_dx": 0,
                                 "fused_ce_dw": 0}
    want = torch.nn.functional.cross_entropy(x.detach() @ w.detach().t(),
                                             labels)
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())


def test_fused_ce_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, w, labels = _ce_inputs(cuda, 16, 768, 300)
    stats = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="one GPU"):
        tfc.fused_ce_fwd_cuda(x, w.cpu(), labels)
    with pytest.raises(ValueError, match="float32"):
        tfc.fused_ce_fwd_cuda(x.half(), w, labels)
    with pytest.raises(ValueError, match="float32"):
        tfc.fused_ce_dw_cuda(x, w.double(), labels, stats, stats)
    with pytest.raises(ValueError, match="labels"):
        tfc.fused_ce_fwd_cuda(x, w, labels[:15])
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        tfc.fused_ce_dx_cuda(x, w[:, :512], labels, stats, stats)
    with pytest.raises(ValueError, match="head width"):
        tfc.fused_ce_fwd_cuda(x[:, :512], w[:, :512], labels)
    with pytest.raises(ValueError, match="head width"):
        tfc.fused_ce_split_cuda(x[:, :640], w[:, :640])
    other = tfc.fused_ce_split_cuda(x, w[:200])
    with pytest.raises(ValueError, match="split does not match"):
        tfc.fused_ce_dx_cuda(x, w, labels, stats, stats, other)
    with pytest.raises(ValueError, match="lse"):
        tfc.fused_ce_dx_cuda(x, w, labels, stats[:8], stats)
    with pytest.raises(ValueError, match="split does not match"):
        tfc.fused_ce_fwd_cuda(x, w, labels, other)
    fwd_only = tfc.fused_ce_split_cuda(x, w, for_fwd=True, for_dx=False,
                                       for_dw=False)
    with pytest.raises(ValueError, match="split does not match"):
        tfc.fused_ce_dx_cuda(x, w, labels, stats, stats, fwd_only)
    with pytest.raises(ValueError, match=r"\[parts, 3, N\]"):
        tfc.fused_ce_merge_cuda(torch.zeros(2, 4, 16, device=cuda))


EMBED_CASES = [(1000, 16, torch.float32), (1000, 16, torch.bfloat16),
               (1000, 1, torch.float32), (300, 3, torch.bfloat16),
               (300, 17, torch.bfloat16), (200, 768, torch.float32)]


@pytest.mark.parametrize("rows,d,dtype", EMBED_CASES)
def test_embed_gather_kernel_matches_plain(cuda, rows, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randn(rows, d, generator=g, device=cuda).to(dtype)
    ids = torch.randint(0, rows, (7, 33), generator=g, device=cuda,
                        dtype=torch.int32)
    ids[0, :3] = torch.tensor([0, rows - 1, rows - 1], dtype=torch.int32)
    got = teg.gather_rows_cuda(table, ids)
    assert got.shape == (7, 33, d) and got.dtype == dtype
    assert torch.equal(got, teg.gather_rows_reference(table, ids))


def test_embed_gather_strided_table_out_of_range_and_empty(cuda):
    base = torch.randn(50, 12, device=cuda)
    table = base[:, 2:10]                   # row stride 12, 8 wide
    ids = torch.tensor([-1, 0, 49, 50, 10 ** 6, 7], dtype=torch.int32,
                       device=cuda)
    teg.reset_launch_counts()
    got = teg.gather_rows_cuda(table, ids)
    want = teg.gather_rows_reference(table, ids)
    nan = torch.isnan(want)
    assert nan[[0, 3, 4]].all() and not nan[[1, 2, 5]].any()
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])
    empty = teg.gather_rows_cuda(table, ids[:0])
    assert empty.shape == (0, 8)
    assert teg.launch_counts == {"embed_gather": 1}


def test_embed_gather_autograd_counts_one_launch(cuda):
    table = torch.randn(64, 16, device=cuda, requires_grad=True)
    ids = torch.tensor([3, 3, 3, 7, 63, 0, 3], dtype=torch.int32,
                       device=cuda)
    ct = torch.randn(7, 16, device=cuda)
    teg.reset_launch_counts()
    (teg.gather_rows(table, ids) * ct).sum().backward()
    assert teg.launch_counts == {"embed_gather": 1}
    want = torch.zeros(64, 16, dtype=torch.float64, device=cuda)
    want.index_add_(0, ids.long(), ct.double())
    assert _rel(table.grad, want) <= 1e-6


def test_embed_gather_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    table = torch.randn(10, 4, device=cuda)
    ids = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        teg.gather_rows_cuda(table, ids.long())
    with pytest.raises(ValueError, match="float16"):
        teg.gather_rows_cuda(table.half(), ids)
    with pytest.raises(ValueError, match="one GPU"):
        teg.gather_rows_cuda(table.cpu(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        teg.gather_rows_cuda(table.t(), ids)
    with pytest.raises(ValueError, match="expected table"):
        teg.gather_rows(table[0], ids)


#: (rows a shard, [(d, table dtype, out dtype)], shard)
MASKED_CASES = [
    (500, [(1, torch.float32, torch.float32),
           (16, torch.float32, torch.bfloat16)], 1),
    (500, [(16, torch.float32, torch.float32)], 0),
    (500, [(16, torch.float32, torch.bfloat16)], 2),
    (500, [(16, torch.bfloat16, torch.bfloat16)], 1),
    (300, [(3, torch.bfloat16, torch.bfloat16),
           (17, torch.float32, torch.bfloat16)], 1),
    (200, [(768, torch.float32, torch.bfloat16),
           (1, torch.float32, torch.float32)], 1),
]


@pytest.mark.parametrize("rows,specs,shard", MASKED_CASES)
def test_masked_gather_kernel_matches_plain(cuda, rows, specs, shard):
    g = torch.Generator(device=cuda).manual_seed(2)
    tables = [torch.randn(rows, d, generator=g, device=cuda).to(dt)
              for d, dt, _ in specs]
    out_dtypes = [o for _, _, o in specs]
    ids = torch.randint(-5, 3 * rows + 5, (9, 41), generator=g,
                        device=cuda, dtype=torch.int32)
    ids[0, :4] = torch.tensor([shard * rows, (shard + 1) * rows - 1,
                               (shard + 1) * rows, shard * rows - 1])
    teg.reset_launch_counts()
    got = teg.masked_gather_rows_cuda(tables, ids, shard, out_dtypes)
    want = teg.masked_gather_rows_reference(tables, ids, shard, out_dtypes)
    assert teg.launch_counts == {"embed_gather": 1}
    inside = (ids >= shard * rows) & (ids < (shard + 1) * rows)
    for o, w, t, (d, _, dt) in zip(got, want, tables, specs):
        assert o.shape == (9, 41, d) and o.dtype == dt
        assert torch.equal(o, w)
        assert not o[~inside].any()
        assert torch.equal(o[inside],
                           t.to(dt)[(ids[inside] - shard * rows).long()])


def test_masked_gather_strided_and_empty(cuda):
    base = torch.randn(100, 12, device=cuda)
    tables = (base[50:, 2:10], base[50:, :1])          # row stride 12
    ids = torch.tensor([-1, 0, 49, 50, 99, 100, 75, 2 ** 31 - 1],
                       dtype=torch.int32, device=cuda)
    dtypes = (torch.bfloat16, torch.float32)
    teg.reset_launch_counts()
    got = teg.masked_gather_rows_cuda(tables, ids, 1, dtypes)
    want = teg.masked_gather_rows_reference(tables, ids, 1, dtypes)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    empty = teg.masked_gather_rows_cuda(tables, ids[:0], 1, dtypes)
    assert [tuple(e.shape) for e in empty] == [(0, 8), (0, 1)]
    assert teg.launch_counts == {"embed_gather": 1}


def test_masked_gather_autograd_one_launch_grads_equal_composite(cuda):
    from dtf_tpu_torch.parallel import embedding as temb

    g = torch.Generator(device=cuda).manual_seed(3)
    weights = [torch.randn(64, d, generator=g, device=cuda) for d in (1, 16)]
    dtypes = (torch.float32, torch.bfloat16)
    ids = torch.randint(0, 128, (32, 26), generator=g, device=cuda,
                        dtype=torch.int32)
    ids[1] = ids[0]
    ids[2, :4] = ids[0, 0]                     # one id 6 times
    cts = [torch.randn(32, 26, d, generator=g, device=cuda).to(dt)
           for d, dt in zip((1, 16), dtypes)]
    torch.use_deterministic_algorithms(True)
    try:
        params = [w.clone().requires_grad_() for w in weights]
        teg.reset_launch_counts()
        outs = teg.masked_gather_rows(params, ids, 1, dtypes)
        assert teg.launch_counts == {"embed_gather": 1}
        got = torch.autograd.grad(outs, params, cts)
        assert teg.launch_counts == {"embed_gather": 1}
        params = [w.clone().requires_grad_() for w in weights]
        today = [temb.masked_lookup(p.to(dt), ids, 1,
                                    gather_fn=teg.gather_rows)
                 for p, dt in zip(params, dtypes)]
        want = torch.autograd.grad(today, params, cts)
    finally:
        torch.use_deterministic_algorithms(False)
    for o, t in zip(outs, today):
        assert torch.equal(o, t)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)


def test_masked_gather_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    table = torch.randn(10, 4, device=cuda)
    ids = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one or two"):
        teg.masked_gather_rows_cuda((table,) * 3, ids, 0)
    with pytest.raises(ValueError, match="share ids"):
        teg.masked_gather_rows_cuda((table, table[:5]), ids, 0)
    with pytest.raises(ValueError, match="bf16 from f32"):
        teg.masked_gather_rows_cuda((table.bfloat16(),), ids, 0,
                                    (torch.float32,))
    with pytest.raises(ValueError, match="int32"):
        teg.masked_gather_rows_cuda((table,), ids.long(), 0)
