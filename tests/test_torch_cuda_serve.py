"""The serving engine's index operations on the card, where an index out
of range is a device-side assert that poisons every later CUDA call.

Marked ``gpu``: each test skips when there is no CUDA device (decided in
the ``cuda`` fixture, never at import). The file imports torch only, so
it also runs on the GPU machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_serve.py

The slot verify step's write (positions at and past the cache end, an
inactive row) and the page pool's copies (save ids at and past
``n_pages``, load ids past the chain) run on the card: no device assert,
the dropped positions and pages keep their old contents bit for bit, the
written ones equal the same step on the CPU (projections within 1e-4 in
f32 with TF32 off; copies exactly).
"""

import pytest
import torch

from dtf_tpu_torch.models import gpt

pytestmark = pytest.mark.gpu

L, PAGE = 32, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(device, **kw):
    cfg = gpt.GPTConfig.tiny(dtype=torch.float32, decode_len=L,
                             slot_decode=True, **kw)
    torch.manual_seed(0)
    model = gpt.GPT(cfg, device="cpu").eval()
    state = {n: x.clone() for n, x in model.state_dict().items()}
    out = gpt.GPT(cfg, device=device).eval()
    out.load_state_dict(state)
    return out


def _filled_cache(model, index, seed):
    gen = torch.Generator().manual_seed(seed)
    cache = model.init_cache(len(index))
    for layer in cache:
        for name, x in layer.items():
            if x is None:
                continue
            if name == "cache_index":
                x.copy_(torch.tensor(index))
            elif x.dtype == torch.int8:
                x.copy_(torch.randint(-127, 128, x.shape, generator=gen))
            else:
                x.copy_(torch.rand(x.shape, generator=gen) + 0.01)
    return cache


@pytest.mark.parametrize("kv", ["", "int8"])
def test_verify_write_drops_past_the_end_on_the_card(cuda, kv):
    index = [L - 2, L - 1, L, L + 3, 5]
    active = torch.tensor([True, True, True, True, False])
    ids = torch.randint(0, 128, (5, 4), generator=torch.Generator()
                        .manual_seed(1))
    outs = {}
    for dev in ("cpu", cuda):
        model = _model(dev, kv_cache_dtype=kv)
        cache = _filled_cache(model, index, seed=2)
        old = [{n: x.clone() for n, x in c.items() if x is not None}
               for c in cache]
        with torch.no_grad():
            logits = model(ids.to(dev), cache, decode_active=active.to(dev))
        torch.cuda.synchronize()
        for layer, before in zip(cache, old):
            for name, x in layer.items():
                if x is None or name == "cache_index":
                    continue
                assert torch.equal(x[0, :, :L - 2], before[name][0, :, :L - 2])
                assert torch.equal(x[1, :, :L - 1], before[name][1, :, :L - 1])
                for row in (2, 3, 4):            # all dropped
                    assert torch.equal(x[row], before[name][row]), name
        assert cache[0]["cache_index"].tolist() == [L + 2, L + 3, L + 4,
                                                    L + 7, 5]
        outs[str(dev)] = (logits.cpu(), [
            {n: x.cpu() for n, x in c.items() if x is not None}
            for c in cache])
    (lc, cc), (lg, cg) = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(lg, lc, atol=1e-4, rtol=0)
    for a, b in zip(cg, cc):
        for name in a:
            if a[name].dtype == torch.int8:
                assert (a[name].int() - b[name].int()).abs().max() <= 1
            else:
                torch.testing.assert_close(a[name], b[name], atol=1e-4,
                                           rtol=0)


def test_page_copies_drop_out_of_range_ids_on_the_card(cuda):
    model = _model(cuda, kv_cache_dtype="int8")
    cache = _filled_cache(model, [3, 9, 30], seed=3)
    n_pages = 6
    pool = [{n: torch.zeros((n_pages,) + x.shape[1:2] + (PAGE,)
                            + x.shape[3:], dtype=x.dtype, device=cuda)
             for n, x in layer.items()
             if x is not None and n != "cache_index"} for layer in cache]
    for layer in pool:
        for x in layer.values():
            x.copy_(torch.randint(-100, 100, x.shape, device=cuda))
    before = [{n: x.clone() for n, x in layer.items()} for layer in pool]
    m = L // PAGE
    ids = torch.tensor([2, n_pages, 0, n_pages + 5, 5, n_pages, 1, 99],
                       device=cuda)[:m]
    gpt.cache_save_pages(cache, pool, torch.tensor([1], device=cuda), ids)
    torch.cuda.synchronize()
    kept = {int(i): j for j, i in enumerate(ids.tolist()) if i < n_pages}
    for layer, pl, old in zip(cache, pool, before):
        for name, x in pl.items():
            for page in range(n_pages):
                if page in kept:
                    j = kept[page]
                    want = layer[name][1, :, j * PAGE:(j + 1) * PAGE]
                else:
                    want = old[name][page]
                assert torch.equal(x[page], want), (name, page)
    # a load of 2 pages whose tail ids are out of range
    load_ids = torch.tensor([5, 0] + [n_pages + 7] * (m - 2), device=cuda)
    rows = [{n: x.clone() for n, x in layer.items() if x is not None}
            for layer in cache]
    gpt.cache_load_pages(cache, pool, torch.tensor([2], device=cuda),
                         load_ids, torch.tensor(2, device=cuda))
    torch.cuda.synchronize()
    for layer, pl, old in zip(cache, pool, rows):
        for name, x in pl.items():
            got = layer[name][2]
            assert torch.equal(got[:, :PAGE], x[5])
            assert torch.equal(got[:, PAGE:2 * PAGE], x[0])
            assert torch.equal(got[:, 2 * PAGE:], old[name][2, :, 2 * PAGE:])
            assert torch.equal(layer[name][:2], old[name][:2])
