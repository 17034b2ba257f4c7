"""GPT-style causal decoder LM (counterpart of ``dtf_tpu.models.gpt``).

Pre-LN blocks, interleaved RoPE, optional grouped-query attention
(``kv_heads``), sliding-window and global layers, an untied f32 LM head,
bf16 compute over f32 params — the JAX model's math, in PyTorch idiom:
``nn.Module``s, an explicit device, the KV cache as explicit state that
the model writes IN PLACE (one dict per layer, from
:meth:`GPT.init_cache`), a Python loop where JAX used ``lax.scan``, and a
counter-based sampler (:func:`sample_tokens`) where JAX split keys.

Ported: the full-sequence forward (with the one-shot prefill cache
write), the single-token decode step, chunked prefill (with the serving
engine's right-padded ``prefill_len`` chunk), the int8 cache, the serving
engine's ``slot_decode`` step (a position counter per batch row, rows
masked by ``decode_active``) and its multi-token slot VERIFY step
(speculative decoding) with :func:`cache_rollback`, :func:`draft_truncate`
and the prefix-page copies (:func:`cache_load_pages`,
:func:`cache_save_pages`), ``filter_logits``, ``filter_logits_dynamic``
``generate`` and the beam search ``generate_beam``; for training, the
backward through
the flash kernels, remat per block (``torch.utils.checkpoint``), dropout
from explicit per-step seeds, and the LM loss (:func:`make_loss`,
:func:`make_eval`): monolithic logits, or the head fused with the CE —
vocab- or token-chunked, or the fused kernels (B5–B7). Megatron tensor
parallelism over a mesh's model group (``GPT(mesh=)``, the reference's
``tp_rules`` as :data:`tp_rules`): the rank holds its heads of q/k/v and
attn_out, its features of the MLP, its V/m rows of the token table and
of the head; the embedding is a masked lookup summed over the group, the
loss :func:`~dtf_tpu_torch.ops.losses.vocab_parallel_cross_entropy`, and
under ``tp_overlap`` the residual stream is token-sharded between the
collective-matmul rings (Megatron-SP). The decode model over a model group
(sharded decode, ``generate(mesh=)`` and the serving engine's): each
rank's KV cache holds its ``kv_heads / m`` heads, and the vocab-parallel
logits are gathered whole (:meth:`GPT.vocab_rows`, one counted
all-gather) only at the rows a sampler reads. Not yet: MoE layers,
sequence parallelism.

Dropout runs only when the caller passes ``dropout_seed`` (the training
loss does; serving never does). Each mask is drawn from a fresh
``torch.Generator`` seeded from (step seed, layer, site), so a block that
remat recomputes draws the mask it drew the first time:
``torch.utils.checkpoint`` restores the global RNG only, never a
caller's generator. The masks are not flax's bits, only its distribution
(keep with probability 1 - rate, scale kept values by 1 / (1 - rate)).
Under data parallelism every rank holds the same seed, so a mask is
drawn for the GLOBAL batch and each rank takes its own rows
(:class:`DropoutKey`): ranks get different masks, and N ranks train as
one rank on the whole batch does.
"""

from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dtf_tpu_torch.core import comms
from dtf_tpu_torch.core.comms import TpDense
from dtf_tpu_torch.core.device import resolve_device
from dtf_tpu_torch.core.train import LossAux, fold_in
from dtf_tpu_torch.ops.attention import dense_attention
from dtf_tpu_torch.ops.flash_attention import flash_attention
from dtf_tpu_torch.ops.fused_ce import fused_lm_cross_entropy
from dtf_tpu_torch.ops.losses import (chunked_lm_cross_entropy,
                                      softmax_cross_entropy,
                                      token_chunked_lm_cross_entropy,
                                      valid_count,
                                      vocab_parallel_cross_entropy)
from dtf_tpu_torch.parallel.embedding import masked_lookup_sharded

_NEG_INF = float("-inf")

#: Megatron TP placement over the model axis (the reference's ``tp_rules``)
#: in the port's layout: a weight is [out, in], so the reference's
#: column-parallel kernel P(None, "model") is dim 0 here and its
#: row-parallel kernel P("model", None) dim 1; the token table and the
#: head [V, D] split their vocab rows
tp_rules = [
    (r"token_embed\.weight", ("model", None)),
    (r"\.(query|key|value)\.weight", ("model", None)),
    (r"\.attn_out\.weight", (None, "model")),
    (r"\.mlp_in\.weight", ("model", None)),
    (r"\.mlp_out\.weight", (None, "model")),
    (r"\.(query|key|value|mlp_in)\.bias", ("model",)),
    (r"lm_head\.weight", ("model", None)),
]

#: why a fused or chunked LM loss is refused over a model axis (the
#: reference launcher's words)
TP_FUSED_LOSS_REFUSED = (
    "--loss_chunk_vocab/--loss_chunk_tokens/--loss_pallas cannot combine "
    "with --mesh_model: TP shards the lm_head over the vocab dim, which "
    "fused application would fight (all-gathering W per chunk)")

#: the leaves a rank's forward applies to its own tokens only in the
#: Megatron-SP layout: their gradients are this rank's part of the sum
#: over the model group (:class:`dtf_tpu_torch.core.train.LossAux`
#: ``model_partial``)
SP_PARTIAL_LEAVES = r"(ln1|ln2|ln_f)\.|\.(attn_out|mlp_out)\.bias"


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    #: GPT-2's 50257 BPE vocab padded to a multiple of 128.
    vocab_size: int = 50304
    d_model: int = 768
    layers: int = 12
    heads: int = 12
    d_ff: int = 3072
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    rope_theta: float = 10000.0
    #: grouped-query attention: shared K/V heads (None = heads). Must
    #: divide ``heads``.
    kv_heads: Optional[int] = None
    #: auto (flash on CUDA, dense elsewhere) | dense | flash.
    attn_impl: str = "auto"
    #: sliding window: query t sees keys in (t-window, t]. 0 = full causal.
    attn_window: int = 0
    #: with attn_window > 0: every k-th layer (1-indexed) is global.
    attn_global_every: int = 0
    #: heads per CTA of the flash kernel (must divide heads).
    flash_block_h: int = 1
    #: every k-th block a Switch-MoE FFN — not ported: must be 0.
    moe_every: int = 0
    #: > 0: decode mode against a KV cache of this length.
    decode_len: int = 0
    #: "" = cache at ``dtype``; "int8" = symmetric per-slot quantization.
    kv_cache_dtype: str = ""
    #: multi-token calls CONTINUE an advanced cache (chunked prefill).
    chunked_prefill: bool = False
    #: per-row cache indices (the serving engine): ``cache_index`` is a
    #: [B] tensor and every row decodes at its own position.
    slot_decode: bool = False
    #: "" / "bf16" only; the quantized tiers are not ported.
    matmul_precision: str = ""
    #: recompute each block in the backward (torch.utils.checkpoint):
    #: activation memory for FLOPs, as ``nn.remat(Block)``.
    remat: bool = False
    #: over a model axis > 1: the TP projections run as collective-matmul
    #: rings and the residual stream stays token-sharded (Megatron-SP)
    #: where ``comms.tp_overlap_viable`` allows; else the plain TP path.
    tp_overlap: bool = False

    def __post_init__(self):
        if self.kv_heads is not None and (
                self.kv_heads < 1 or self.heads % self.kv_heads):
            raise ValueError(
                f"kv_heads={self.kv_heads} must be >=1 and divide "
                f"heads={self.heads}")
        if self.attn_window < 0:
            raise ValueError(f"attn_window={self.attn_window} must be >= 0")
        if self.attn_global_every < 0:
            raise ValueError(
                f"attn_global_every={self.attn_global_every} must be >= 0")
        if self.kv_cache_dtype not in ("", "int8"):
            raise ValueError(
                f"kv_cache_dtype={self.kv_cache_dtype!r} must be '' (store "
                "at dtype) or 'int8'")
        if self.matmul_precision not in ("", "auto", "bf16", "int8", "fp8"):
            raise ValueError(
                f"matmul_precision={self.matmul_precision!r} must be '' "
                "(bf16, no tuner), 'auto' (kernel-tune winner), 'bf16', "
                "'int8' or 'fp8'")
        if self.matmul_precision not in ("", "bf16"):
            raise NotImplementedError(
                f"matmul_precision={self.matmul_precision!r}: the quantized "
                "tiers are not ported yet")
        if self.slot_decode and self.decode_len <= 0:
            raise ValueError(
                "slot_decode requires decode_len > 0 (it is a property of "
                "the KV-cache decode mode)")
        if self.slot_decode and self.chunked_prefill:
            raise ValueError(
                "slot_decode and chunked_prefill are different models of "
                "the same cache")
        if self.moe_every:
            raise NotImplementedError(
                f"moe_every={self.moe_every}: Switch-MoE layers are not "
                "ported yet")
        if self.flash_block_h < 1 or self.heads % self.flash_block_h:
            raise ValueError(f"flash_block_h={self.flash_block_h} must be "
                             f">= 1 and divide heads={self.heads}")

    def layer_window(self, layer: int) -> int:
        """Effective sliding window of layer ``layer`` (0-indexed): 0 on a
        designated global layer, else ``attn_window``."""
        if (self.attn_window and self.attn_global_every
                and (layer + 1) % self.attn_global_every == 0):
            return 0
        return self.attn_window

    @property
    def kv_heads_resolved(self) -> int:
        return self.heads if self.kv_heads is None else self.kv_heads

    @staticmethod
    def by_name(name: str) -> "GPTConfig":
        sizes = {"small": GPTConfig.gpt2_small,
                 "medium": GPTConfig.gpt2_medium,
                 "draft": GPTConfig.gpt2_draft,
                 "tiny": GPTConfig.tiny}
        if name not in sizes:
            raise KeyError(
                f"unknown GPT size {name!r}; pick one of {sorted(sizes)}")
        return sizes[name]()

    @staticmethod
    def gpt2_small() -> "GPTConfig":
        return GPTConfig()

    @staticmethod
    def gpt2_medium() -> "GPTConfig":
        return GPTConfig(d_model=1024, layers=24, heads=16, d_ff=4096)

    @staticmethod
    def gpt2_draft() -> "GPTConfig":
        return GPTConfig(d_model=384, layers=3, heads=6, d_ff=1536)

    @staticmethod
    def tiny(**kw) -> "GPTConfig":
        return GPTConfig(vocab_size=128, d_model=32, layers=2, heads=4,
                         d_ff=64, **kw)


def effective_attn_impl(impl: str, device) -> str:
    """Resolve ``attn_impl='auto'``: the flash kernel on CUDA, the dense
    reference elsewhere. Sequence-parallel ring/zigzag are not ported."""
    if impl != "auto":
        return impl
    return "flash" if torch.device(device).type == "cuda" else "dense"


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, INTERLEAVED: (even, odd) lane pairs rotate, not
    the two halves. x [B,H,T,D] (D even), positions [T] (or per-row
    [B,T]). Angles in f32; the result is cast back to x's dtype."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., None].to(torch.float32) * freqs      # [...,T,D/2]
    if angles.ndim == 3:                   # [B,T,D/2] → broadcast over heads
        angles = angles[:, None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _kv_quant(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last (d_head) axis: (int8 values, f32
    scale with keepdim). A zero row quantizes to zeros."""
    af = a.to(torch.float32)
    s = af.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
    q = torch.clamp(torch.round(af / s), -127, 127).to(torch.int8)
    return q, s


def _cache_read(cfg: GPTConfig, cvar: torch.Tensor,
                svar: Optional[torch.Tensor]) -> torch.Tensor:
    """Cache contents at compute dtype (dequantized when int8). Without
    int8 this is the cache tensor ITSELF: clone it before an in-place
    write if the old contents must survive."""
    if svar is None:
        return cvar
    return (cvar.to(torch.float32) * svar).to(cfg.dtype)


def _cache_put_at(cfg: GPTConfig, cvar, svar, slots: torch.Tensor,
                  a: torch.Tensor, valid: Optional[torch.Tensor] = None
                  ) -> None:
    """Write a [B,H,len(slots),D] at the distinct ``slots`` of the L axis,
    IN PLACE — one definition with :func:`_cache_put_dyn` and
    :func:`_cache_put_rows` of how quantization happens. ``valid``
    [len(slots)] bool keeps a slot's old contents where False (the pad
    tail of a right-padded chunk)."""
    def put(var, upd):
        if valid is not None:
            upd = torch.where(valid[None, None, :, None], upd,
                              var.index_select(2, slots))
        var.index_copy_(2, slots, upd)

    if svar is None:
        put(cvar, a.to(cfg.dtype))
    else:
        q, s = _kv_quant(a)
        put(cvar, q)
        put(svar, s)


def _cache_put_rows(cfg: GPTConfig, cvar, svar, slots: torch.Tensor,
                    a: torch.Tensor,
                    active: Optional[torch.Tensor] = None) -> None:
    """Per-row single-slot write (the ``slot_decode`` step), IN PLACE: row
    b writes ``a[b, :, 0, :]`` at its own slot ``slots[b]``. ``active``
    [B] bool masks the write per row (an inactive row scatters its
    current contents back, so a slot mid-prefill rides the fixed-shape
    step untouched)."""
    def put(var, upd):                                      # upd [B,H,1,X]
        index = slots.view(-1, 1, 1, 1).expand(upd.shape)
        if active is not None:
            upd = torch.where(active.view(-1, 1, 1, 1), upd,
                              var.gather(2, index))
        var.scatter_(2, index, upd)

    if svar is None:
        put(cvar, a.to(cfg.dtype))
    else:
        q, s = _kv_quant(a)
        put(cvar, q)
        put(svar, s)


def _cache_put_span(cfg: GPTConfig, cvar, svar, positions: torch.Tensor,
                    a: torch.Tensor, active: Optional[torch.Tensor],
                    cache_len: int) -> None:
    """Per-row multi-position write (the slot VERIFY step), IN PLACE: row
    b writes ``a[b, :, j, :]`` at its own position ``positions[b, j]``
    (slot = position: the full-cache layout). Positions at or past the
    cache end, and every position of an inactive row, are DROPPED: they
    keep their old contents, never wrap onto a live early position.

    A drop is a write of the old contents, so no index ever leaves the
    cache (on CUDA an out-of-range scatter is a device assert) and no two
    writes of a row share a slot (a scatter with duplicate indices keeps
    one of them at random): each row writes the t distinct slots
    ``[w0, w0 + t)``, w0 = min(idx, L - t), its valid positions at their
    own slots and its dropped ones on the slots of the window below idx,
    rotated as ``w0 + (p - w0) mod t``."""
    t = positions.shape[1]
    w0 = torch.clamp(positions[:, :1], max=cache_len - t)        # [B, 1]
    slots = w0 + torch.remainder(positions - w0, t)              # [B, t]
    keep = positions < cache_len
    if active is not None:
        keep = keep & active[:, None]

    def put(var, upd):                                      # upd [B,H,t,X]
        index = slots[:, None, :, None].expand(upd.shape)
        upd = torch.where(keep[:, None, :, None], upd, var.gather(2, index))
        var.scatter_(2, index, upd)

    if svar is None:
        put(cvar, a.to(cfg.dtype))
    else:
        q, s = _kv_quant(a)
        put(cvar, q)
        put(svar, s)


def _cache_put_dyn(cfg: GPTConfig, cvar, svar, slot: int,
                   a: torch.Tensor) -> None:
    """Write the single position a [B,H,1,D] at ``slot``, IN PLACE (the
    decode step)."""
    if svar is None:
        cvar[:, :, slot:slot + 1, :] = a.to(cfg.dtype)
    else:
        q, s = _kv_quant(a)
        cvar[:, :, slot:slot + 1, :] = q
        svar[:, :, slot:slot + 1, :] = s


#: dropout sites of a layer: the attention output and the MLP output (the
#: embedding is site EMBED_SITE of layer slot 0; block i is slot i + 1)
ATTN_SITE, MLP_SITE, EMBED_SITE = 1, 2, 0


class DropoutKey(NamedTuple):
    """A step's dropout seed on rank ``shard`` of ``shards`` along the
    data axis: masks are drawn for the global batch (``shards`` times
    the rank's rows) and the rank takes its block of rows; in the
    Megatron-SP layout also its block ``tshard`` of ``tshards`` along
    the tokens (dim 1)."""

    seed: int
    shard: int = 0
    shards: int = 1
    tshard: int = 0
    tshards: int = 1


def _dropout(x: torch.Tensor, rate: float, seed, slot: int,
             site: int) -> torch.Tensor:
    """flax's ``nn.Dropout`` with its mask drawn from (seed, slot, site):
    kept values scaled by 1 / (1 - rate). ``seed``: an int or a
    :class:`DropoutKey`; off when None."""
    if seed is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    key = seed if isinstance(seed, DropoutKey) else DropoutKey(seed)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(fold_in(key.seed, slot, site))
    rows, toks = x.shape[0], x.shape[1]
    keep = torch.rand((rows * key.shards, toks * key.tshards) + x.shape[2:],
                      generator=gen, device=x.device)[
        key.shard * rows:(key.shard + 1) * rows,
        key.tshard * toks:(key.tshard + 1) * toks] < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _tp_mesh(mesh):
    """``mesh`` when its model axis splits the model, else None."""
    return mesh if mesh is not None and mesh.model_size > 1 else None


class CausalSelfAttention(nn.Module):
    """Causal attention; over a model group (``mesh``) the rank's heads:
    q/k/v column-parallel, ``heads / m`` (``kv_heads / m``) of them,
    attn_out row-parallel."""

    def __init__(self, cfg: GPTConfig, window: int, device=None,
                 layer: int = 0, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.layer = layer
        #: effective sliding window of THIS layer (0 on a global layer)
        self.window = window
        self.mesh = _tp_mesh(mesh)
        m = self.mesh.model_size if self.mesh is not None else 1
        d_head = cfg.d_model // cfg.heads
        kv = cfg.kv_heads_resolved
        if cfg.heads % m:
            raise ValueError(f"{cfg.heads} heads not divisible by the model "
                             f"axis ({m})")
        if kv % m:
            raise ValueError(f"{kv} kv_heads not divisible by the model "
                             f"axis ({m}) — TP shards the heads over "
                             "'model'")
        if (cfg.heads // m) % cfg.flash_block_h:
            raise ValueError(f"flash_block_h={cfg.flash_block_h} must "
                             f"divide the rank's {cfg.heads // m} heads")
        #: this rank's query and K/V heads
        self.heads, self.kv_heads = cfg.heads // m, kv // m

        def dense(d_in, d_out, parallel):
            return TpDense(d_in, d_out, parallel=parallel, dtype=cfg.dtype,
                           device=device, mesh=self.mesh)

        self.query = dense(cfg.d_model, cfg.heads * d_head, "column")
        self.key = dense(cfg.d_model, kv * d_head, "column")
        self.value = dense(cfg.d_model, kv * d_head, "column")
        self.attn_out = dense(cfg.heads * d_head, cfg.d_model, "row")

    @property
    def cache_len(self) -> int:
        """Rolling buffer under a window (position p in slot p % L, the
        cache holds the last L = window positions); else decode_len."""
        cfg = self.cfg
        return (min(cfg.decode_len, self.window) if self.window
                else cfg.decode_len)

    def init_cache(self, batch: int, device) -> dict:
        """This layer's cache: [B, kv_heads, L, D] keys and values (int8
        with [B, kv_heads, L, 1] f32 scales under ``kv_cache_dtype="int8"``),
        the rank's kv_heads over a model group
        and the position counter ``cache_index``: a Python int shared by
        the rows, or under ``slot_decode`` a [B] int64 tensor, one a row.
        Every key must be in ``_BATCH_LED_CACHE_KEYS`` or
        ``_NON_BATCH_CACHE_KEYS``."""
        cfg = self.cfg
        shape = (batch, self.kv_heads, self.cache_len,
                 cfg.d_model // cfg.heads)
        quant = cfg.kv_cache_dtype == "int8"
        store = torch.int8 if quant else cfg.dtype
        index = (torch.zeros(batch, dtype=torch.long, device=device)
                 if cfg.slot_decode else 0)
        cache = {"cached_key": torch.zeros(shape, dtype=store, device=device),
                 "cached_value": torch.zeros(shape, dtype=store,
                                             device=device),
                 "key_scale": None, "value_scale": None,
                 "cache_index": index}
        if quant:
            for name in ("key_scale", "value_scale"):
                cache[name] = torch.zeros(shape[:3] + (1,),
                                          dtype=torch.float32, device=device)
        return cache

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None,
                chunked: bool = False, dropout_seed=None, prefill_len=None,
                decode_active=None, sp: bool = False) -> torch.Tensor:
        """``sp``: ``x`` is this rank's token block (Megatron-SP) and the
        projections run as rings; the output is the rank's token block."""
        cfg = self.cfg
        d_head = cfg.d_model // cfg.heads
        heads, kv_heads = self.heads, self.kv_heads
        group = heads // kv_heads
        if self.mesh is not None and not sp:
            x = comms.copy_to_model(x, self.mesh)
        b, t = x.shape[0], x.shape[1] * (self.mesh.model_size if sp else 1)
        if prefill_len is not None and not (
                cache is not None and t != 1 and chunked):
            raise ValueError(
                "prefill_len only applies to the chunked-prefill path "
                "(decode_len > 0, chunked_prefill=True, multi-token chunk)")
        if decode_active is not None and not cfg.slot_decode:
            raise ValueError(
                "decode_active only applies to the slot_decode/verify "
                "steps (per-row cache indices)")
        verify = (cfg.slot_decode and cache is not None and t != 1
                  and not chunked)
        if verify and self.window:
            raise ValueError(
                "the slot VERIFY step (slot_decode, multi-token call) needs "
                f"the full windowless cache layout; attn_window={self.window}"
                " rolls the buffer, so a rejected speculative tail would "
                "clobber live positions it cannot roll back")

        def split(y, nh):
            return y.reshape(b, t, nh, d_head).transpose(1, 2)

        q = split(self.query(x, sp), heads)
        k = split(self.key(x, sp), kv_heads)
        v = split(self.value(x, sp), kv_heads)
        if cache is not None and t != 1 and chunked:
            return self._chunked_prefill(q, k, v, cache, prefill_len)
        if verify:
            return self._slot_verify_step(q, k, v, cache, decode_active)
        if cache is not None and t == 1 and cfg.slot_decode:
            return self._slot_decode_step(q, k, v, cache, decode_active)
        if cache is not None and t == 1:
            return self._decode_step(q, k, v, cache)

        positions = torch.arange(t, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cache is not None:
            # one-shot prefill: the last min(L, t) roped-K / V rows land at
            # their rolling slots (slot = pos % L); K/V are unexpanded
            if cache["cache_index"] != 0:
                raise ValueError(
                    "multi-token decode call needs an EMPTY cache (one-shot "
                    "prefill); to continue an advanced cache use "
                    "GPTConfig(chunked_prefill=True) / "
                    "generate(prefill_chunk=...)")
            cache_len = self.cache_len
            keep = min(cache_len, t)
            slots = torch.remainder(
                torch.arange(t - keep, t, device=x.device), cache_len)
            _cache_put_at(cfg, cache["cached_key"], cache["key_scale"],
                          slots, k[:, :, t - keep:, :])
            _cache_put_at(cfg, cache["cached_value"], cache["value_scale"],
                          slots, v[:, :, t - keep:, :])
            cache["cache_index"] += t
        if group > 1:
            # GQA: query head h reads K/V head h // group; autograd sums
            # the gradients of the repeat back onto the kv heads
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
        impl = effective_attn_impl(cfg.attn_impl, x.device)
        if impl == "flash":
            out = flash_attention(q, k, v, causal=True, window=self.window,
                                  block_h=cfg.flash_block_h)
        elif impl == "dense":
            out = dense_attention(q, k, v, causal=True, window=self.window)
        else:
            raise NotImplementedError(
                f"attn_impl={impl!r} (sequence parallelism) is not ported "
                "yet; use 'auto', 'flash' or 'dense'")
        out = out.transpose(1, 2).reshape(b, t, heads * d_head)
        out = self.attn_out(out, sp)
        return _dropout(out, cfg.dropout, dropout_seed, self.layer + 1,
                        ATTN_SITE)

    def _decode_step(self, q, k, v, cache: dict) -> torch.Tensor:
        """One token a row at the shared position ``cache_index`` against
        every cached position <= it (:meth:`_attend_cache`)."""
        cfg = self.cfg
        idx = cache["cache_index"]
        pos = torch.arange(idx, idx + 1, device=q.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        slot = idx % self.cache_len
        _cache_put_dyn(cfg, cache["cached_key"], cache["key_scale"], slot, k)
        _cache_put_dyn(cfg, cache["cached_value"], cache["value_scale"],
                       slot, v)
        cache["cache_index"] = idx + 1
        return self._attend_cache(q, cache, idx)

    def _slot_decode_step(self, q, k, v, cache: dict,
                          active: Optional[torch.Tensor]) -> torch.Tensor:
        """:meth:`_decode_step` with a position counter per row
        (``slot_decode``): rope positions, cache writes and the validity
        bias go row by row. ``active`` [B] bool: an inactive row neither
        writes its cache nor advances its counter (a slot mid-prefill in
        the serving engine). The counter is advanced IN PLACE, after the
        bias has read it."""
        cfg = self.cfg
        idx = cache["cache_index"]                                   # [B]
        q = rope(q, idx[:, None], cfg.rope_theta)
        k = rope(k, idx[:, None], cfg.rope_theta)
        slot = torch.remainder(idx, self.cache_len)
        _cache_put_rows(cfg, cache["cached_key"], cache["key_scale"], slot,
                        k, active)
        _cache_put_rows(cfg, cache["cached_value"], cache["value_scale"],
                        slot, v, active)
        out = self._attend_cache(q, cache, idx[:, None])
        idx.add_(1 if active is None else active.long())
        return out

    def _slot_verify_step(self, q, k, v, cache: dict,
                          active: Optional[torch.Tensor]) -> torch.Tensor:
        """The slot VERIFY step of speculative decoding: t tokens a row
        (the pending token and the draft's proposals), each row at its own
        position. Query j computes what the j-th of t sequential
        :meth:`_slot_decode_step` calls would: all t K/V land first
        (:func:`_cache_put_span`; writes past the cache end drop), every
        query reads the post-write cache, and query j's validity bias is
        the one-token formula at position idx + j. Active rows advance by
        t, IN PLACE; the caller rolls the index back to the accepted
        boundary (:func:`cache_rollback`) — rejected K/V needs no
        clearing, validity derives from the index."""
        cfg = self.cfg
        t = q.shape[2]
        idx = cache["cache_index"]                                   # [B]
        qpos = idx[:, None] + torch.arange(t, device=q.device)       # [B,t]
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, qpos, cfg.rope_theta)
        _cache_put_span(cfg, cache["cached_key"], cache["key_scale"], qpos,
                        k, active, self.cache_len)
        _cache_put_span(cfg, cache["cached_value"], cache["value_scale"],
                        qpos, v, active, self.cache_len)
        out = self._attend_cache(q, cache, qpos)
        idx.add_(t if active is None else t * active.long())
        return out

    def _attend_cache(self, q, cache: dict, idx) -> torch.Tensor:
        """t query tokens a row ([B,H,t,D]) against every cached position
        <= its own: ``idx`` is the queries' position — an int (t = 1),
        or per row and query [B, t]. The grouped einsum reads the
        UN-expanded cache (query head kv*group + g reads shared head kv).
        Slot s holds position p_s = idx - ((idx - s) mod L), the newest
        position <= idx congruent to s; valid iff p_s >= 0 — which also
        makes a reused slot's stale contents invisible."""
        cfg = self.cfg
        b, _, t, d_head = q.shape
        kv_heads = self.kv_heads
        group = self.heads // kv_heads
        cache_len = self.cache_len
        slots = torch.arange(cache_len, device=q.device)
        if not isinstance(idx, int):
            idx = idx[..., None]                                 # [B,t,1]
        p_s = idx - torch.remainder(idx - slots, cache_len)     # [L]|[B,t,L]
        bias = torch.zeros(p_s.shape, device=q.device).masked_fill(
            p_s < 0, _NEG_INF)
        if bias.ndim == 3:
            bias = bias[:, None, None]
        keys = _cache_read(cfg, cache["cached_key"], cache["key_scale"])
        vals = _cache_read(cfg, cache["cached_value"], cache["value_scale"])
        qg = q.reshape(b, kv_heads, group, t, d_head)
        s = torch.einsum("bkgtd,bkld->bkgtl", qg.float(), keys.float())
        s = s * d_head ** -0.5 + bias
        p = torch.softmax(s, dim=-1)      # >= 1 valid key: no dead rows
        out = torch.einsum("bkgtl,bkld->bkgtd", p.to(vals.dtype).float(),
                           vals.float())
        out = out.to(cfg.dtype).permute(0, 3, 1, 2, 4)
        return self.attn_out(out.reshape(b, t, self.heads * d_head))

    def _chunked_prefill(self, q, k, v, cache: dict,
                         prefill_len=None) -> torch.Tensor:
        """Continue a (possibly advanced) cache with a t-token chunk: rope
        positions and slots offset by cache_index; the chunk attends the
        PRE-write cache snapshot plus its own K/V, so a rolling buffer that
        wraps inside the chunk cannot evict keys an earlier query sees.

        ``prefill_len`` (an int or a 0-d tensor): the chunk is
        RIGHT-PADDED and only its first ``prefill_len`` tokens are real
        (the serving engine's fixed-width prefill). The causal mask hides
        the pad from every real query; the pad's K/V is not written (a
        slot it would land on keeps its contents, which may be a live
        position of a rolling buffer) and the index advances by the valid
        count only."""
        cfg = self.cfg
        b, _, t, d_head = q.shape
        kv_heads = self.kv_heads
        group = self.heads // kv_heads
        cache_len = self.cache_len
        start = cache["cache_index"]
        qpos = start + torch.arange(t, device=q.device)
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, qpos, cfg.rope_theta)
        k_old = _cache_read(cfg, cache["cached_key"], cache["key_scale"])
        v_old = _cache_read(cfg, cache["cached_value"], cache["value_scale"])
        if cache["key_scale"] is None:
            # _cache_read returned the cache itself; the write below is in
            # place, so keep the snapshot
            k_old, v_old = k_old.clone(), v_old.clone()
        keep = min(cache_len, t)
        wslots = torch.remainder(qpos[t - keep:], cache_len)
        valid = (None if prefill_len is None else
                 torch.arange(t - keep, t, device=q.device) < prefill_len)
        _cache_put_at(cfg, cache["cached_key"], cache["key_scale"], wslots,
                      k[:, :, t - keep:, :], valid)
        _cache_put_at(cfg, cache["cached_value"], cache["value_scale"],
                      wslots, v[:, :, t - keep:, :], valid)
        cache["cache_index"] = start + (t if prefill_len is None
                                        else prefill_len)
        # cache slots as of idx_old = start - 1 (all older than the chunk)
        slots = torch.arange(cache_len, device=q.device)
        idx_old = start - 1
        p_s = idx_old - torch.remainder(idx_old - slots, cache_len)
        ok_old = (p_s[None, :] >= 0).expand(t, cache_len)
        ok_new = qpos[None, :] <= qpos[:, None]            # intra-chunk causal
        if self.window:
            ok_old = ok_old & (p_s[None, :] > qpos[:, None] - self.window)
            ok_new = ok_new & (qpos[None, :] > qpos[:, None] - self.window)
        ok = torch.cat([ok_old, ok_new], dim=1)                 # [t, L+t]
        bias = torch.zeros(ok.shape, device=q.device).masked_fill(
            ~ok, _NEG_INF)
        keys = torch.cat([k_old, k.to(cfg.dtype)], dim=2)
        vals = torch.cat([v_old, v.to(cfg.dtype)], dim=2)
        qg = q.reshape(b, kv_heads, group, t, d_head)
        s = torch.einsum("bkgtd,bkld->bkgtl", qg.float(), keys.float())
        s = s * d_head ** -0.5 + bias
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgtl,bkld->bkgtd", p.to(vals.dtype).float(),
                           vals.float())
        out = out.to(cfg.dtype).permute(0, 3, 1, 2, 4)
        return self.attn_out(out.reshape(b, t, self.heads * d_head))


class Block(nn.Module):
    """Pre-LN block: LayerNorm in f32 with eps 1e-6 (flax's), tanh GELU.
    Over a model group the MLP is Megatron's pair: mlp_in
    column-parallel (GELU on the rank's ``d_ff / m`` features), mlp_out
    row-parallel."""

    def __init__(self, cfg: GPTConfig, window: int, device=None,
                 layer: int = 0, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.layer = layer
        self.mesh = _tp_mesh(mesh)
        f32 = torch.float32
        self.ln1 = nn.LayerNorm(cfg.d_model, eps=1e-6, dtype=f32,
                                device=device)
        self.attention = CausalSelfAttention(cfg, window, device=device,
                                             layer=layer, mesh=mesh)
        self.ln2 = nn.LayerNorm(cfg.d_model, eps=1e-6, dtype=f32,
                                device=device)
        self.mlp_in = TpDense(cfg.d_model, cfg.d_ff, parallel="column",
                              dtype=cfg.dtype, device=device, mesh=mesh)
        self.mlp_out = TpDense(cfg.d_ff, cfg.d_model, parallel="row",
                               dtype=cfg.dtype, device=device, mesh=mesh)

    def forward(self, x, cache=None, chunked=False, dropout_seed=None,
                prefill_len=None, decode_active=None, sp=False):
        """``sp``: ``x`` is this rank's token block (Megatron-SP); the
        LayerNorms, the residual adds and dropout see only its tokens."""
        h = self.ln1(x.float())
        x = x + self.attention(h, cache, chunked, dropout_seed, prefill_len,
                               decode_active, sp)
        h = self.ln2(x.float())
        if self.mesh is not None and not sp:
            h = comms.copy_to_model(h, self.mesh)
        y = self.mlp_out(F.gelu(self.mlp_in(h, sp), approximate="tanh"), sp)
        return x + _dropout(y, self.cfg.dropout, dropout_seed,
                            self.layer + 1, MLP_SITE)


class GPT(nn.Module):
    """Decoder-only LM. ids [B,T] → f32 logits [B,T,V] (or the f32 hidden
    states with ``return_hidden=True``). Parameter names mirror the flax
    tree (``token_embed``, ``layer_{i}.attention.query``, ``ln_f``,
    ``lm_head`` …) so :mod:`dtf_tpu_torch.convert` maps them one to one.

    ``mesh`` with a model axis of m > 1: Megatron tensor parallelism over
    its model group, the parameters this rank's blocks
    (:data:`tp_rules`, :func:`tp_shard`), and the logits this rank's V/m
    vocab columns (module docstring); a decode model's cache holds the
    rank's heads."""

    def __init__(self, cfg: GPTConfig, device="cuda", mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.mesh = _tp_mesh(mesh)
        m = self.mesh.model_size if self.mesh is not None else 1
        if cfg.vocab_size % m:
            raise ValueError(f"vocab {cfg.vocab_size} not divisible by the "
                             f"model axis ({m})")
        f32 = torch.float32
        self.token_embed = nn.Embedding(cfg.vocab_size // m, cfg.d_model,
                                        dtype=f32, device=device)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", Block(cfg, cfg.layer_window(i),
                                                device=device, layer=i,
                                                mesh=mesh))
        self.ln_f = nn.LayerNorm(cfg.d_model, eps=1e-6, dtype=f32,
                                 device=device)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size // m,
                                 bias=False, dtype=f32, device=device)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def vocab_rows(self, logits: torch.Tensor) -> torch.Tensor:
        """Whole-vocabulary rows of this model's logits: over a model
        group the head is vocab-parallel and a rank holds V/m columns, so
        one counted all-gather over the group (:func:`comms.gather_vocab`,
        the gather GSPMD inserts before a sampler) makes them whole. Pass
        only the rows that are sampled; without a model group ``logits``
        as they are."""
        if self.mesh is None:
            return logits
        return comms.gather_vocab(logits, self.mesh)

    def sp_layout(self, ids_shape) -> bool:
        """Whether a forward of ids ``ids_shape`` [B, T] runs the
        Megatron-SP layout: ``tp_overlap`` over a model axis, where
        ``comms.tp_overlap_viable`` allows (T divisible by it)."""
        cfg = self.cfg
        return cfg.tp_overlap and comms.tp_overlap_viable(
            (*ids_shape, cfg.d_model), self.mesh)

    def blocks(self) -> list[Block]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.layers)]

    def init_cache(self, batch: int) -> list[dict]:
        """An empty KV cache (index 0, nothing written), one dict per layer,
        sized by ``cfg.decode_len`` and each layer's window."""
        if self.cfg.decode_len <= 0:
            raise ValueError("init_cache needs cfg.decode_len > 0")
        return [blk.attention.init_cache(batch, self.device)
                for blk in self.blocks()]

    def forward(self, input_ids: torch.Tensor, cache: Optional[list] = None,
                *, chunked_prefill: Optional[bool] = None,
                return_hidden: bool = False,
                dropout_seed=None, prefill_len=None,
                decode_active=None) -> torch.Tensor:
        """``dropout_seed``: this step's seed (an int, or a
        :class:`DropoutKey` under data parallelism); None (serving) runs
        no dropout. Under ``cfg.remat`` each block's activations are
        recomputed in the backward (training calls only: no cache).

        ``chunked_prefill`` overrides ``cfg.chunked_prefill`` for this
        call (the serving engine runs its prefill chunks through the
        ``slot_decode`` model on one row's plain cache). ``prefill_len``:
        the valid count of a right-padded chunk; ``decode_active`` [B]
        bool: the rows a ``slot_decode`` step advances."""
        cfg = self.cfg
        if (cfg.decode_len > 0) != (cache is not None):
            raise ValueError(
                "decode mode (cfg.decode_len > 0) runs against a KV cache "
                "and only then: pass cache=model.init_cache(batch)")
        chunked = (cfg.chunked_prefill if chunked_prefill is None
                   else chunked_prefill)
        mesh = self.mesh
        # nn.Embed(dtype=bf16) casts the f32 table; casting the gathered
        # rows gives the same values
        if mesh is None:
            x = F.embedding(input_ids, self.token_embed.weight).to(cfg.dtype)
        else:
            # the vocab-parallel table: this rank's rows, zeros elsewhere,
            # summed over the group
            x = masked_lookup_sharded(self.token_embed.weight, input_ids,
                                      mesh.model_group, dtype=cfg.dtype)
        x = _dropout(x, cfg.dropout, dropout_seed, 0, EMBED_SITE)
        # a decode call keeps every token on every rank of the group: the
        # cache holds the rank's heads at every position
        sp = cache is None and self.sp_layout(input_ids.shape)
        seed = dropout_seed
        if sp:
            x = comms.scatter_tokens(x, mesh)
            if seed is not None:
                seed = (seed if isinstance(seed, DropoutKey)
                        else DropoutKey(seed))._replace(
                    tshard=mesh.model_index, tshards=mesh.model_size)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks()):
            if remat:
                x = checkpoint(blk, x, None, chunked, seed, None, None, sp,
                               use_reentrant=False)
            else:
                x = blk(x, None if cache is None else cache[i], chunked,
                        seed, prefill_len, decode_active, sp)
        x = self.ln_f(x.float())
        if return_hidden:
            if mesh is not None:
                raise ValueError(
                    "return_hidden over a model axis: the head is "
                    "vocab-parallel, and a head applied outside the model "
                    "would need it whole")
            return x
        if sp:
            x = comms.gather_tokens(x, mesh)     # the one gather, at the head
        elif mesh is not None:
            x = comms.copy_to_model(x, mesh)
        return self.lm_head(x)                         # f32 head


def filter_logits(logits: torch.Tensor, *, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Top-k / nucleus filtering: disallowed logits become -inf. Exactly
    k tokens survive the k-filter (ties at the k-th logit broken by token
    index, through a stable double argsort); the nucleus is built over
    the k-survivors; the top token is always kept. Pass tempered logits."""
    if top_k <= 0 and top_p >= 1.0:
        return logits
    vocab = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    if top_k > 0:
        k = min(top_k, vocab)
        order = torch.argsort(-logits, dim=-1, stable=True)
        ranks = torch.argsort(order, dim=-1, stable=True)   # 0 = largest
        logits = logits.masked_fill(ranks >= k, _NEG_INF)
        desc = desc.masked_fill(
            torch.arange(vocab, device=logits.device) >= k, _NEG_INF)
    if top_p < 1.0:
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p       # the first excluded crosses top_p
        thresh = torch.where(keep, desc, torch.full_like(desc, float("inf"))
                             ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, _NEG_INF)
    return logits


def filter_logits_dynamic(logits: torch.Tensor, *, top_k: torch.Tensor,
                          top_p: torch.Tensor) -> torch.Tensor:
    """:func:`filter_logits` with a ``top_k`` [B] and a ``top_p`` [B] a
    row (the serving engine's slots each carry their own). Same semantics,
    no-op gates included: the k-filter applies only where ``top_k > 0``
    and the nucleus only where ``top_p < 1``, so a row at (0, 1.0) keeps
    its logits bit for bit. Fixed work whatever the values: no host
    sync, one shape."""
    vocab = logits.shape[-1]
    cols = torch.arange(vocab, device=logits.device)
    desc = torch.sort(logits, dim=-1, descending=True).values
    k = top_k.clamp(1, vocab)[:, None]            # only read where top_k > 0
    order = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(     # 0 = largest logit
        -1, order, cols.expand_as(order))
    use_k = (top_k > 0)[:, None]
    logits = logits.masked_fill(use_k & (ranks >= k), _NEG_INF)
    desc = desc.masked_fill(use_k & (cols >= k), _NEG_INF)
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    thresh = torch.where(keep, desc, torch.full_like(desc, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return logits.masked_fill((top_p < 1.0)[:, None] & (logits < thresh),
                              _NEG_INF)


_M32 = 0xFFFFFFFF
#: odd 32-bit constants: the golden-ratio Weyl step for the draw counter
#: and murmur3's for the vocabulary index
_WEYL_DRAW, _WEYL_COL = 0x9E3779B9, 0x85EBCA6B


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for x in [0, 2**32) in int64 lanes, with c
    split in 16-bit halves so that no partial product leaves int64 (a
    wrapped int64 product is not defined alike on every device)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (lowbias32): a bijection of [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sampler_key(seed: torch.Tensor, stream: torch.Tensor) -> torch.Tensor:
    """A row's 32-bit sampler key from its int64 ``seed`` and its
    ``stream`` (the row of a ``generate`` batch; 0 for an engine slot, so
    a request's tokens equal batch-1 ``generate``'s)."""
    key = _mix32((seed >> 32) & _M32)
    key = _mix32(key ^ (seed & _M32))
    return _mix32(key ^ (stream & _M32))


def gumbel_noise(key: torch.Tensor, draw: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[B, vocab] f64 standard Gumbel noise of each row's ``draw``-th
    token: a counter-based hash of (key, draw, vocab index) gives 32
    uniform bits, the same on every device; -log(-log(u)) is taken in
    f64."""
    step = _mix32((key + draw * _WEYL_DRAW) & _M32)
    cols = (torch.arange(vocab, device=key.device) * _WEYL_COL) & _M32
    bits = _mix32(step[:, None] ^ cols[None, :])
    u = (bits.double() + 0.5) * 2.0 ** -32
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, *, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  key: torch.Tensor, draw: torch.Tensor) -> torch.Tensor:
    """One token a row from f32 logits [B, V], every argument a [B]
    tensor: greedy (``argmax``, the lowest index of a tie) where
    ``temperature`` is 0, else Gumbel-max over the tempered, filtered
    logits (:func:`filter_logits_dynamic`) with the noise of
    (``key``, ``draw``). A row's stream depends on its key and on how
    many tokens it has drawn, never on the other rows; no host sync.
    The stream is not ``jax.random.categorical``'s; its distribution is
    the filtered softmax's."""
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    filt = filter_logits_dynamic(logits / safe_t[:, None], top_k=top_k,
                                 top_p=top_p)
    score = filt.double() + gumbel_noise(key, draw, logits.shape[-1])
    return torch.where(temperature > 0, torch.argmax(score, dim=-1), greedy)


def generate(model: GPT, prompt: torch.Tensor, n_new: int, *,
             seed: int = 0, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_id: Optional[int] = None, pad_id: int = 0,
             prefill_chunk: int = 0,
             mesh=None) -> torch.Tensor:
    """Autoregressive decode: one prefill over the prompt, then one token
    per step against the KV cache. ``prompt`` [B, T_p] ints; returns
    [B, T_p + n_new] int64 on the model's device.

    Greedy at ``temperature == 0``; else :func:`sample_tokens` (tempered
    FIRST, then filtered, then drawn) with row r's stream keyed by
    (``seed``, r) — as the reference's ``rng`` key, ``seed`` fixes the
    whole output, and row 0's tokens are those the serving engine draws
    for a request with that seed.

    ``eos_id``: once a sequence emits it, every later token is ``pad_id``
    (``done`` flips after the EOS token itself is kept).
    ``prefill_chunk > 0``: prefill through the cache-continuing chunked
    path, that many tokens per call.

    ``mesh``: sharded decode, the reference's ``generate(mesh=)`` — every
    rank passes the whole prompt; data line d decodes its rows [d·B/D,
    (d+1)·B/D) (each row keeps its GLOBAL stream (``seed``, r), so a
    sampled row does not change with the mesh), the model (built over the
    mesh, :func:`tp_shard` parameters) holds the rank's heads and their
    cache, the sampled rows' logits are gathered whole over the model
    group (:meth:`GPT.vocab_rows`), and the output is all-gathered over
    the data group: every rank returns [B, T_p + n_new].
    """
    cfg = model.cfg
    b, t_p = prompt.shape
    total = t_p + n_new
    if n_new < 1:
        raise ValueError(f"n_new={n_new} must be >= 1")
    if cfg.decode_len < total:
        raise ValueError(
            f"decode_len={cfg.decode_len} < prompt+new={total}")
    device = model.device
    rows = torch.arange(b, device=device)
    if mesh is not None:
        check_decode_mesh(model, mesh, batch=b)
        n = b // mesh.data_size
        prompt = prompt[mesh.data_index * n:(mesh.data_index + 1) * n]
        rows = rows[mesh.data_index * n:(mesh.data_index + 1) * n]
        b = n
    prompt = prompt.to(device=device, dtype=torch.long)

    def row(value, dtype):
        return torch.full((b,), value, dtype=dtype, device=device)

    if temperature > 0.0:
        sampling = {"temperature": row(temperature, torch.float32),
                    "top_k": row(top_k, torch.long),
                    "top_p": row(top_p, torch.float32),
                    "key": sampler_key(row(seed, torch.long), rows)}

    def pick(nxt_logits, draw):
        nxt_logits = model.vocab_rows(nxt_logits)
        if temperature > 0.0:
            return sample_tokens(nxt_logits, draw=row(draw, torch.long),
                                 **sampling)
        return torch.argmax(nxt_logits, dim=-1)

    with torch.no_grad():
        cache = model.init_cache(b)
        logits = _prefill(model, cache, prompt, prefill_chunk)
        tok = pick(logits[:, -1], 0)
        done = (tok == eos_id) if eos_id is not None else None
        toks = [tok]
        for draw in range(1, n_new):
            logits = model(tok[:, None], cache)
            nxt = pick(logits[:, 0], draw)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
                done = done | (nxt == eos_id)
            toks.append(nxt)
            tok = nxt
    out = torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
    if mesh is not None and mesh.data_size > 1:
        out = comms.gather_rows(out, mesh.data_group)
    return out


def check_decode_mesh(model: GPT, mesh, *,
                      batch: Optional[int] = None) -> None:
    """The reference's checks of a sharded decode (its words): ``batch``
    rows over the data axis, the heads and the K/V heads over the model
    axis — and the port's own, the model built over that mesh."""
    cfg = model.cfg
    d, m = mesh.data_size, mesh.model_size
    if batch is not None and batch % d:
        raise ValueError(f"decode batch {batch} not divisible by the data "
                         f"axis ({d})")
    kv_heads = cfg.kv_heads_resolved
    if cfg.heads % m:
        raise ValueError(f"{cfg.heads} heads not divisible by the model "
                         f"axis ({m})")
    if kv_heads % m:
        raise ValueError(f"{kv_heads} kv_heads not divisible by the model "
                         f"axis ({m}) — the cache shards heads over 'model'")
    if (model.mesh.model_size if model.mesh is not None else 1) != m:
        raise ValueError(f"a mesh with a model axis of {m} needs the model "
                         "built over it: GPT(cfg, mesh=mesh) with "
                         "tp_shard(params, mesh)")


def tp_shard(params: dict, mesh) -> dict:
    """This rank's blocks of a WHOLE state dict over ``mesh``'s model axis
    (:data:`tp_rules`, contiguous), for ``load_state_dict`` of a
    ``GPT(mesh=mesh)``; ``params`` itself without a model axis. Names
    that several dicts share (an early-exit draft's,
    :func:`draft_truncate`) should be sharded once and truncated after,
    so the blocks stay shared tensors."""
    if mesh is None or mesh.model_size <= 1:
        return params
    from dtf_tpu_torch.convert import shard_params
    from dtf_tpu_torch.core.sharding import Layout, param_specs

    dims = {n: spec.index("model")
            for n, spec in param_specs(params, tp_rules).items()
            if "model" in spec}
    return shard_params(params, Layout(model_dims=dims, zero1_dims={}), mesh)


#: cache keys whose tensors lead with the batch (the serving engine slices
#: a slot's rows out of exactly these); every other key must be in
#: _NON_BATCH_CACHE_KEYS, so an unknown key fails loudly instead of riding
#: a slot unsliced
_BATCH_LED_CACHE_KEYS = frozenset(
    {"cached_key", "cached_value", "key_scale", "value_scale"})
_NON_BATCH_CACHE_KEYS = frozenset({"cache_index"})


def batch_led_cache_key(name: str) -> bool:
    """True for a batch-led cache key, False for the index; loud
    otherwise — the completeness contract of ``_BATCH_LED_CACHE_KEYS``."""
    if name in _NON_BATCH_CACHE_KEYS:
        return False
    if name not in _BATCH_LED_CACHE_KEYS:
        raise ValueError(
            f"unknown cache leaf {name!r}: add it to _BATCH_LED_CACHE_KEYS "
            "or _NON_BATCH_CACHE_KEYS so the serving engine and beam search "
            "know whether to slice or reorder it")
    return True


def _map_batch_led(cache: list, fn, lead: int) -> None:
    """Replace every batch-led leaf of every layer by ``fn(leaf)``, IN
    PLACE (the dicts; the tensors may be new). Leaves are chosen by key
    (:func:`batch_led_cache_key`), never by their leading size: an unknown
    key raises instead of riding the beams unreordered."""
    for layer in cache:
        for name, x in list(layer.items()):
            if not batch_led_cache_key(name) or x is None:
                continue
            if x.shape[0] != lead:
                raise ValueError(f"cache leaf {name!r} leads with "
                                 f"{x.shape[0]}, expected {lead}")
            layer[name] = fn(x)


def _beam_topk(flat: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The k + 1 largest entries of each row of ``flat`` (k + 1 for the
    margin of the k-th) and their indices, equal values in index order —
    ``jax.lax.top_k``'s order, which ``torch.topk`` does not promise for
    ties (frozen beams and the -inf start scores make ties common): a
    stable descending sort."""
    values, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    return values[:, :k + 1], idx[:, :k + 1]


def generate_beam(model: GPT, prompt: torch.Tensor, n_new: int, *,
                  num_beams: int = 4, eos_id: Optional[int] = None,
                  pad_id: int = 0, length_penalty: float = 0.0,
                  prefill_chunk: int = 0, return_scores: bool = False):
    """Fixed-width beam search: [B, T_p] → [B, T_p + n_new] int64 on the
    model's device (the reference's ``generate_beam``).

    The prompt is prefilled ONCE at batch B (through the flash forward on
    the card with ``prefill_chunk=0``), then every batch-led cache leaf is
    repeated k-fold: rows ``b*k + i`` are batch b's beams, and only the
    last position's logits are kept. Every step takes the log-softmax in
    f32, keeps the global top k of k·V candidates a row (equal totals in
    flat-index order, as ``jax.lax.top_k``), and reorders the batch-led
    leaves (int8 scales included) by parent. A beam that emitted
    ``eos_id`` is frozen: its one continuation is ``pad_id`` at 0 added
    log-prob. ``length_penalty`` alpha rescores the finals by
    ``score / len**alpha`` (0 = the sum of log-probs); the best final is
    backtraced through the (parent, token) lattice.

    ``return_scores``: return ``(tokens, scores, margins)`` — the
    returned beam's sum of log-probs [B] (before any length penalty) and,
    at each step, the k-th best candidate total less the (k+1)-th
    [n_new, B] (inf where k·V has no (k+1)-th): how near a step was to
    keeping another beam."""
    cfg = model.cfg
    b, t_p = prompt.shape
    k = num_beams
    if k < 1:
        raise ValueError(f"num_beams={k} must be >= 1")
    if n_new < 1:
        raise ValueError(f"n_new={n_new} must be >= 1")
    if cfg.decode_len < t_p + n_new:
        raise ValueError(
            f"decode_len={cfg.decode_len} < prompt+new={t_p + n_new}")
    device = model.device
    prompt = prompt.to(device=device, dtype=torch.long)
    base = torch.arange(b, device=device)[:, None] * k

    margins = []

    def expand(scores, logprobs, done):
        """(scores [B,k], logprobs [B,k,V], done [B,k]) → the top-k
        beams: (new scores, parent [B,k], token [B,k], new done)."""
        v = logprobs.shape[-1]
        if eos_id is not None:
            frozen = torch.full((v,), _NEG_INF, device=device)
            frozen[pad_id] = 0.0
            logprobs = torch.where(done[:, :, None], frozen, logprobs)
        values, idx = _beam_topk(
            (scores[:, :, None] + logprobs).reshape(b, k * v), k)
        if return_scores:
            margins.append(values[:, k - 1] - values[:, k]
                           if values.shape[1] > k
                           else torch.full((b,), float("inf"),
                                           device=device))
        new_scores, idx = values[:, :k], idx[:, :k]
        parent, token = idx // v, idx % v
        new_done = done.gather(1, parent)
        if eos_id is not None:
            new_done = new_done | (token == eos_id)
        return new_scores, parent, token, new_done

    def reorder(cache, parent):
        rows = (base + parent).reshape(-1)
        # advanced indexing copies before the write: no aliasing
        _map_batch_led(cache, lambda x: x.copy_(x.index_select(0, rows)),
                       b * k)

    with torch.no_grad():
        cache = model.init_cache(b)
        last = _prefill(model, cache, prompt, prefill_chunk)[:, -1]
        _map_batch_led(cache, lambda x: x.repeat_interleave(k, dim=0), b)
        logprobs = F.log_softmax(last.float(), dim=-1)[:, None].expand(
            b, k, -1)
        # beams 1..k-1 start at -inf, so the first top-k comes from beam 0
        scores = torch.where(torch.arange(k, device=device) == 0, 0.0,
                             _NEG_INF).expand(b, k)
        done = torch.zeros(b, k, dtype=torch.bool, device=device)
        scores, parent, tok, done = expand(scores, logprobs, done)
        reorder(cache, parent)
        lens = torch.ones(b, k, device=device)                # emitted
        parents, tokens = [parent], [tok]
        for _ in range(n_new - 1):
            logits = model(tok.reshape(b * k, 1), cache)[:, 0]
            logprobs = F.log_softmax(logits.float(), dim=-1).reshape(b, k,
                                                                     -1)
            scores, parent, tok, new_done = expand(scores, logprobs, done)
            was_done = done.gather(1, parent)
            lens = lens.gather(1, parent) + (~was_done).float()
            done = new_done
            reorder(cache, parent)
            parents.append(parent)
            tokens.append(tok)
        final = scores
        if length_penalty:
            final = scores / lens.clamp_min(1.0) ** length_penalty
        idx = torch.argmax(final, dim=1)[:, None]                  # [B, 1]
        best = scores.gather(1, idx)[:, 0]
        out = []
        for parent, tok in zip(reversed(parents), reversed(tokens)):
            out.append(tok.gather(1, idx)[:, 0])
            idx = parent.gather(1, idx)
    tokens = torch.cat([prompt, torch.stack(out[::-1], dim=1)], dim=1)
    if return_scores:
        return tokens, best, torch.stack(margins)
    return tokens


def cache_index_of(cache: list):
    """The cache's position counter — the first layer's ``cache_index``.
    Every layer's counter advances in lockstep (each call touches all
    layers equally), so one is the whole cache's position."""
    for layer in cache:
        if "cache_index" in layer:
            return layer["cache_index"]
    raise ValueError("cache has no cache_index leaf")


def cache_rollback(cache: list, new_index: torch.Tensor,
                   active: Optional[torch.Tensor] = None) -> list:
    """Set every layer's ``cache_index`` to ``new_index``, IN PLACE — the
    speculative-decode ROLLBACK: after a verify step wrote k + 1 candidate
    positions, the accepted boundary is a per-row index assignment and
    nothing else (rejected K/V stays as stale bytes the validity bias
    hides). ``active`` [S] bool keeps the other rows' counters (a slot
    mid-prefill must not take its neighbours' boundary). Returns
    ``cache``."""
    for layer in cache:
        ci = layer["cache_index"]
        new = torch.as_tensor(new_index, dtype=ci.dtype,
                              device=ci.device).expand(ci.shape)
        ci.copy_(new if active is None else torch.where(active, new, ci))
    return cache


def draft_truncate(cfg: GPTConfig, params: dict, n_layers: int
                   ) -> tuple[GPTConfig, dict]:
    """An EARLY-EXIT draft from a trained state dict: the first
    ``n_layers`` blocks with the embedding, final LayerNorm and head,
    reused as the speculative draft — a draft without a second
    checkpoint. The verifier samples every delivered token, so proposal
    quality moves only the acceptance rate. The returned dict holds the
    SAME tensors as ``params`` (no copy)."""
    if not 1 <= n_layers < cfg.layers:
        raise ValueError(
            f"draft n_layers={n_layers} must be in [1, {cfg.layers}) — "
            "a draft at full depth proposes at full cost")
    if cfg.moe_every:
        raise ValueError("draft_truncate does not support MoE configs "
                         "(the decode stack has no MoE path)")
    keep = ("token_embed.", "ln_f.", "lm_head.") + tuple(
        f"layer_{i}." for i in range(n_layers))
    missing = [p for p in keep if not any(n.startswith(p) for n in params)]
    if missing:
        raise ValueError(f"params are missing {missing} — not a GPT state "
                         "dict?")
    return (dataclasses.replace(cfg, layers=n_layers),
            {n: x for n, x in params.items() if n.startswith(keep)})


def early_exit_draft(cfg: GPTConfig, n_layers: int, params: dict) -> dict:
    """The draft parameters of :func:`draft_truncate` alone: with
    ``functools.partial(early_exit_draft, cfg, n)`` a picklable draft
    factory (a sharded fleet's swap sends it to every rank)."""
    return draft_truncate(cfg, params, n_layers)[1]


def _paged(cache: list, pool: list) -> tuple[list, int, int, int]:
    """(cache tensor, pool tensor) of every batch-led leaf of every layer
    — the leaves the page pool holds (int8 caches bring their scales),
    with the pool's page count P, the page width p and the pages a slot
    holds m, shared by every leaf."""
    pairs = [(x, player[name]) for layer, player in zip(cache, pool)
             for name, x in layer.items()
             if batch_led_cache_key(name) and x is not None]
    leaf, pleaf = pairs[0]
    n_pages, page = pleaf.shape[0], pleaf.shape[2]
    return pairs, n_pages, page, leaf.shape[2] // page


def cache_load_pages(cache: list, pool: list, slot: torch.Tensor,
                     page_ids: torch.Tensor, n_valid: torch.Tensor) -> None:
    """The paged READ, IN PLACE: pool pages ``page_ids[:n_valid]`` land in
    the leading positions of slot ``slot`` ([1] int64) of every batch-led
    leaf, one fixed-shape gather a leaf whatever the chain's length.
    Cache leaves are [S, H, L, D], pool leaves [P, H, p, D] with L =
    len(page_ids) * p; positions past ``n_valid`` pages keep their
    contents. Ids past ``n_valid`` may be anything: they are clamped into
    the pool before the gather and their rows masked back. Copies are
    bitwise."""
    pairs, n_pages, p, m = _paged(cache, pool)
    ids = page_ids.clamp(0, n_pages - 1)
    mask = (torch.arange(m * p, device=ids.device)
            < n_valid * p)[None, :, None]
    for leaf, pleaf in pairs:
        flat = pleaf.index_select(0, ids).transpose(0, 1).reshape(
            leaf.shape[1], m * p, leaf.shape[3])
        cur = leaf.index_select(0, slot)[0]
        leaf.index_copy_(0, slot, torch.where(mask, flat, cur)[None])


def cache_save_pages(cache: list, pool: list, slot: torch.Tensor,
                     page_ids: torch.Tensor) -> None:
    """The paged WRITE, IN PLACE: slot ``slot``'s cache row, split into
    pages, goes to pool entries ``page_ids`` — page j to ``page_ids[j]`` —
    one fixed-shape scatter a leaf. An id outside [0, P) DROPS its page,
    the fixed-shape spelling of "save only the new pages".

    No index leaves the pool (on CUDA that is a device assert): a dropped
    page writes the first kept page's value to the first kept page's id
    again, so duplicate indices carry one value and the scatter is
    deterministic; with none kept, one pool page is written back onto
    itself."""
    pairs, n_pages, p, m = _paged(cache, pool)
    keep = (page_ids >= 0) & (page_ids < n_pages)
    first = torch.argmax(keep.to(torch.int32))           # 0 when none kept
    src = torch.where(keep, torch.arange(m, device=keep.device), first)
    dst = torch.where(keep, page_ids,
                      page_ids.index_select(0, first.reshape(1))).clamp(
        0, n_pages - 1)
    any_kept = keep.any()
    for leaf, pleaf in pairs:
        pages = leaf.index_select(0, slot)[0].reshape(
            leaf.shape[1], m, p, leaf.shape[3]).transpose(0, 1)
        upd = torch.where(any_kept, pages.index_select(0, src),
                          pleaf.index_select(0, dst))
        pleaf.index_copy_(0, dst, upd)


def _prefill(model: GPT, cache: list, prompt: torch.Tensor,
             prefill_chunk: int) -> torch.Tensor:
    """The prompt prefill: one causal forward that writes the cache, or —
    with ``prefill_chunk`` — a loop of cache-continuing chunk calls.
    Returns the last call's logits; the cache is written in place."""
    if prefill_chunk > 0:
        logits = None
        for s0 in range(0, prompt.shape[1], prefill_chunk):
            logits = model(prompt[:, s0:s0 + prefill_chunk], cache,
                           chunked_prefill=True)
        return logits
    return model(prompt, cache)


def _fused_ce(loss_chunk: int, loss_chunk_tokens: int,
              loss_pallas: bool = False, mesh=None, model=None):
    """Resolve the head-fused CE options to one callable on
    ``(hidden, lm_head.weight, labels)``, or None for the monolithic
    logits. Vocab chunking bounds live logits at O(N·chunk) with an online
    logsumexp; token chunking at O(chunk·V) with a plain CE per token
    block; ``loss_pallas`` runs the fused kernels (B5–B7), whose logits
    live only in on-chip tiles — token-sharded over ``mesh``'s data
    group when one is given. None of them composes with a vocab-parallel
    head (a ``model`` over a model axis): that raises, as the reference's
    launcher refuses them."""
    if sum(map(bool, (loss_chunk, loss_chunk_tokens, loss_pallas))) > 1:
        raise ValueError("loss_chunk (vocab), loss_chunk_tokens and "
                         "loss_pallas are mutually exclusive")
    if mesh is not None and mesh.model_size > 1 and (
            model is None or model.mesh is None):
        raise ValueError("a mesh with a model axis > 1 needs the model "
                         "built over it: GPT(cfg, mesh=mesh)")
    if (loss_chunk or loss_chunk_tokens or loss_pallas) and (
            model is not None and model.mesh is not None):
        raise ValueError(TP_FUSED_LOSS_REFUSED)
    if loss_pallas:
        return lambda y, w, lab: fused_lm_cross_entropy(
            y, w, lab, ignore_index=-100, mesh=mesh)
    if loss_chunk_tokens:
        return lambda y, w, lab: token_chunked_lm_cross_entropy(
            y, w, lab, chunk=loss_chunk_tokens, ignore_index=-100)
    if loss_chunk:
        return lambda y, w, lab: chunked_lm_cross_entropy(
            y, w, lab, chunk=loss_chunk, ignore_index=-100)
    return None


def make_loss(model: GPT, *, loss_chunk: int = 0,
              loss_chunk_tokens: int = 0, loss_pallas: bool = False,
              mesh=None):
    """Next-token CE: batch = {"input_ids" [B,T], "labels" [B,T]} where
    labels are input_ids shifted left by the data layer (-100 = ignore).
    Returns ``loss_fn(params, batch, rng) -> (loss, LossAux)`` with the
    valid-token count as the metric ``lm_tokens`` and as the weight.
    ``params`` are the module's own tensors (the model closes over them);
    ``rng`` seeds this step's dropout masks.

    ``loss_chunk > 0``: the CE fused with the head in vocab chunks of that
    width (:func:`~dtf_tpu_torch.ops.losses.chunked_lm_cross_entropy`);
    ``loss_chunk_tokens > 0``: in token chunks
    (:func:`~dtf_tpu_torch.ops.losses.token_chunked_lm_cross_entropy`);
    ``loss_pallas``: the fused head + CE kernels
    (:func:`~dtf_tpu_torch.ops.fused_ce.fused_lm_cross_entropy`). All give
    the monolithic path's numbers without its [B,T,V] f32 logits.

    ``mesh``: the batch is this rank's rows of the data axis; dropout
    takes the rank's rows of the global masks, and ``loss_pallas`` is the
    token-sharded fused CE, whose loss and count are the global ones
    (``LossAux.global_mean``). With a model axis > 1 the model is
    ``GPT(mesh=mesh)``, the loss the vocab-parallel CE (the same on every
    rank of the model group), and in the Megatron-SP layout the leaves of
    :data:`SP_PARTIAL_LEAVES` are ``LossAux.model_partial``."""
    fused = _fused_ce(loss_chunk, loss_chunk_tokens, loss_pallas, mesh,
                      model)
    shard = ((mesh.data_index, mesh.data_size) if mesh is not None
             else (0, 1))
    partial = tuple(n for n, _ in model.named_parameters()
                    if re.search(SP_PARTIAL_LEAVES, n))

    def loss_fn(params, batch, rng):
        cfg = model.cfg
        ids = batch["input_ids"]
        y = model(ids, dropout_seed=DropoutKey(rng, *shard)
                  if cfg.dropout else None,
                  return_hidden=fused is not None)
        loss, n = _lm_loss(model, fused, y, batch["labels"])
        global_mean = bool(loss_pallas and mesh is not None)
        if mesh is not None and not global_mean:
            # this rank's part of the count, 0 when it has no label: the
            # reference clamps the count at 1 over the global microbatch
            n = valid_count(batch["labels"], -100)
        return loss, LossAux(
            metrics={"lm_tokens": n}, weight=n, global_mean=global_mean,
            model_partial=partial if model.sp_layout(ids.shape) else ())

    return loss_fn


def _lm_loss(model: GPT, fused, y, labels):
    """(mean, count) of the model's output ``y``: the fused callable on
    the hidden states, else the CE of the logits (vocab-parallel over a
    model group)."""
    if fused is not None:
        return fused(y, model.lm_head.weight, labels)
    if model.mesh is not None:
        return vocab_parallel_cross_entropy(y, labels, model.mesh.model_group,
                                            ignore_index=-100)
    return softmax_cross_entropy(y, labels, ignore_index=-100)


def make_eval(model: GPT, *, loss_chunk: int = 0,
              loss_chunk_tokens: int = 0, loss_pallas: bool = False,
              mesh=None):
    """Held-out eval: ``eval_fn(params, batch) -> {"eval_loss",
    "eval_ppl"}``, mean next-token CE (ignore -100) without dropout, on
    the loss path :func:`make_loss` takes for the same options."""
    fused = _fused_ce(loss_chunk, loss_chunk_tokens, loss_pallas, mesh,
                      model)

    def eval_fn(params, batch):
        y = model(batch["input_ids"], return_hidden=fused is not None)
        loss, _ = _lm_loss(model, fused, y, batch["labels"])
        return {"eval_loss": loss, "eval_ppl": torch.exp(loss)}

    return eval_fn
