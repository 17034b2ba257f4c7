"""BERT masked-LM pretraining (counterpart of ``dtf_tpu.models.bert``),
BASELINE config 4.

A post-LN encoder: token + position + segment embeddings (f32 tables,
bf16 compute), LayerNorm in f32 with flax's ε 1e-6, self-attention with a
key-padding mask (the flash kernels B1 forward and B2/B3 backward on
CUDA, non-causal with the mask as a bias row; the dense reference
elsewhere), tanh GELU, dropout after the embedding LayerNorm, the
attention output and the MLP output; and the MLM head: dense → GELU →
LayerNorm, decoded against the TIED token embedding in f32 plus
``mlm_bias``. Parameter names follow flax's modules (``token_embed``,
``layer_{i}.attention.query``, ``ln_attn``, ``mlm_dense``, ``mlm_bias``
…), so :mod:`dtf_tpu_torch.convert` maps them one to one.

The loss scores the masked positions (labels -100 elsewhere): with full
logits, vocab-chunked against the tied embedding (``loss_chunk``), or on
``mlm_gather`` gathered positions a row (BERT's
``max_predictions_per_seq``; :func:`gather_masked`). Dropout masks and
the gather's key come from the step seed (``DropoutKey``: under data
parallelism drawn for the global microbatch, each rank its rows), as
GPT's do. Tensor and sequence parallelism are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dtf_tpu_torch.core.comms import TpDense
from dtf_tpu_torch.core.device import resolve_device
from dtf_tpu_torch.core.train import LossAux, fold_in
from dtf_tpu_torch.models.gpt import (ATTN_SITE, EMBED_SITE, MLP_SITE,
                                      DropoutKey, _dropout)
from dtf_tpu_torch.ops.attention import dense_attention
from dtf_tpu_torch.ops.flash_attention import flash_attention
from dtf_tpu_torch.ops.losses import (chunked_lm_cross_entropy,
                                      softmax_cross_entropy)

#: the gather key's site: slot 0 beside the embedding's dropout mask
GATHER_SITE = 3


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    #: auto (flash on CUDA, dense elsewhere) | dense | flash
    attn_impl: str = "auto"

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        return BertConfig(vocab_size=128, hidden=32, layers=2, heads=4,
                          intermediate=64, max_positions=64, dropout=0.0,
                          **kw)


def effective_attn_impl(impl: str, device) -> str:
    """Resolve ``attn_impl``: ``auto`` is the flash kernels on CUDA and the
    dense reference elsewhere (a sequence axis, which rings in the
    reference, is not ported: ``train_bert`` refuses ``--mesh_seq``)."""
    if impl != "auto":
        return impl
    return "flash" if torch.device(device).type == "cuda" else "dense"


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, layer: int = 0):
        super().__init__()
        self.cfg = cfg
        self.layer = layer

        def dense(parallel):
            return TpDense(cfg.hidden, cfg.hidden, parallel=parallel,
                           dtype=cfg.dtype, device=device)

        self.query = dense("column")
        self.key = dense("column")
        self.value = dense("column")
        self.attn_out = dense("row")

    def forward(self, x, pad_mask, dropout_seed=None):
        cfg = self.cfg
        b, t = x.shape[0], x.shape[1]
        d_head = cfg.hidden // cfg.heads

        def split(y):                                  # [B,T,Hd] → [B,H,T,D]
            return y.reshape(b, t, cfg.heads, d_head).transpose(1, 2)

        q, k, v = (split(m(x)) for m in (self.query, self.key, self.value))
        impl = effective_attn_impl(cfg.attn_impl, x.device)
        if impl == "flash":
            out = flash_attention(q, k, v, causal=False, kv_mask=pad_mask)
        elif impl == "dense":
            bias = torch.zeros(pad_mask.shape, device=x.device).masked_fill(
                ~pad_mask, float("-inf"))[:, None, None, :]
            out = dense_attention(q, k, v, bias=bias)
        else:
            raise ValueError(
                f"unknown attn_impl {impl!r} (auto | dense | flash)")
        out = self.attn_out(out.transpose(1, 2).reshape(b, t, cfg.hidden))
        return _dropout(out, cfg.dropout, dropout_seed, self.layer + 1,
                        ATTN_SITE)


class EncoderLayer(nn.Module):
    """Post-LN: ``LN(x + attention)``, then ``LN(x + MLP)``."""

    def __init__(self, cfg: BertConfig, device=None, layer: int = 0):
        super().__init__()
        self.cfg = cfg
        self.layer = layer
        f32 = torch.float32
        self.attention = SelfAttention(cfg, device=device, layer=layer)
        self.ln_attn = nn.LayerNorm(cfg.hidden, eps=1e-6, dtype=f32,
                                    device=device)
        self.mlp_in = TpDense(cfg.hidden, cfg.intermediate,
                              parallel="column", dtype=cfg.dtype,
                              device=device)
        self.mlp_out = TpDense(cfg.intermediate, cfg.hidden, parallel="row",
                               dtype=cfg.dtype, device=device)
        self.ln_mlp = nn.LayerNorm(cfg.hidden, eps=1e-6, dtype=f32,
                                   device=device)

    def forward(self, x, pad_mask, dropout_seed=None):
        a = self.attention(x, pad_mask, dropout_seed)
        x = self.ln_attn((x + a).float())
        h = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        h = _dropout(h, self.cfg.dropout, dropout_seed, self.layer + 1,
                     MLP_SITE)
        return self.ln_mlp((x + h).float())


class BertMLM(nn.Module):
    """Encoder + MLM head, the decoder tied to the token embedding.
    (ids, segment ids, pad mask) [B,T] → f32 logits [B,T,V], or the f32
    hidden states before the decode with ``return_hidden``."""

    def __init__(self, cfg: BertConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        f32 = torch.float32
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.hidden,
                                        dtype=f32, device=device)
        self.pos_embed = nn.Embedding(cfg.max_positions, cfg.hidden,
                                      dtype=f32, device=device)
        self.seg_embed = nn.Embedding(cfg.type_vocab, cfg.hidden, dtype=f32,
                                      device=device)
        self.ln_embed = nn.LayerNorm(cfg.hidden, eps=1e-6, dtype=f32,
                                     device=device)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}",
                            EncoderLayer(cfg, device=device, layer=i))
        self.mlm_dense = TpDense(cfg.hidden, cfg.hidden, parallel="column",
                                 dtype=cfg.dtype, device=device)
        self.ln_mlm = nn.LayerNorm(cfg.hidden, eps=1e-6, dtype=f32,
                                   device=device)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, dtype=f32,
                                                 device=device))

    @property
    def device(self) -> torch.device:
        return self.mlm_bias.device

    def forward(self, input_ids, segment_ids, pad_mask, *,
                dropout_seed=None, return_hidden: bool = False):
        """``pad_mask`` [B,T] bool, False on a padded position, which no
        query attends; ``dropout_seed`` an int or a :class:`DropoutKey`,
        None for no dropout."""
        cfg = self.cfg
        t = input_ids.shape[1]
        if t > cfg.max_positions:
            raise ValueError(f"seq_len={t} exceeds max_positions="
                             f"{cfg.max_positions}")
        dt = cfg.dtype
        # nn.Embed(dtype=bf16) casts the f32 table; casting the gathered
        # rows gives the same values. The sum runs in bf16, as flax's.
        x = (F.embedding(input_ids, self.token_embed.weight).to(dt)
             + self.pos_embed.weight[:t].to(dt)[None]) \
            + F.embedding(segment_ids, self.seg_embed.weight).to(dt)
        x = self.ln_embed(x.float())
        x = _dropout(x, cfg.dropout, dropout_seed, 0, EMBED_SITE)
        pad_mask = pad_mask.bool()
        for i in range(cfg.layers):
            x = getattr(self, f"layer_{i}")(x, pad_mask, dropout_seed)
        h = F.gelu(self.mlm_dense(x), approximate="tanh")
        h = self.ln_mlm(h.float())
        if return_hidden:
            return h
        return torch.matmul(h, self.token_embed.weight.t()) + self.mlm_bias


def gather_masked(h: torch.Tensor, labels: torch.Tensor, budget: int,
                  key: Optional[DropoutKey] = None):
    """Up to ``budget`` masked positions a row (``labels != -100``): the
    rows of ``h`` [B,T,D] and ``labels`` [B,T] at them. Valid positions
    sort by a uniform key in [0, 1), invalid ones by key + T + 1, so the
    valid ones come first and a row with more than ``budget`` drops its
    overflow uniformly at random; slack slots keep -100 labels. The key
    is drawn from ``key.seed`` for the global microbatch (``key.shards``
    times these rows), this rank taking its rows. Without a ``key``
    (eval) the key is the position: the first ``budget`` valid positions.
    A stable sort, as ``jnp.argsort``."""
    rows, t = labels.shape
    valid = labels != -100
    if key is None:
        order = torch.arange(t, dtype=torch.float32,
                             device=h.device).expand(rows, t)
    else:
        gen = torch.Generator(device=h.device)
        gen.manual_seed(fold_in(key.seed, 0, GATHER_SITE))
        order = torch.rand((rows * key.shards, t), generator=gen,
                           device=h.device)[key.shard * rows:
                                            (key.shard + 1) * rows]
    order = torch.where(valid, order, order + (t + 1.0))
    idx = torch.argsort(order, dim=1, stable=True)[:, :budget]
    return (torch.take_along_dim(h, idx[..., None], dim=1),
            torch.take_along_dim(labels, idx, dim=1))


def _mlm_ce(model: BertMLM, out, labels, loss_chunk: int, mlm_gather: int,
            key: Optional[DropoutKey] = None):
    """CE over the masked positions, (mean, count): full logits ``out``,
    or the hidden states ``out`` decoded against the tied embedding +
    ``mlm_bias`` in vocab chunks; ``mlm_gather`` gathers that many
    positions a row first (:func:`gather_masked`), decoded in one
    vocab-wide chunk unless ``loss_chunk`` says otherwise."""
    if mlm_gather:
        out, labels = gather_masked(out, labels, mlm_gather, key)
        loss_chunk = loss_chunk or model.cfg.vocab_size
    if loss_chunk:
        return chunked_lm_cross_entropy(
            out, model.token_embed.weight, labels, chunk=loss_chunk,
            bias=model.mlm_bias, ignore_index=-100)
    return softmax_cross_entropy(out, labels, ignore_index=-100)


def _inputs(batch):
    return (batch["input_ids"], batch["segment_ids"],
            batch["attention_mask"].bool())


def make_loss(model: BertMLM, *, loss_chunk: int = 0, mlm_gather: int = 0,
              mesh=None):
    """MLM loss: ``loss_fn(params, batch, rng) -> (loss, LossAux)``, the
    mean CE over the masked positions with their count as the weight and
    the metric ``mlm_positions``. ``batch``: ``input_ids``,
    ``segment_ids``, ``attention_mask``, ``mlm_labels`` [B,T]. ``rng``
    seeds this microbatch's dropout masks and the gather's key; dropout
    is off when ``cfg.dropout`` is 0. ``loss_chunk``: the vocab-chunked
    CE against the tied embedding (no [B,T,V] logits); ``mlm_gather``:
    score that many gathered positions a row. ``mesh``: the batch is this
    rank's rows of the data axis, the masks and the key are its rows of
    the global microbatch's, and the weight is the rank's count of scored
    positions, unclamped (the step sums it over the ranks)."""
    if mesh is not None and mesh.model_size > 1:
        raise NotImplementedError("BERT over a model axis (tensor "
                                  "parallelism): not yet ported")
    shard = ((mesh.data_index, mesh.data_size) if mesh is not None
             else (0, 1))
    hidden = loss_chunk > 0 or mlm_gather > 0

    def loss_fn(params, batch, rng):
        key = DropoutKey(rng, *shard)
        labels = batch["mlm_labels"]
        out = model(*_inputs(batch),
                    dropout_seed=key if model.cfg.dropout else None,
                    return_hidden=hidden)
        loss, n = _mlm_ce(model, out, labels, loss_chunk, mlm_gather, key)
        if mesh is not None:
            # this rank's part of the microbatch's count, 0 when it
            # scores nothing: the reference clamps the count at 1 over
            # the whole (global) microbatch, not over a rank's rows
            valid = (labels != -100).sum(1)
            n = (valid.clamp(max=mlm_gather) if mlm_gather
                 else valid).sum().float()
        return loss, LossAux(metrics={"mlm_positions": n}, weight=n)

    return loss_fn


def make_eval(model: BertMLM, *, loss_chunk: int = 0, mlm_gather: int = 0):
    """Held-out MLM eval: ``eval_fn(params, batch) -> {"eval_mlm_loss",
    "eval_mlm_ppl"}`` without dropout, on :func:`make_loss`'s path for the
    same options; with ``mlm_gather`` the FIRST ``budget`` masked
    positions of each row."""
    hidden = loss_chunk > 0 or mlm_gather > 0

    def eval_fn(params, batch):
        out = model(*_inputs(batch), return_hidden=hidden)
        loss, _ = _mlm_ce(model, out, batch["mlm_labels"], loss_chunk,
                          mlm_gather)
        return {"eval_mlm_loss": loss, "eval_mlm_ppl": torch.exp(loss)}

    return eval_fn
