"""Wide&Deep CTR model (counterpart of ``dtf_tpu.models.widedeep``), BASELINE
config 5: 13 dense + 26 categorical (hashed) features, Criteo-style.

- **wide**: a scalar weight per (feature, bucket) — the 1-wide table
  ``embed_tables_wide`` — summed over the features, plus a linear term
  on the dense features (``wide_dense``);
- **deep**: per-feature ``embed_dim``-wide embeddings from
  ``embed_tables_deep`` (one shared id space: feature f's bucket b is row
  ``f · hash_buckets + b``), concatenated with the dense features into an
  MLP (``mlp_{i}``, ReLU) and a 1-wide head (``deep_out``).

Module names are flax's, so :mod:`dtf_tpu_torch.convert` carries a flax
tree across. Dtypes are flax's ``Dense``'s: ``mlp_{i}`` compute at
``dtype`` (bf16 by default) with f32 parameters; ``wide_dense`` and
``deep_out`` compute in f32; the deep table is cast to ``dtype`` before
its gather, the wide table stays f32. On one rank the tables are looked
up with ``index_select`` (:class:`~dtf_tpu_torch.parallel.embedding.
RowShardedEmbed`), as the reference looks them up with ``jnp.take``.
Given a ``mesh`` whose model axis is > 1, both tables are row-sharded
over it (:data:`rules`) and looked up together
(:func:`~dtf_tpu_torch.parallel.embedding.lookup_tables`): ONE B8 launch
a forward serves both, the deep rows rounded to ``dtype`` as they are
stored (no cast of the shard); the dense half stays replicated.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from dtf_tpu_torch.core.comms import TpDense
from dtf_tpu_torch.core.train import LossAux
from dtf_tpu_torch.parallel.embedding import RowShardedEmbed, \
    embedding_rules, lookup_tables

#: dense (numeric) features of a Criteo row
NUM_DENSE = 13
#: the placement rules: both tables row-sharded over the model axis
rules = embedding_rules("model")


class WideDeep(nn.Module):
    def __init__(self, num_sparse: int = 26, hash_buckets: int = 1000,
                 embed_dim: int = 16, mlp: tuple[int, ...] = (256, 128, 64),
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 mesh=None):
        super().__init__()
        self.num_sparse = num_sparse
        self.hash_buckets = hash_buckets
        self.embed_dim = embed_dim
        self.mlp = tuple(mlp)
        self.dtype = dtype
        rows = num_sparse * hash_buckets
        group = (mesh.model_group if mesh is not None and mesh.model_size > 1
                 else None)
        self.embed_tables_wide = RowShardedEmbed(rows, 1, torch.float32,
                                                 device=device, group=group)
        self.wide_dense = TpDense(NUM_DENSE, 1, parallel="column",
                                  dtype=torch.float32, device=device)
        self.embed_tables_deep = RowShardedEmbed(rows, embed_dim, dtype,
                                                 device=device, group=group)
        width = num_sparse * embed_dim + NUM_DENSE
        for i, h in enumerate(self.mlp):
            setattr(self, f"mlp_{i}", TpDense(width, h, parallel="column",
                                              dtype=dtype, device=device))
            width = h
        self.deep_out = TpDense(width, 1, parallel="column",
                                dtype=torch.float32, device=device)
        # disjoint id spaces: feature f's buckets start at f·hash_buckets
        self.register_buffer(
            "offsets", torch.arange(num_sparse, dtype=torch.int32,
                                    device=device) * hash_buckets,
            persistent=False)

    def flat_ids(self, sparse: torch.Tensor) -> torch.Tensor:
        """[B, num_sparse] bucket ids → rows of the shared tables."""
        return sparse + self.offsets[None, :]

    def forward(self, dense: torch.Tensor,
                sparse: torch.Tensor) -> torch.Tensor:
        """dense [B, 13] f32, sparse [B, num_sparse] int → logits [B] f32."""
        flat = self.flat_ids(sparse)
        wide, emb = lookup_tables((self.embed_tables_wide,
                                   self.embed_tables_deep), flat)
        wide = wide[..., 0].sum(-1) + self.wide_dense(dense)[..., 0]
        x = torch.cat([emb.reshape(emb.shape[0], -1),
                       dense.to(self.dtype)], dim=-1)
        for i in range(len(self.mlp)):
            x = F.relu(getattr(self, f"mlp_{i}")(x))
        return wide + self.deep_out(x)[..., 0]


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """optax's per-example formula: −y·log σ(x) − (1 − y)·log σ(−x)."""
    labels = labels.to(logits.dtype)
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def _ctr_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """Accuracy and the prediction/label correlation (``jnp.corrcoef``
    then ``nan_to_num``: 0 for a batch whose labels, or predictions, are
    constant)."""
    with torch.no_grad():
        logits = logits.detach()
        acc = ((logits > 0) == (labels > 0.5)).float().mean()
        x = torch.stack([torch.sigmoid(logits), labels.to(logits.dtype)])
        x = x - x.mean(dim=1, keepdim=True)
        c = x @ x.t() / (x.shape[1] - 1)
        std = torch.sqrt(torch.diagonal(c))
        c = (c / std[:, None] / std[None, :]).clamp(-1.0, 1.0)
        return acc, torch.nan_to_num(c[0, 1])


def make_loss(model: WideDeep):
    """``loss_fn(params, batch, rng) -> (loss, LossAux)`` over batch =
    {"dense", "sparse", "label"}: the mean sigmoid CE, with the metrics
    ``accuracy`` and ``pred_corr``. ``params`` are the module's own
    tensors; ``rng`` is unused (the model has no dropout)."""

    def loss_fn(params, batch, rng):
        logits = model(batch["dense"], batch["sparse"])
        loss = sigmoid_binary_cross_entropy(logits, batch["label"]).mean()
        acc, corr = _ctr_metrics(logits, batch["label"])
        return loss, LossAux(metrics={"accuracy": acc, "pred_corr": corr})

    return loss_fn


def make_eval(model: WideDeep):
    """Held-out CTR eval: ``eval_fn(params, batch) -> {"eval_logloss",
    "eval_accuracy", "eval_pred_corr"}``."""

    def eval_fn(params, batch):
        logits = model(batch["dense"], batch["sparse"])
        loss = sigmoid_binary_cross_entropy(logits, batch["label"]).mean()
        acc, corr = _ctr_metrics(logits, batch["label"])
        return {"eval_logloss": loss, "eval_accuracy": acc,
                "eval_pred_corr": corr}

    return eval_fn
