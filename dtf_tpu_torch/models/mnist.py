"""MNIST softmax regression and an MLP (counterpart of ``dtf_tpu.models.mnist``),
BASELINE config 1: the reference repo's own workload, ``y = softmax(Wx +
b)`` trained with plain SGD.

Module names are flax's (``hidden_{i}``, ``logits``), so
:mod:`dtf_tpu_torch.convert` carries a flax tree across; everything is
f32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from dtf_tpu_torch.core.comms import TpDense
from dtf_tpu_torch.core.train import LossAux


class MLP(nn.Module):
    """ReLU layers of ``hidden`` widths, then the 10-way ``logits``; no
    hidden layer is :class:`SoftmaxRegression`."""

    def __init__(self, hidden: tuple[int, ...] = (128,),
                 num_classes: int = 10, input_dim: int = 784, device=None):
        super().__init__()
        self.hidden = tuple(hidden)
        self.num_classes = num_classes
        self.input_dim = input_dim
        width = input_dim
        for i, h in enumerate(self.hidden):
            setattr(self, f"hidden_{i}", TpDense(width, h, parallel="column",
                                                 device=device))
            width = h
        self.logits = TpDense(width, num_classes, parallel="column",
                              device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.hidden)):
            x = F.relu(getattr(self, f"hidden_{i}")(x))
        return self.logits(x)


class SoftmaxRegression(MLP):
    """One dense layer, exactly the reference model."""

    def __init__(self, num_classes: int = 10, input_dim: int = 784,
                 device=None):
        super().__init__((), num_classes, input_dim, device=device)


def make_model(kind: str = "softmax", device=None) -> MLP:
    if kind not in ("softmax", "mlp"):
        raise ValueError(f"unknown --model={kind!r} (softmax | mlp)")
    return SoftmaxRegression(device=device) if kind == "softmax" \
        else MLP(device=device)


def _ce_and_accuracy(logits: torch.Tensor, labels: torch.Tensor):
    labels = labels.long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.detach().argmax(-1) == labels).float().mean()
    return loss, acc


def make_loss(model: MLP):
    """Mean softmax cross-entropy over the batch {"image" [B, 784] f32,
    "label" [B] int}, with the metric ``accuracy``; weight 1 (equal
    batches on every rank make the mean of the ranks' means the global
    mean, as the JAX launcher's does)."""

    def loss_fn(params, batch, rng):
        loss, acc = _ce_and_accuracy(model(batch["image"]), batch["label"])
        return loss, LossAux(metrics={"accuracy": acc})

    return loss_fn


def make_eval(model: MLP):
    """``eval_fn(params, batch) -> {"eval_loss", "eval_accuracy"}``."""

    def eval_fn(params, batch):
        loss, acc = _ce_and_accuracy(model(batch["image"]), batch["label"])
        return {"eval_loss": loss, "eval_accuracy": acc}

    return eval_fn
