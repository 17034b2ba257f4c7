"""The train step (counterpart of ``dtf_tpu.core.train``), on one device.

``make_train_step(loss_fn, tx)`` builds ``step(state, batch) -> (state,
metrics)``: the loss and its gradients with ``torch.autograd.grad``,
optional gradient accumulation as the weighted mean Σwᵢgᵢ/Σwᵢ in f32, the
optimizer update (:mod:`dtf_tpu_torch.optim`, optax's semantics) and the
metrics ``loss`` and ``grad_norm``. The parameters are updated IN PLACE:
``state.params`` holds the module's own tensors.

This slice runs one device. ZeRO-1 (``--zero1``) shards the optimizer
state over the data axis; with one device that axis is 1 and the sharding
is the identity, so nothing here shards. Multi-GPU data parallelism over
NCCL comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from dtf_tpu_torch import optim

#: loss_fn(params, batch, rng) -> (loss, LossAux)
LossFn = Callable[..., tuple[torch.Tensor, "LossAux"]]


@dataclasses.dataclass
class LossAux:
    """What a loss function returns besides the scalar loss: scalar
    ``metrics``, weight-averaged across microbatches, and this batch's
    ``weight`` under gradient accumulation (a count-normalized loss
    returns its valid count, so microbatch gradients combine to the
    full-batch gradient). The JAX package's ``extra`` (mutable flax
    collections) has no counterpart: the port's models keep none."""

    metrics: dict = dataclasses.field(default_factory=dict)
    weight: Any = 1.0


@dataclasses.dataclass
class TrainState:
    """``step`` (Python int: the host-side counter the loop keeps anyway),
    ``params`` (the module's parameters by ``state_dict`` name — the same
    tensors, updated in place), ``opt_state`` (the optimizer's state) and
    ``rng`` (the seed every step's dropout seed is derived from)."""

    step: int
    params: dict
    opt_state: Any
    rng: int


def fold_in(seed: int, *data: int) -> int:
    """A new 63-bit seed from (seed, *data): ``jax.random.fold_in``'s role,
    deterministic across processes and runs."""
    words = np.random.SeedSequence(
        [int(seed), *(int(d) for d in data)]).generate_state(2)
    return (int(words[0]) << 31) ^ int(words[1])


def create_train_state(model: torch.nn.Module, tx: optim.Transform,
                       seed: int) -> TrainState:
    """Step 0 over the module's parameters, a fresh optimizer state, and
    ``seed`` as the dropout root."""
    params = dict(model.named_parameters())
    return TrainState(step=0, params=params, opt_state=tx.init(params),
                      rng=int(seed))


def _split(batch: dict, n: int) -> list[dict]:
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % n:
        raise ValueError(f"batch leading dims {sorted(sizes)} do not split "
                         f"into grad_accum={n} equal microbatches")
    parts = {k: torch.chunk(v, n) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def make_train_step(loss_fn: LossFn, tx: optim.Transform, *,
                    grad_accum: int = 1, log_grad_norm: bool = True):
    """The train step. ``loss_fn(params, batch, rng) -> (loss, LossAux)``
    computes the mean loss over its batch.

    ``grad_accum > 1``: the leading batch dim is split into that many
    microbatches; gradients accumulate in f32 as Σwᵢgᵢ/Σwᵢ with
    wᵢ = ``LossAux.weight``, and a microbatch of weight 0 is *selected*
    out, not multiplied (0·NaN would poison the sum). Loss and metrics
    combine with the same weights. ``grad_norm`` is the global norm of
    the mean gradient before clipping (clipping is part of ``tx``). Each
    step's rng is ``fold_in(state.rng, state.step)``, each microbatch's
    ``fold_in(rng, i)``.
    """

    def grads_of(params, batch, rng):
        loss, aux = loss_fn(params, batch, rng)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), aux, dict(zip(params, grads))

    def step(state: TrainState, batch: dict):
        rng = fold_in(state.rng, state.step)
        params = state.params
        if grad_accum == 1:
            loss, aux, grads = grads_of(params, batch, rng)
            metrics = {k: v.detach() if torch.is_tensor(v) else v
                       for k, v in aux.metrics.items()}
        else:
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
            w_sum = loss = 0.0
            msum: dict = {}
            for i, mb in enumerate(_split(batch, grad_accum)):
                mloss, aux, grads = grads_of(params, mb, fold_in(rng, i))
                w = torch.as_tensor(aux.weight, dtype=torch.float32,
                                    device=mloss.device)

                def wmul(v, w=w):
                    return torch.where(w > 0, v.float() * w,
                                       torch.zeros_like(v, dtype=torch.float32))

                for n, g in grads.items():
                    acc[n] += wmul(g)
                w_sum = w_sum + w
                loss = loss + wmul(mloss)
                for k, v in aux.metrics.items():
                    msum[k] = msum.get(k, 0.0) + wmul(torch.as_tensor(
                        v, device=mloss.device).detach())
            grads = {n: (a / w_sum).to(params[n].dtype)
                     for n, a in acc.items()}
            loss = loss / w_sum
            metrics = {k: v / w_sum for k, v in msum.items()}
        updates, opt_state = tx.update(grads, state.opt_state, params)
        optim.apply_updates(params, updates)
        metrics["loss"] = loss
        if log_grad_norm:
            metrics["grad_norm"] = optim.global_norm(grads.values())
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state, rng=state.rng), metrics

    return step


def make_eval_step(eval_fn: Callable):
    """``eval_fn(params, batch) -> metrics dict``, under ``no_grad``."""

    def step(state: TrainState, batch: dict):
        with torch.no_grad():
            return eval_fn(state.params, batch)

    return step
