"""The train step (counterpart of ``dtf_tpu.core.train``).

``make_train_step(loss_fn, tx)`` builds ``step(state, batch) -> (state,
metrics)``: the loss and its gradients with ``torch.autograd.grad``,
optional gradient accumulation as the weighted mean Σwᵢgᵢ/Σwᵢ in f32, the
optimizer update (:mod:`dtf_tpu_torch.optim`, optax's semantics) and the
metrics ``loss`` and ``grad_norm``. The parameters are updated IN PLACE:
``state.params`` holds the module's own tensors. State that is not a
parameter (BatchNorm's running statistics, the JAX package's mutable
``batch_stats``) is the module's buffers, ``state.extra``: the forward
updates them in place, under gradient accumulation once per microbatch,
in order, as the reference threads ``extra`` through its scan.

With a ``mesh`` (:mod:`dtf_tpu_torch.core.mesh`) each rank holds its
rows of the global batch, and the weighted mean runs over the ranks of
the data group as it runs over microbatches, so the gradient is the
global batch's also when ranks hold different numbers of valid labels.
Under gradient accumulation over more than one rank the ranks first
exchange rows (one all-to-all a batch leaf), so that microbatch i is
global rows [i·m, (i+1)·m) (m = batch / grad_accum), each rank its
block of them, as the reference's ``to_micro`` cuts the global batch:
what a microbatch draws or reduces (the dropout masks, BERT's gather
key, BatchNorm's statistics) is the global microbatch's.
Under ZeRO-1 (``state.layout.zero1_dims``, from
:func:`dtf_tpu_torch.core.sharding.make_layout`) the sum over ranks is a
reduce-scatter into this rank's blocks, the optimizer updates those
blocks against the sharded optimizer state, and an all-gather over the
data group makes the parameters whole again; without it, one all-reduce.
The gradient's norm (the ``grad_norm`` metric and ``--clip_grad_norm``)
counts every element once, whichever ranks hold it: ZeRO-1 blocks over
the data group and row-sharded leaves (``layout.model_dims``) over the
model group, in one collective a step (:class:`~dtf_tpu_torch.optim.
ShardedTree`). A world of one runs the same collectives; only
``mesh=None`` skips them.

Under tensor parallelism (a model axis > 1) each rank's gradients of the
model-sharded leaves are its own blocks' and stay on the rank; the
leaves whole on every rank get equal gradients on the plain TP path, and
in the Megatron-SP layout (``--tp_overlap``) the rank's part of their
sum, which the step completes over the model group in one all-reduce a
microbatch (``LossAux.model_partial``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from dtf_tpu_torch import optim
from dtf_tpu_torch.core import comms

#: loss_fn(params, batch, rng) -> (loss, LossAux)
LossFn = Callable[..., tuple[torch.Tensor, "LossAux"]]


@dataclasses.dataclass
class LossAux:
    """What a loss function returns besides the scalar loss: scalar
    ``metrics``, weight-averaged across microbatches, and this batch's
    ``weight`` under gradient accumulation (a count-normalized loss
    returns its valid count, so microbatch gradients combine to the
    full-batch gradient). The JAX package's ``extra`` (the updated
    mutable flax collections) has no field here: a port model updates
    its buffers in place during the forward (``TrainState.extra``)."""

    metrics: dict = dataclasses.field(default_factory=dict)
    weight: Any = 1.0
    #: the loss is already the mean over the whole data group, and each
    #: rank's gradients are its part of that mean's gradient (the
    #: token-sharded fused CE): the step sums the gradients over ranks,
    #: and ``weight`` (the global count) is the same on every rank
    global_mean: bool = False
    #: names of parameters that are whole on every rank of the model group
    #: but whose gradient here is this rank's part of a sum over it (the
    #: leaves the Megatron-SP layout applies to the rank's tokens only):
    #: the step sums them over the model group, in one all-reduce
    model_partial: tuple = ()


@dataclasses.dataclass
class TrainState:
    """``step`` (Python int: the host-side counter the loop keeps anyway),
    ``params`` (the module's parameters by ``state_dict`` name — the same
    tensors, updated in place), ``opt_state`` (the optimizer's state) and
    ``rng`` (the seed every step's dropout seed is derived from);
    ``layout`` (how the parameters and the optimizer state are split over
    a mesh, :class:`~dtf_tpu_torch.core.sharding.Layout`; None: whole);
    ``extra`` (the module's persistent buffers by ``state_dict`` name —
    the same tensors, which the forward updates in place: BatchNorm's
    running statistics; identical on every rank of a mesh)."""

    step: int
    params: dict
    opt_state: Any
    rng: int
    layout: Any = None
    extra: dict = dataclasses.field(default_factory=dict)


def fold_in(seed: int, *data: int) -> int:
    """A new 63-bit seed from (seed, *data): ``jax.random.fold_in``'s role,
    deterministic across processes and runs."""
    words = np.random.SeedSequence(
        [int(seed), *(int(d) for d in data)]).generate_state(2)
    return (int(words[0]) << 31) ^ int(words[1])


def create_train_state(model: torch.nn.Module, tx: optim.Transform,
                       seed: int, *, mesh=None, layout=None) -> TrainState:
    """Step 0 over the module's parameters and persistent buffers, a
    fresh optimizer state (of this rank's ZeRO-1 blocks under ``layout``),
    and ``seed`` as the dropout root."""
    params = dict(model.named_parameters())
    extra = {n: t for n, t in model.state_dict(keep_vars=True).items()
             if n not in params}
    if layout is not None and layout.zero1_dims:
        opt_params = optim.ShardedTree(
            {n: layout.shard_leaf(n, p, mesh) for n, p in params.items()},
            mesh, zero1=layout.zero1_dims)
    else:
        opt_params = params
    return TrainState(step=0, params=params, opt_state=tx.init(opt_params),
                      rng=int(seed), layout=layout, extra=extra)


def _split(batch: dict, n: int) -> list[dict]:
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % n:
        raise ValueError(f"batch leading dims {sorted(sizes)} do not split "
                         f"into grad_accum={n} equal microbatches")
    parts = {k: torch.chunk(v, n) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def _micro_rows(rows: int, grad_accum: int, data_size: int):
    """Where each row goes when ``data_size`` ranks of ``rows`` rows each
    (rank q holds global rows [q·rows, (q+1)·rows)) regroup for
    ``grad_accum`` microbatches as the reference's ``to_micro`` cuts
    them: microbatch i is global rows [i·m, (i+1)·m), m = rows·data_size
    / grad_accum, and rank q holds rows [i·m + q·m/D, i·m + (q+1)·m/D)
    of it. Returns ``need``: [data_size, rows] global row indices, row q
    rank q's rows afterwards in microbatch order (ascending)."""
    total = rows * data_size
    if total % grad_accum or (total // grad_accum) % data_size:
        raise ValueError(
            f"global batch {total} with grad_accum={grad_accum} gives "
            f"microbatch {total // grad_accum}, which must be divisible by "
            f"the data axis ({data_size} shards)")
    m = total // grad_accum
    part = m // data_size
    i = np.arange(grad_accum)[None, :, None] * m
    q = np.arange(data_size)[:, None, None] * part
    return (i + q + np.arange(part)[None, None, :]).reshape(data_size, rows)


def _exchange_rows(batch: dict, grad_accum: int, mesh) -> dict:
    """This rank's rows of the batch regrouped over the data group so
    that its i-th chunk of ``grad_accum`` is its part of the GLOBAL
    microbatch i (:func:`_micro_rows`): one ``all_to_all_single`` a leaf.
    Each peer's rows arrive in global order, and the peers hold
    ascending blocks, so what arrives is in microbatch order. gloo
    exchanges through host memory."""
    rows = next(iter(batch.values())).shape[0]
    need = _micro_rows(rows, grad_accum, mesh.data_size)
    me = mesh.data_index
    send = [need[q][need[q] // rows == me] - me * rows
            for q in range(mesh.data_size)]
    recv = [int((need[me] // rows == s).sum())
            for s in range(mesh.data_size)]
    order = torch.from_numpy(np.concatenate(send))
    host = dist.get_backend(mesh.data_group) == "gloo"
    out = {}
    for k, v in batch.items():
        src = v[order.to(v.device)]
        if host:
            src = src.cpu()
        dst = src.new_empty((rows,) + tuple(v.shape[1:]))
        dist.all_to_all_single(dst, src, recv, [len(s) for s in send],
                               group=mesh.data_group)
        out[k] = dst.to(v.device)
    return out


def _weighted(v: torch.Tensor, w: torch.Tensor,
              keep: torch.Tensor) -> torch.Tensor:
    """v·w in f32, exactly 0 where ``keep`` (w > 0) is false: selected
    out, not multiplied (0·NaN would poison the sum)."""
    return torch.where(keep, v.float() * w, 0.0)


def make_train_step(loss_fn: LossFn, tx: optim.Transform, *,
                    grad_accum: int = 1, log_grad_norm: bool = True,
                    mesh=None, grad_shard: bool = False, model=None):
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

    ``mesh``: ``batch`` is this rank's rows, and the sums Σwᵢgᵢ, Σwᵢ, the
    loss and the metrics run over the data group too (module docstring),
    the gradients in two collectives whatever their number
    (:class:`~dtf_tpu_torch.core.comms.GradBuckets`). ``grad_shard``
    (with ZeRO-1 dims in ``state.layout``): each microbatch's weighted
    gradients are reduce-scattered into a shard-sized accumulator instead
    of summed whole on the rank and reduce-scattered once.

    ``model``: the module ``loss_fn`` runs, put in train mode at every
    step (BatchNorm on the batch's statistics, updating its running
    ones); :func:`make_eval_step` puts it in eval mode and back.
    """

    def grads_of(params, batch, rng):
        loss, aux = loss_fn(params, batch, rng)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        if aux.model_partial:
            names = list(aux.model_partial)
            whole = comms.psum(torch.cat(
                [grads[n].reshape(-1) for n in names]), mesh.model_group)
            for n, g in zip(names, whole.split([grads[n].numel()
                                                for n in names])):
                grads[n] = g.view_as(grads[n])
        return loss.detach(), aux, grads

    def accumulate(params, batch, rng, pack, reduce_mb=None):
        """Σ reduce_mb(wᵢ·pack(gᵢ)) (``pack``: the gradients as a list of
        tensors), Σ wᵢ, Σ wᵢ·lossᵢ and Σ wᵢ·metricᵢ over the
        microbatches; and whether the loss is a global mean."""
        acc, w_sum, loss, msum = None, 0.0, 0.0, {}
        for i, mb in enumerate(_split(batch, grad_accum)):
            mloss, aux, grads = grads_of(params, mb, fold_in(rng, i)
                                         if grad_accum > 1 else rng)
            w = torch.as_tensor(aux.weight, dtype=torch.float32,
                                device=mloss.device)
            keep = w > 0
            part = [_weighted(t, w, keep) for t in pack(grads)]
            if reduce_mb is not None:
                part = reduce_mb(part)
            acc = part if acc is None else [a + p for a, p in zip(acc, part)]
            w_sum = w_sum + w
            loss = loss + _weighted(mloss, w, keep)
            for k, v in aux.metrics.items():
                msum[k] = msum.get(k, 0.0) + _weighted(torch.as_tensor(
                    v, device=mloss.device).detach(), w, keep)
        return acc, w_sum, loss, msum, aux.global_mean

    def local_step(state: TrainState, batch: dict, rng: int):
        params = state.params
        if grad_accum == 1:
            loss, aux, grads = grads_of(params, batch, rng)
            metrics = {k: v.detach() if torch.is_tensor(v) else v
                       for k, v in aux.metrics.items()}
        else:
            acc, w_sum, loss, msum, _ = accumulate(
                params, batch, rng, lambda g: list(g.values()))
            grads = {n: (a / w_sum).to(params[n].dtype)
                     for n, a in zip(params, acc)}
            loss = loss / w_sum
            metrics = {k: v / w_sum for k, v in msum.items()}
        updates, opt_state = tx.update(grads, state.opt_state, params)
        optim.apply_updates(params, updates)
        return opt_state, grads, loss, metrics

    def mesh_step(state: TrainState, batch: dict, rng: int):
        params, group = state.params, mesh.data_group
        layout = state.layout
        dims = layout.zero1_dims if layout is not None else {}
        buckets = comms.GradBuckets(params, group, dims)
        per_mb = grad_shard and bool(dims)
        if grad_accum > 1 and mesh.data_size > 1:
            batch = _exchange_rows(batch, grad_accum, mesh)
        acc, w_sum, loss, msum, global_mean = accumulate(
            params, batch, rng, buckets.flatten,
            buckets.grad_reduce_scatter if per_mb else None)
        if not per_mb:
            acc = buckets.grad_reduce_scatter(acc)
        # Σw, Σw·loss and Σw·metric in one all-reduce; a global mean is
        # the same on every rank already
        names = sorted(msum)
        stats = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                             device=mesh.device)
                             for v in [w_sum, loss] + [msum[k]
                                                       for k in names]])
        if not global_mean:
            stats = comms.psum(stats, group)
        # Σw at least 1, the count-normalized losses' clamp: a step in
        # which no rank scores anything gives 0, not 0/0
        w_total = stats[0].clamp_min(1.0)
        grads = {n: g.to(params[n].dtype) for n, g in buckets.split(
            [a / w_total for a in acc]).items()}
        metrics = {k: stats[2 + i] / w_total for i, k in enumerate(names)}
        loss = stats[1] / w_total
        # the row-sharded leaves: their norm runs over the model group too
        split = (layout.model_dims if layout is not None
                 and mesh.model_size > 1 else {})
        grads = optim.ShardedTree(grads, mesh, zero1=dims, model=split)
        if not dims:
            updates, opt_state = tx.update(grads, state.opt_state, params)
            optim.apply_updates(params, updates)
            return opt_state, grads, loss, metrics
        blocks = {n: layout.shard_leaf(n, p, mesh) for n, p in params.items()}
        updates, opt_state = tx.update(grads, state.opt_state, blocks)
        optim.apply_updates(blocks, updates)       # into the views
        buckets.all_gather_into(params, blocks)
        return opt_state, grads, loss, metrics

    def step(state: TrainState, batch: dict):
        if model is not None:
            model.train()
        rng = fold_in(state.rng, state.step)
        opt_state, grads, loss, metrics = (
            local_step if mesh is None else mesh_step)(state, batch, rng)
        metrics["loss"] = loss
        if log_grad_norm:
            metrics["grad_norm"] = optim.tree_norm(grads)
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state), metrics

    return step


def make_eval_step(eval_fn: Callable, mesh=None, model=None):
    """``eval_fn(params, batch) -> metrics dict``, under ``no_grad``; with
    a ``mesh``, each metric's mean over the data group (one all-reduce).
    ``model``: run in eval mode (BatchNorm on its running statistics,
    which stay as they are), its mode restored after."""

    def step(state: TrainState, batch: dict):
        was_training = model is not None and model.training
        if model is not None:
            model.eval()
        try:
            with torch.no_grad():
                metrics = eval_fn(state.params, batch)
                if mesh is None:
                    return metrics
                names = sorted(metrics)
                mean = comms.pmean(torch.stack([
                    torch.as_tensor(metrics[k], dtype=torch.float32,
                                    device=mesh.device) for k in names]),
                    mesh.data_group)
                return dict(zip(names, mean))
        finally:
            if model is not None:
                model.train(was_training)

    return step
