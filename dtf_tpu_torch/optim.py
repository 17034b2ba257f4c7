"""The launchers' optimizer story with optax's semantics (the port's copy of
``dtf_tpu.cli.flags.make_lr_schedule`` / ``make_optimizer`` /
``wrap_optimizer`` and of the optax transforms they build).

A :class:`Transform` is optax's ``GradientTransformation``: ``init(params)
-> state`` and ``update(updates, state, params) -> (updates, state)`` over
dicts of named tensors. The state is nested lists and dicts of tensors and
Python ints, so ``torch.save`` checkpoints it. The math follows optax 0.2
term by term; three of its rules matter to the numbers:

- the schedule is evaluated at the update count *before* its increment,
  so under warmup the first update has learning rate 0;
- ``adamw`` decays every leaf (biases, LayerNorm, the embedding: mask
  None), adding ``weight_decay * param`` to the Adam direction before the
  learning rate scales it;
- ``clip_by_global_norm`` scales by ``max_norm / g_norm`` only when
  ``g_norm >= max_norm``.

Multi-tensor ``torch._foreach_*`` ops keep the update to a few kernels.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import numpy as np
import torch

from dtf_tpu_torch.core import comms

Params = dict
Schedule = Union[float, Callable[[int], float]]


class Transform(NamedTuple):
    init: Callable
    update: Callable


def _lists(*trees, names):
    return [[t[n] for n in names] for t in trees]


def chain(*transforms: Transform) -> Transform:
    """optax's ``chain``. Over a :class:`ShardedTree` each transform's
    output is one again (its norm not yet taken), so a later transform
    still knows which leaves are blocks."""
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            out, s = t.update(updates, s, params)
            if isinstance(updates, ShardedTree):
                out = ShardedTree(out, updates.mesh, zero1=updates.zero1,
                                  model=updates.model)
            updates = out
            new_state.append(s)
        return updates, new_state

    return Transform(init, update)


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ||x||²) over the tensors, in f32."""
    tensors = list(tensors)
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.sqrt(sum(n * n for n in norms))


class ShardedTree(dict):
    """Named tensors over a ``mesh`` of which those named in ``zero1``
    (name → dim) are this rank's ZeRO-1 blocks of that dim over the data
    group and those in ``model`` (name → dim) this rank's blocks over the
    model group; the rest every rank holds whole. The train step hands
    the gradients to the optimizer so (and ``create_train_state`` the
    blocks to ``init``), and :func:`tree_norm` takes the norm of the whole
    tree from it, once: the clipping and the ``grad_norm`` metric read the
    same number, from one collective a step. The per-leaf statistics of
    lamb and adafactor sum their blocks' parts over the data group, one
    collective a transform (:func:`_sum_over_data`)."""

    def __init__(self, tensors: dict, mesh, *, zero1=None, model=None):
        super().__init__(tensors)
        self.mesh = mesh
        self.zero1 = dict(zero1 or {})
        self.model = dict(model or {})
        self.norm = None


def _block_dims(tree) -> dict:
    """name → the dim ZeRO-1 splits over the data group, for the leaves of
    ``tree`` that are blocks; leaves split over a model axis refuse (their
    per-leaf statistics would need the model group too)."""
    if not isinstance(tree, ShardedTree):
        return {}
    if tree.model:
        raise NotImplementedError(
            "lamb / adafactor over a model axis (row-sharded leaves): not "
            "yet ported")
    return {n: d for n, d in tree.zero1.items() if n in tree}


def _whole_shape(tree, name: str) -> tuple:
    """The shape of leaf ``name`` whole: its ZeRO-1 dim times the data
    size."""
    shape = list(tree[name].shape)
    d = _block_dims(tree).get(name)
    if d is not None:
        shape[d] *= tree.mesh.data_size
    return tuple(shape)


def _sum_over_data(tree, parts: dict) -> dict:
    """Each of ``parts`` (key → this rank's partial sum) summed over the
    data group of ``tree``'s mesh: ONE all-reduce of their f32
    concatenation; none when there is no part."""
    if not parts:
        return parts
    keys = list(parts)
    flat = comms.psum(torch.cat([parts[k].float().reshape(-1)
                                 for k in keys]), tree.mesh.data_group)
    return {k: piece.view(parts[k].shape) for k, piece in zip(
        keys, flat.split([parts[k].numel() for k in keys]))}


def tree_norm(tree: dict) -> torch.Tensor:
    """The global L2 norm of a dict of tensors, whole or
    :class:`ShardedTree` (:func:`~dtf_tpu_torch.core.comms.global_norm`:
    every element counted once, whichever ranks hold it; computed once a
    tree)."""
    if isinstance(tree, ShardedTree):
        if tree.norm is None:
            tree.norm = comms.global_norm(tree, tree.mesh, tree.zero1,
                                          tree.model)
        return tree.norm
    return global_norm(tree.values())


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(updates, state, params=None):
        g_norm = tree_norm(updates)
        keep = g_norm < max_norm           # optax's lax.select(trigger, ...)
        return {n: torch.where(keep, t, (t / g_norm) * max_norm)
                for n, t in updates.items()}, state

    return Transform(lambda params: {}, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Transform:
    def init(params):
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(updates, state, params=None):
        names = list(updates)
        g, mu, nu = _lists(updates, state["mu"], state["nu"], names=names)
        # (1 - decay) * g**order + decay * t
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(mu, b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
            torch._foreach_mul(nu, b2))
        count = state["count"] + 1
        # 1 - decay**count in f32, as optax's bias_correction
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
        out = torch._foreach_div(mu_hat, denom)
        return (dict(zip(names, out)),
                {"count": count, "mu": dict(zip(names, mu)),
                 "nu": dict(zip(names, nu))})

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(updates, state, params=None):
        names = list(updates)
        g, p = _lists(updates, params, names=names)
        return dict(zip(names, torch._foreach_add(
            g, torch._foreach_mul(p, weight_decay)))), state

    return Transform(lambda params: {}, update)


def trace(decay: float, nesterov: bool = False) -> Transform:
    def init(params):
        return {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(updates, state, params=None):
        names = list(updates)
        g, t = _lists(updates, state["trace"], names=names)
        new_trace = torch._foreach_add(g, torch._foreach_mul(t, decay))
        out = (torch._foreach_add(g, torch._foreach_mul(new_trace, decay))
               if nesterov else new_trace)
        return dict(zip(names, out)), {"trace": dict(zip(names, new_trace))}

    return Transform(init, update)


def scale_by_learning_rate(learning_rate: Schedule,
                           flip_sign: bool = True) -> Transform:
    """Multiply by ``-lr`` (``lr`` without ``flip_sign``); a schedule is
    read at the count before the increment (optax's
    ``scale_by_schedule``)."""
    def init(params):
        return {"count": 0}

    def update(updates, state, params=None):
        lr = (learning_rate(state["count"]) if callable(learning_rate)
              else learning_rate)
        step = float(np.float32(lr)) * (-1.0 if flip_sign else 1.0)
        names = list(updates)
        out = torch._foreach_mul([updates[n] for n in names], step)
        return dict(zip(names, out)), {"count": state["count"] + 1}

    return Transform(init, update)


def scale(factor: float) -> Transform:
    def update(updates, state, params=None):
        names = list(updates)
        return dict(zip(names, torch._foreach_mul(
            [updates[n] for n in names], factor))), state

    return Transform(lambda params: {}, update)


def scale_by_trust_ratio() -> Transform:
    """optax's ``scale_by_trust_ratio`` (min_norm 0, coefficient 1, eps
    0): each leaf times ‖param‖ / ‖update‖, or 1 where either norm is 0.
    The norms are the whole leaf's: a ZeRO-1 block's squares are summed
    over the data group, every leaf's in one all-reduce."""
    def update(updates, state, params=None):
        names = list(updates)
        blocks = _block_dims(updates)
        sq = {n: torch.stack(torch._foreach_norm(
            [params[n].float(), updates[n].float()])) ** 2 for n in names}
        sq.update(_sum_over_data(updates, {n: sq[n] for n in names
                                           if n in blocks}))
        out = {}
        for n in names:
            p_norm, u_norm = torch.sqrt(sq[n]).unbind()
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            out[n] = updates[n] * ratio.to(updates[n].dtype)
        return out, state

    return Transform(lambda params: {}, update)


def _sq_sums(tree, names, blocks) -> dict:
    """Σx² of each leaf of ``tree`` whole, in f32 (blocks' parts summed
    over the data group in one all-reduce)."""
    sq = {n: torch._foreach_norm([tree[n].float()])[0] ** 2 for n in names}
    sq.update(_sum_over_data(tree, {n: sq[n] for n in names
                                    if n in blocks}))
    return sq


def clip_by_block_rms(threshold: float) -> Transform:
    """optax's ``clip_by_block_rms``: each leaf divided by max(1, its
    RMS / threshold), the RMS of the whole leaf."""
    def update(updates, state, params=None):
        names = list(updates)
        blocks = _block_dims(updates)
        sq = _sq_sums(updates, names, blocks)
        out = {}
        for n in names:
            rms = torch.sqrt(sq[n] / math.prod(_whole_shape(updates, n)))
            out[n] = updates[n] / torch.clamp_min(rms / threshold, 1.0)
        return out, state

    return Transform(lambda params: {}, update)


def scale_by_param_block_rms(min_scale: float = 1e-3) -> Transform:
    """optax's ``scale_by_param_block_rms``: each leaf times the RMS of
    its parameter (whole), or ``min_scale`` where that RMS is at most
    ``min_scale``."""
    def update(updates, state, params=None):
        names = list(updates)
        blocks = _block_dims(updates)
        p = ShardedTree({n: params[n] for n in names}, getattr(
            updates, "mesh", None), zero1=blocks)
        sq = _sq_sums(p, names, blocks)
        out = {}
        for n in names:
            rms = torch.sqrt(sq[n] / math.prod(_whole_shape(updates, n)))
            out[n] = updates[n] * torch.where(
                rms <= min_scale, torch.full_like(rms, min_scale), rms)
        return out, state

    return Transform(lambda params: {}, update)


def factored_dims(shape: tuple, min_dim_size_to_factor: int = 128):
    """(d1, d0): the second-largest and the largest dim of ``shape``, when
    the second-largest is at least ``min_dim_size_to_factor`` (optax's
    ``_factored_dims``: numpy's argsort of the shape); else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def scale_by_factored_rms(decay_rate: float = 0.8,
                          min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30) -> Transform:
    """optax's ``scale_by_factored_rms`` (Adafactor's second moment). A
    leaf whose whole shape factors (:func:`factored_dims`: d1, d0) keeps
    ``v_row`` (the mean of g² + ε over d0) and ``v_col`` (over d1), each
    with the reduced dim kept as 1; another keeps ``v`` (g² + ε) whole;
    the unused two are 0-d zeros. Decay 1 − (count + 1)^−0.8. The update
    is g · (v_row / mean_d1(v_row))^−½ · v_col^−½, or g · v^−½.

    A ZeRO-1 block (dim s): a mean over s, and ``v_row``'s mean over d1
    when s = d1, sum this rank's part, and one all-reduce a step sums them
    all; ``v_row`` / ``v_col`` are then this rank's block of s, or whole
    where s is the dim they reduce."""
    def init(params):
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for n, p in params.items():
            dims = factored_dims(_whole_shape(params, n),
                                 min_dim_size_to_factor)
            zero = torch.zeros((), dtype=p.dtype, device=p.device)
            if dims is None:
                state["v"][n] = torch.zeros_like(p)
                state["v_row"][n], state["v_col"][n] = zero, zero.clone()
                continue
            d1, d0 = dims
            row, col = list(p.shape), list(p.shape)
            row[d0], col[d1] = 1, 1
            state["v_row"][n] = p.new_zeros(row)
            state["v_col"][n] = p.new_zeros(col)
            state["v"][n] = zero.clone()
        return state

    def update(updates, state, params=None):
        names = list(updates)
        blocks = _block_dims(updates)
        t = np.float32(state["count"] + 1)
        decay = float(np.float32(1) - t ** np.float32(-decay_rate))

        def ema(old, total, count):           # the decayed mean of g² + ε
            return decay * old + (1 - decay) * (total / count)

        v_row, v_col = dict(state["v_row"]), dict(state["v_col"])
        v, out, factored, parts = dict(state["v"]), {}, {}, {}
        for n in names:
            g = updates[n]
            shape = _whole_shape(updates, n)
            dims = factored_dims(shape, min_dim_size_to_factor)
            gsq = g * g + epsilon
            if dims is None:
                v[n] = ema(state["v"][n], gsq, 1)
                out[n] = g * v[n] ** -0.5
                continue
            d1, d0 = factored[n] = dims
            row, col = gsq.sum(d0, keepdim=True), gsq.sum(d1, keepdim=True)
            s = blocks.get(n)
            if s == d0:                      # row's sum runs over ranks
                parts[n, "row"] = row
            else:
                v_row[n] = ema(state["v_row"][n], row, shape[d0])
            if s == d1:                      # so do col's and v_row's mean
                parts[n, "col"] = col
                parts[n, "row_mean"] = v_row[n].sum(d1, keepdim=True)
            else:
                v_col[n] = ema(state["v_col"][n], col, shape[d1])
        parts = _sum_over_data(updates, parts)
        for n, (d1, d0) in factored.items():
            shape = _whole_shape(updates, n)
            if (n, "row") in parts:
                v_row[n] = ema(state["v_row"][n], parts[n, "row"], shape[d0])
            if (n, "col") in parts:
                v_col[n] = ema(state["v_col"][n], parts[n, "col"], shape[d1])
            row_mean = (parts[n, "row_mean"] / shape[d1]
                        if (n, "row_mean") in parts
                        else v_row[n].mean(d1, keepdim=True))
            out[n] = (updates[n] * (v_row[n] / row_mean) ** -0.5
                      * v_col[n] ** -0.5)
        return ({n: out[n] for n in names},
                {"count": state["count"] + 1, "v_row": v_row,
                 "v_col": v_col, "v": v})

    return Transform(init, update)


def lamb(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-6, weight_decay: float = 0.0) -> Transform:
    """optax's ``lamb``: Adam's direction (eps 1e-6), plus
    ``weight_decay`` · param, scaled per leaf by the trust ratio, then by
    −lr."""
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_trust_ratio(),
                 scale_by_learning_rate(learning_rate))


def adafactor(learning_rate: Schedule, weight_decay_rate=None) -> Transform:
    """optax's ``adafactor`` at its defaults: the factored second moment
    (decay 0.8, ε 1e-30, factored where the second-largest dim of the
    whole leaf is >= 128), block-RMS clipping at 1, the learning rate,
    the parameter's block RMS (at least 1e-3), ``weight_decay_rate`` ·
    param when given, and the sign flip last."""
    tx = [scale_by_factored_rms(), clip_by_block_rms(1.0),
          scale_by_learning_rate(learning_rate, flip_sign=False),
          scale_by_param_block_rms()]
    if weight_decay_rate is not None:
        tx.append(add_decayed_weights(weight_decay_rate))
    return chain(*tx, scale(-1.0))


def sgd(learning_rate: Schedule, momentum=None,
        nesterov: bool = False) -> Transform:
    if momentum is None:
        return chain(scale_by_learning_rate(learning_rate))
    return chain(trace(momentum, nesterov), scale_by_learning_rate(
        learning_rate))


def adam(learning_rate: Schedule, b1=0.9, b2=0.999, eps=1e-8) -> Transform:
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate: Schedule, b1=0.9, b2=0.999, eps=1e-8,
          weight_decay: float = 1e-4) -> Transform:
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    """params += updates, IN PLACE (optax's ``apply_updates`` returns new
    arrays; updating the module's own tensors saves a copy of the
    parameters)."""
    names = list(params)
    torch._foreach_add_([params[n] for n in names],
                        [updates[n].to(params[n].dtype) for n in names])


# -- schedules (optax's, evaluated in f32) ---------------------------------

def constant_schedule(value: float) -> Callable[[int], float]:
    return lambda count: float(np.float32(value))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    def fn(count):
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return float((np.float32(init_value) - np.float32(end_value)) * frac
                     + np.float32(end_value))
    return fn


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    def fn(count):
        c = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / np.float32(decay_steps)))
        decayed = (np.float32(1) - np.float32(alpha)) * cosine \
            + np.float32(alpha)
        return float(np.float32(init_value) * decayed)
    return fn


def join_schedules(schedules, boundaries) -> Callable[[int], float]:
    def fn(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return fn


def make_lr_schedule(args) -> Schedule:
    """--learning_rate/--lr_schedule/--warmup_steps/--lr_min_ratio → a
    schedule (or a plain float when constant with no warmup). Auto warmup
    (-1) is ``min(1000, train_steps // 10 + 1)`` for decaying schedules,
    0 for constant; the decay runs over ``max(train_steps - warmup, 1)``
    steps, after a linear 0 → lr warmup joined at the boundary."""
    lr = args.learning_rate
    kind = getattr(args, "lr_schedule", "constant")
    warmup = getattr(args, "warmup_steps", -1)
    ratio = getattr(args, "lr_min_ratio", 0.0)
    if warmup < 0:
        warmup = (0 if kind == "constant"
                  else min(1000, args.train_steps // 10 + 1))
    if kind == "constant" and warmup == 0:
        return lr
    decay = max(args.train_steps - warmup, 1)
    if kind == "constant":
        body = constant_schedule(lr)
    elif kind == "linear":
        body = linear_schedule(lr, lr * ratio, decay)
    elif kind == "cosine":
        body = cosine_decay_schedule(lr, decay, alpha=ratio)
    else:
        raise ValueError(f"unknown --lr_schedule={kind!r} "
                         "(constant | linear | cosine)")
    if warmup == 0:
        return body
    return join_schedules([linear_schedule(0.0, lr, warmup), body], [warmup])


def make_optimizer(args, recipe, recipe_uses_wd: bool = False) -> Transform:
    """LR schedule → ``--optimizer`` override (or the launcher's recipe
    default) → :func:`wrap_optimizer`. ``recipe(schedule) -> Transform``;
    ``recipe_uses_wd`` declares that the recipe consumes
    ``--weight_decay``, which otherwise raises when set (a silently
    dropped hyperparameter is worse than an error)."""
    sched = make_lr_schedule(args)
    name = (getattr(args, "optimizer", "") or "").lower()
    wd = getattr(args, "weight_decay", -1.0)

    def reject_wd():
        if wd >= 0.0:
            raise ValueError(
                f"--weight_decay has no effect with "
                f"--optimizer={name or '<recipe default>'}; use "
                "adamw | lamb | adafactor (or a launcher whose recipe "
                "consumes it)")

    if not name:
        if not recipe_uses_wd:
            reject_wd()
        tx = recipe(sched)
    elif name == "sgd":
        reject_wd()
        tx = sgd(sched)
    elif name == "momentum":
        reject_wd()
        tx = sgd(sched, momentum=0.9, nesterov=True)
    elif name == "adam":
        reject_wd()
        tx = adam(sched)
    elif name == "adamw":
        tx = adamw(sched, weight_decay=wd if wd >= 0.0 else 1e-4)
    elif name == "lamb":
        tx = lamb(sched, weight_decay=wd if wd >= 0.0 else 0.0)
    elif name == "adafactor":
        # the schedule is adafactor's learning rate; --weight_decay its
        # weight_decay_rate
        tx = adafactor(sched, weight_decay_rate=wd if wd >= 0.0 else None)
    else:
        raise ValueError(
            f"unknown --optimizer={name!r} "
            "(sgd | momentum | adam | adamw | lamb | adafactor)")
    return wrap_optimizer(tx, args)


def wrap_optimizer(tx: Transform, args) -> Transform:
    """``--clip_grad_norm`` > 0: global-norm clipping before the update
    (it sees the accumulated mean gradient under grad-accum)."""
    clip = getattr(args, "clip_grad_norm", 0.0)
    if clip and clip > 0.0:
        return chain(clip_by_global_norm(clip), tx)
    return tx
