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
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state

    return Transform(init, update)


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ||x||²) over the tensors, in f32."""
    tensors = list(tensors)
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.sqrt(sum(n * n for n in norms))


class ShardedTree(dict):
    """Named tensors over a ``mesh`` of which those named in ``zero1`` are
    this rank's ZeRO-1 blocks over the data group and those in ``model``
    this rank's blocks over the model group; the rest every rank holds
    whole. The train step hands the gradients to the optimizer so, and
    :func:`tree_norm` takes the norm of the whole tree from it, once: the
    clipping and the ``grad_norm`` metric read the same number, from one
    collective a step."""

    def __init__(self, tensors: dict, mesh, *, zero1=(), model=()):
        super().__init__(tensors)
        self.mesh = mesh
        self.zero1 = frozenset(zero1)
        self.model = frozenset(model)
        self.norm = None


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


def scale_by_learning_rate(learning_rate: Schedule) -> Transform:
    """Multiply by ``-lr``; a schedule is read at the count before the
    increment (optax's ``scale_by_schedule``)."""
    def init(params):
        return {"count": 0}

    def update(updates, state, params=None):
        lr = (learning_rate(state["count"]) if callable(learning_rate)
              else learning_rate)
        step = -float(np.float32(lr))
        names = list(updates)
        out = torch._foreach_mul([updates[n] for n in names], step)
        return dict(zip(names, out)), {"count": state["count"] + 1}

    return Transform(init, update)


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
    elif name in ("lamb", "adafactor"):
        raise NotImplementedError(
            f"--optimizer={name} is not yet ported (the port has sgd, "
            "momentum, adam and adamw)")
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
