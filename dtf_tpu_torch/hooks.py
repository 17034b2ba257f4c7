"""Training hooks (counterpart of ``dtf_tpu.hooks``): the begin /
before-step / after-step / end lifecycle of ``tf.train.SessionRunHook``,
run by :class:`dtf_tpu_torch.loop.Trainer` on the host around each step.
The profiler hook is not ported yet.

Over a mesh every rank runs the same hooks at the same steps, so their
collectives (the eval's reduction, a checkpoint's gathers, the
preemption flag's agreement) meet in the same order on every rank; only
the chief's :class:`~dtf_tpu_torch.metrics.MetricWriter` prints."""

from __future__ import annotations

import logging
import signal
import time
from typing import Any, Callable, Mapping

import torch

from dtf_tpu_torch.metrics import H100_PEAK_BF16_FLOPS, MetricWriter

log = logging.getLogger("dtf_tpu_torch")


class StopTraining(Exception):
    """Raised by a hook to end the loop."""


class Hook:
    def begin(self, state: Any) -> None: ...

    def before_step(self, step: int) -> None: ...

    def after_step(self, step: int, state: Any,
                   metrics: Mapping[str, Any]) -> None: ...

    def end(self, state: Any) -> None: ...


class StopAtStepHook(Hook):
    """Stop once ``last_step`` is reached (also before running a step
    when a resumed state is already there)."""

    def __init__(self, last_step: int):
        self.last_step = last_step

    def before_step(self, step):
        if step >= self.last_step:
            raise StopTraining

    def after_step(self, step, state, metrics):
        if step >= self.last_step:
            raise StopTraining


class LoggingHook(Hook):
    """Every ``every_n`` steps, write the step's metrics plus
    ``steps_per_sec``, ``throughput_name`` (default ``tokens_per_sec``;
    with ``tokens_per_step``, the items one step consumes),
    ``mfu`` (with ``model_flops_per_step``, against the H100's dense bf16
    peak) and ``lr`` (with ``lr_schedule``, read at the step count).
    Reading the metrics waits for the step: this is the loop's
    backpressure point."""

    def __init__(self, writer: MetricWriter, every_n: int = 10,
                 lr_schedule=None, *, tokens_per_step=None,
                 model_flops_per_step=None,
                 throughput_name: str = "tokens_per_sec"):
        self.writer = writer
        self.every_n = every_n
        self.lr_schedule = lr_schedule
        self.tokens_per_step = tokens_per_step
        self.model_flops_per_step = model_flops_per_step
        self.throughput_name = throughput_name
        self._t0 = None
        self._last_logged = None

    def begin(self, state):
        self._t0 = time.perf_counter()
        self._last_logged = int(state.step)

    def after_step(self, step, state, metrics):
        if step % self.every_n:
            return
        scalars = {k: float(v) for k, v in metrics.items()}
        now = time.perf_counter()
        sps = (step - self._last_logged) / max(now - self._t0, 1e-9)
        self._t0, self._last_logged = now, step
        scalars["steps_per_sec"] = sps
        if self.tokens_per_step:
            scalars[self.throughput_name] = sps * self.tokens_per_step
        if self.model_flops_per_step:
            scalars["mfu"] = (sps * self.model_flops_per_step
                              / H100_PEAK_BF16_FLOPS)
        if self.lr_schedule is not None:
            lr = self.lr_schedule
            scalars["lr"] = float(lr(step) if callable(lr) else lr)
        self.writer.write_scalars(step, scalars)

    def end(self, state):
        self.writer.flush()


class CheckpointHook(Hook):
    """Save every ``every_n`` steps, and the final step at the end."""

    def __init__(self, ckpt, every_n: int = 100):
        self.ckpt = ckpt
        self.every_n = every_n

    def after_step(self, step, state, metrics):
        if step % self.every_n == 0:
            self.ckpt.save(step, state)

    def end(self, state):
        self.ckpt.save(int(state.step), state, force=True)


class PublishHook(Hook):
    """Weight publishing for the train → serve hot-swap: every ``every_n``
    steps the parameters are published as the next version
    (:class:`dtf_tpu_torch.publish.ParamPublisher`: atomic manifest,
    content digest), and the final parameters at ``end()`` unless the last
    periodic publish covered that step. It rides next to
    :class:`CheckpointHook`: a publish is weights only, for serving.
    ``publisher=None`` (a process that does not save) makes it inert,
    unless ``params_of`` is given: ``params_of(state)`` is the parameters
    to publish, collective over a mesh (a tensor-parallel run gathers
    the whole tensors), so every rank's hook calls it at a publish step,
    only the publishing rank writes, and all take its outcome. A failed
    publish warns and training goes on (``end()`` tries the final step
    again); an injected crash (``crash_in_publish``) goes through."""

    def __init__(self, publisher, every_n: int = 100, *, params_of=None):
        if every_n < 1:
            raise ValueError(f"every_n={every_n} must be >= 1")
        self.publisher = publisher
        self.every_n = every_n
        self.params_of = params_of
        self._last_published_step: int | None = None

    @property
    def _active(self) -> bool:
        return self.publisher is not None or self.params_of is not None

    def _publish(self, step, state) -> None:
        from dtf_tpu_torch.fault.inject import InjectedCrash

        params = (state.params if self.params_of is None
                  else self.params_of(state))
        ok = False
        if self.publisher is not None:
            try:
                self.publisher.publish(step, params)
                ok = True
            except InjectedCrash:
                # the host dies mid-publish (the scenario): end() must not
                # publish again from the loop's finally, as a killed host
                # would not
                self.publisher = self.params_of = None
                raise
            except Exception as e:  # noqa: BLE001 — a failed publish
                # leaves the previous version serving; training continues
                log.warning(
                    "publish at step %d failed (%s: %.200s); the previous "
                    "published version keeps serving", step,
                    type(e).__name__, e)
        if self.params_of is not None:
            # every rank takes the publishing rank's outcome (one tiny
            # all-reduce), so they decide alike whether end() gathers and
            # publishes again
            import torch.distributed as dist

            flag = torch.tensor([int(ok)],
                                device=next(iter(params.values())).device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            ok = bool(flag.item())
        if ok:
            self._last_published_step = step

    def after_step(self, step, state, metrics):
        if self._active and step % self.every_n == 0:
            self._publish(step, state)

    def end(self, state):
        if (self._active
                and int(state.step) != self._last_published_step):
            self._publish(int(state.step), state)


class PreemptionHook(Hook):
    """SIGTERM → save the current step → stop cleanly. The handler only
    sets a flag; the loop acts on it at the next step boundary, so the
    relaunch resumes with no lost step. Over a ``mesh`` the save is
    collective, so the ranks agree first: every ``CHECK_EVERY`` steps the
    flag is OR-reduced over the default group (a reduction the host
    waits on; every step would forfeit the host's run-ahead), and all
    save the same step. Must run ``begin`` in the main thread
    (``signal.signal``); ``end`` restores the previous handler."""

    #: steps between the ranks' agreements on the flag (the JAX hook's)
    CHECK_EVERY = 8

    def __init__(self, ckpt, *, mesh=None):
        self.ckpt = ckpt
        self.mesh = mesh
        self.preempted = False
        self._prev = None

    def begin(self, state):
        self._prev = signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, signum, frame):
        self.preempted = True

    def _agreed(self, step) -> bool:
        if self.mesh is None:
            return self.preempted
        if step % self.CHECK_EVERY:
            return False
        import torch.distributed as dist

        flag = torch.tensor([int(self.preempted)], device=self.mesh.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def after_step(self, step, state, metrics):
        if self._agreed(step):
            self.ckpt.save(step, state, force=True)
            log.warning("preempted: saved step %d, stopping", step)
            raise StopTraining

    def end(self, state):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None


class EvalHook(Hook):
    """Every ``every_n`` steps (and at the end, unless that step was just
    evaluated), run ``eval_step(state, batch)`` over ``batches()`` and
    write the mean of each metric."""

    def __init__(self, eval_step, batches: Callable, writer: MetricWriter,
                 every_n: int = 100, *, place_batch=None):
        self.eval_step = eval_step
        self.batches = batches
        self.writer = writer
        self.every_n = every_n
        self.place_batch = place_batch or (lambda b: b)
        self._last_eval_step = None

    def _run(self, step, state):
        totals, n = {}, 0
        for batch in self.batches():
            for k, v in self.eval_step(state, self.place_batch(batch)).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
        if n:
            self.writer.write_scalars(step,
                                      {k: v / n for k, v in totals.items()})
        self._last_eval_step = step

    def after_step(self, step, state, metrics):
        if step % self.every_n == 0:
            self._run(step, state)

    def end(self, state):
        if self._last_eval_step != int(state.step):
            self._run(int(state.step), state)
