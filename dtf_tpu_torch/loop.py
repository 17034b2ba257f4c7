"""The training loop (counterpart of ``dtf_tpu.loop``).

``Trainer.fit`` restores the latest checkpoint if one exists, then runs
the hook lifecycle around ``train_step`` until a hook stops it, the data
ends or ``max_steps``. A data source with ``batch(step)`` (the synthetic
and token-file loaders) is read from the step the run resumes at, so a
relaunch sees the batches the interrupted run would have seen; the JAX
launcher restarts its iterator at batch 0 instead.

Host batches (dicts of numpy arrays) are placed on the device by
:func:`place_batch`: pinned host memory, then ``non_blocking`` copies on a
side stream, issued for batch N+1 before step N's result is read, so the
copy overlaps the step.
"""

from __future__ import annotations

import collections
import itertools
import logging
from typing import Callable, Iterable, Sequence

import torch

from dtf_tpu_torch.hooks import Hook, StopTraining

log = logging.getLogger("dtf_tpu_torch")


def place_batch(batch: dict, device: torch.device,
                stream=None) -> dict:
    """numpy → tensors on ``device``. On CUDA: pinned memory and
    ``non_blocking`` copies on ``stream`` (the caller makes its compute
    stream wait on it)."""
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    if device.type != "cuda":
        return tensors
    with torch.cuda.stream(stream):
        return {k: v.pin_memory().to(device, non_blocking=True)
                for k, v in tensors.items()}


class _Prefetch:
    """Yields placed batches, keeping ``ahead`` more placed beyond the one
    being consumed."""

    def __init__(self, batches: Iterable[dict], device: torch.device,
                 ahead: int):
        self._src = iter(batches)
        self._device = device
        self._ahead = max(ahead, 0)
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self._queue: collections.deque = collections.deque()

    def _place_one(self) -> bool:
        try:
            b = next(self._src)
        except StopIteration:
            return False
        self._queue.append(place_batch(b, self._device, self._stream))
        return True

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if not self._queue and not self._place_one():
            raise StopIteration
        batch = self._queue.popleft()
        if self._stream is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_stream(self._stream)
            for v in batch.values():
                v.record_stream(cur)
        # batch N+1's copy is issued before step N runs
        while len(self._queue) < self._ahead and self._place_one():
            pass
        return batch


class Trainer:
    """Hook-driven loop over ``train_step(state, batch) -> (state,
    metrics)`` (:func:`dtf_tpu_torch.core.train.make_train_step`)."""

    def __init__(self, train_step: Callable, device, hooks: Sequence[Hook] = (),
                 *, checkpointer=None, prefetch: int = 2):
        self.train_step = train_step
        self.device = torch.device(device)
        self.hooks = list(hooks)
        self.checkpointer = checkpointer
        #: batches on the device: the step's own plus prefetch - 1 placed
        #: ahead of it (1 = none ahead), ``--prefetch_depth``
        self.prefetch = prefetch

    def _run_hooks(self, method: str, *args) -> None:
        for h in self.hooks:
            getattr(h, method)(*args)

    def fit(self, state, data, *, max_steps: int | None = None):
        """Run until the data ends, a hook stops training, or
        ``max_steps``. Restore-if-exists first."""
        if self.checkpointer is not None:
            state, restored = self.checkpointer.restore_if_exists(state)
            if restored is not None:
                log.info("resumed from checkpoint at step %d", restored)
        self._run_hooks("begin", state)
        step = int(state.step)
        if hasattr(data, "batch"):
            src = (data.batch(s) for s in itertools.count(step))
        else:
            src = iter(data)
        if max_steps is not None:
            src = itertools.islice(src, max(max_steps - step, 0))
        staged = _Prefetch(src, self.device, self.prefetch - 1)
        try:
            while max_steps is None or step < max_steps:
                try:
                    batch = next(staged)
                except StopIteration:
                    break
                self._run_hooks("before_step", step)
                state, metrics = self.train_step(state, batch)
                step += 1
                self._run_hooks("after_step", step, state, metrics)
        except StopTraining:
            pass
        finally:
            self._run_hooks("end", state)
        return state
