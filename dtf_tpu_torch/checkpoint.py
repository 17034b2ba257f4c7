"""Checkpoints and the model-config manifest (counterpart of ``dtf_tpu.checkpoint``).

The JAX package writes Orbax checkpoints; Orbax is not on the GPU
machine, so the port has its own format. One directory per step,
``<dir>/<step>/``, holding

- ``params.pt``: the parameters, ``{state_dict name: tensor}`` (what
  serving reads, :meth:`Checkpointer.restore_params`);
- ``opt_state.pt``: the optimizer state;
- ``extra.pt``: the module's persistent buffers (``TrainState.extra``:
  BatchNorm's running statistics), ``{state_dict name: tensor}``; a step
  written without it restores as none;
- ``meta.json``: the step and the rng seed.

A weight publish (:mod:`dtf_tpu_torch.publish`) writes parameters-only
steps (:meth:`Checkpointer.save_params`): ``params.pt`` alone.

A step is written under a temporary name and renamed into place, so a
crash mid-save leaves no half step behind; ``max_to_keep`` steps are kept.
Saves are synchronous.

Over a mesh every rank takes part in a save and the chief writes: the
parameters a model axis splits and the optimizer state ZeRO-1 splits are
gathered whole first (``TrainState.layout``), the buffers are the same on
every rank and the chief's are written, and every rank waits at a
barrier until the step is on disk. On restore each rank takes its own
blocks again, so the files do not depend on the world size.

``model_config.json`` (the architecture manifest) sits next to the step
directories: the training launcher writes it, the serving entry points
read it.

With an event log attached (:meth:`Checkpointer.attach_event_log`) a
save, a fallback past an unreadable step and the step a restore loaded
land on the run's timeline (``ckpt_save``, ``ckpt_fallback``,
``ckpt_restore``). The JAX package's ``ckpt_resume_degraded`` belongs to
its named extra items (``restore_extra``: a data stream's state), which
the port does not have yet.
"""

from __future__ import annotations

import json
import logging
import os
import shutil

import torch

log = logging.getLogger("dtf_tpu_torch")

MODEL_CONFIG_BASENAME = "model_config.json"


def save_model_config(directory: str | os.PathLike, config: dict) -> None:
    """Write the architecture manifest next to the checkpoint."""
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, MODEL_CONFIG_BASENAME)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(config, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_model_config(directory: str | os.PathLike) -> dict | None:
    """The manifest in ``directory``, or None (no manifest, or an
    unreadable one — callers fall back to flags, loudly)."""
    path = os.path.join(os.fspath(directory), MODEL_CONFIG_BASENAME)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError) as e:
        log.warning("unreadable %s (%s); falling back to flags", path, e)
        return None


def _map_param_leaves(tree, names: frozenset, fn):
    """``fn(name, tensor)`` on every parameter-shaped leaf of an optimizer
    state (the leaves of a dict keyed by the parameters' names, as adam's
    ``mu``/``nu``), the rest as it is."""
    if isinstance(tree, dict):
        if tree and set(tree) == names:
            return {n: fn(n, t) for n, t in tree.items()}
        return {k: _map_param_leaves(v, names, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_param_leaves(v, names, fn) for v in tree)
    return tree


def _split_like(t, like, dim) -> bool:
    """Whether the optimizer leaf ``t`` is split along ``dim`` as the
    parameter's tensor ``like`` is: ``like``'s rank and extent there.
    adafactor's statistics keep a dim they reduce as 1, and its unused
    slots are 0-d: those are the same on every rank."""
    return (dim is not None and t.ndim == like.ndim
            and t.shape[dim] == like.shape[dim])


def _to_device(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


class Checkpointer:
    """Save / restore a :class:`~dtf_tpu_torch.core.train.TrainState`.

    ``save_interval_steps``: a non-forced :meth:`save` writes only steps
    that are multiples of it. ``max_to_keep``: older steps are deleted
    after each save. ``mesh``: a save and a restore are collective over
    the default process group (module docstring)."""

    def __init__(self, directory: str | os.PathLike, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1, mesh=None):
        self._dir = os.fspath(directory)
        self.mesh = mesh
        self._chief = mesh is None or _rank() == 0
        if self._chief:
            os.makedirs(self._dir, exist_ok=True)
        self._barrier()
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, save_interval_steps)
        #: the step the last latest-step restore loaded (it may be older
        #: than :meth:`latest_step` when the newest step was unreadable)
        self.last_restored_step: int | None = None
        self._event_log = None

    def attach_event_log(self, event_log) -> None:
        """Mirror saves, restore fallbacks and restores onto a
        :class:`dtf_tpu_torch.telemetry.events.EventLog`."""
        self._event_log = event_log

    def _ckpt_event(self, kind: str, /, **fields) -> None:
        if self._event_log is not None:
            self._event_log.emit(kind, directory=self.directory, **fields)

    @property
    def directory(self) -> str:
        return self._dir

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self._dir) if n.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _barrier(self) -> None:
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier()

    def _agree(self, flag: bool) -> bool:
        """The chief's ``flag`` on every rank (one broadcast)."""
        if self.mesh is None:
            return flag
        import torch.distributed as dist

        t = torch.tensor([int(flag)], device=self.mesh.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def _whole(self, state):
        """(params, opt_state) whole: gathered from every rank's blocks."""
        layout, mesh = state.layout, self.mesh
        params = {n: p.detach() for n, p in state.params.items()}
        if layout is None or mesh is None:
            return params, state.opt_state

        def whole(n, t):
            if _split_like(t, layout.shard_leaf(n, params[n], mesh),
                           layout.zero1_dims.get(n)):
                t = layout.gather_leaf(n, t, mesh)
            if _split_like(t, params[n], layout.model_dims.get(n)):
                t = layout.gather_param(n, t, mesh)
            return t

        opt_state = _map_param_leaves(state.opt_state, frozenset(params),
                                      whole)
        return ({n: layout.gather_param(n, p, mesh)
                 for n, p in params.items()}, opt_state)

    def save(self, step: int, state, *, force: bool = False) -> bool:
        """Write ``state`` as step ``step``. Returns True if written:
        an existing step, or (unless ``force``) a step off the save
        interval, is skipped. Over a mesh, collective: every rank must
        call it with the same arguments."""
        step = int(step)
        if not force and step % self.save_interval_steps:
            return False
        if not self._agree(self._chief and step not in self.all_steps()):
            return False
        params, opt_state = self._whole(state)
        if self._chief:
            final = os.path.join(self._dir, str(step))
            tmp = os.path.join(self._dir, f".{step}.tmp{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(params, os.path.join(tmp, "params.pt"))
            torch.save(opt_state, os.path.join(tmp, "opt_state.pt"))
            torch.save({n: t.detach() for n, t in state.extra.items()},
                       os.path.join(tmp, "extra.pt"))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "rng": int(state.rng)}, f)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)
        self._barrier()
        self._ckpt_event("ckpt_save", step=step)
        return True

    def save_params(self, step: int, params: dict) -> bool:
        """Write a PARAMETERS-ONLY step, ``<dir>/<step>/params.pt`` alone
        (``{state_dict name: tensor}``, on the CPU): the weight publish's
        version directory, where ``step`` is a publish version.
        :meth:`restore_params` reads it back. Written under a temporary
        name and renamed into place; ``max_to_keep`` applies. An existing
        step is not rewritten (returns False). Not collective: the caller
        is the one process that publishes."""
        step = int(step)
        if step in self.all_steps():
            return False
        final = os.path.join(self._dir, str(step))
        tmp = os.path.join(self._dir, f".{step}.tmp{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, "params.pt")
        with open(path, "wb") as f:
            torch.save({n: t.detach().cpu() for n, t in params.items()}, f)
            f.flush()
            os.fsync(f.fileno())    # durable before a manifest names it
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)),
                          ignore_errors=True)
        return True

    def _restore_one(self, target, step: int):
        from dtf_tpu_torch.core.train import TrainState

        path = os.path.join(self._dir, str(step))
        params = torch.load(os.path.join(path, "params.pt"),
                            map_location="cpu", weights_only=True)
        if set(params) != set(target.params):
            # a wrong restore target fails the same on every step: say so
            raise KeyError(
                f"checkpoint step {step} at {self._dir} holds parameters "
                f"{sorted(set(params) ^ set(target.params))[:8]} that the "
                "restore target does not (or the reverse) — a different "
                "model configuration")
        extra_path = os.path.join(path, "extra.pt")
        extra = (torch.load(extra_path, map_location="cpu", weights_only=True)
                 if os.path.exists(extra_path) else {})
        if set(extra) != set(target.extra):
            raise KeyError(
                f"checkpoint step {step} at {self._dir} holds buffers "
                f"{sorted(set(extra) ^ set(target.extra))[:8]} that the "
                "restore target does not (or the reverse) — a different "
                "model configuration")
        some = next(iter(target.params.values()))
        opt_state = torch.load(os.path.join(path, "opt_state.pt"),
                               map_location="cpu", weights_only=True)
        layout, mesh = target.layout, self.mesh
        if layout is not None and mesh is not None:
            # this rank's blocks of the whole tensors
            whole = params
            params = {n: layout.shard_param(n, p, mesh)
                      for n, p in whole.items()}

            def mine(n, t):
                if _split_like(t, whole[n], layout.model_dims.get(n)):
                    t = layout.shard_param(n, t, mesh)
                if _split_like(t, params[n], layout.zero1_dims.get(n)):
                    t = layout.shard_leaf(n, t, mesh)
                return t.contiguous()

            opt_state = _map_param_leaves(opt_state, frozenset(params), mine)
        opt_state = _to_device(opt_state, some.device)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with torch.no_grad():
            for n, p in target.params.items():
                p.copy_(params[n])
            for n, t in target.extra.items():
                t.copy_(extra[n])
        return TrainState(step=int(meta["step"]), params=target.params,
                          opt_state=opt_state, rng=int(meta["rng"]),
                          layout=layout, extra=target.extra)

    def restore(self, target, step: int | None = None):
        """Restore into ``target``'s parameter and buffer tensors (in
        place) and return the restored state. With ``step=None`` an unreadable newest step
        falls back to the next older one, with a warning; a parameter- or
        buffer-name mismatch (a wrong target) raises at once."""
        if step is not None:
            return self._restore_one(target, step)
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"no checkpoint found under {self._dir}")
        for i, s in enumerate(steps):
            try:
                state = self._restore_one(target, s)
            except KeyError:
                raise
            except Exception as e:  # noqa: BLE001 — any unreadable step
                older = steps[i + 1] if i + 1 < len(steps) else None
                log.warning("checkpoint step %d at %s is unreadable (%s: "
                            "%.200s); falling back to %s", s, self._dir,
                            type(e).__name__, e,
                            f"step {older}" if older is not None
                            else "nothing")
                self._ckpt_event("ckpt_fallback", bad_step=s,
                                 error=type(e).__name__)
                continue
            self.last_restored_step = s
            self._ckpt_event("ckpt_restore", step=s, newest=steps[0])
            return state
        raise RuntimeError(f"every checkpoint step under {self._dir} is "
                           f"unreadable (tried {steps})")

    def restore_if_exists(self, target):
        """(state, restored_step): ``target`` unchanged if nothing is on
        disk."""
        if self.latest_step() is None:
            return target, None
        state = self.restore(target)
        return state, self.last_restored_step

    def restore_params(self, step: int | None = None) -> dict:
        """The parameters alone, ``{state_dict name: CPU tensor}`` — the
        serving entry."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self._dir}")
        self.last_restored_step = step
        return torch.load(os.path.join(self._dir, str(step), "params.pt"),
                          map_location="cpu", weights_only=True)

    def close(self) -> None:
        """Nothing to release: saves are synchronous."""
