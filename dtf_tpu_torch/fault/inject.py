"""Seeded faults from ``DTF_FAULT_INJECT`` (the port of
``dtf_tpu.fault.inject``).

One variable, one grammar, three families of verbs:

- **training** (:class:`FaultPlan`, ``<kind>@<step>[:host=<k>]``), run by
  :class:`FaultHook` at the seeded step of the training loop:
  ``kill`` (SIGKILL: no save, the relaunch resumes from the last
  periodic checkpoint), ``wedge`` (alive, never completing another
  step), ``sigterm`` (graceful preemption at the step boundary),
  ``sigterm_in_save`` (SIGTERM from inside ``Checkpointer.save``),
  ``crash`` (:class:`InjectedCrash` at the step) and ``crash_in_publish``
  (:class:`InjectedCrash` between a publish's durable data and its
  manifest commit); ``host`` scopes a plan to one process;
- **serving** (:class:`ServeFaultPlan`, ``<kind>@<tick>[:replica=<k>]``):
  ``tick`` counts in the target's own call domain (the k-th decode call
  of a replica's engine, the N-th submit, the N-th swap or published
  version), so a plan is deterministic under open-loop Poisson timing;
  :func:`dtf_tpu_torch.serve.health.install_serve_fault` arms it;
- **the data stream** (``stall_source``, ``corrupt_record``): its target
  is not ported, so the training launchers raise on it
  (:func:`maybe_hook`).

Each family's ``from_env`` returns None for the others' verbs; an unknown
verb raises. :func:`corrupt_publish_version` damages a published version
on disk (the ``corrupt_publish`` serve verb's payload).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Mapping, Optional

ENV_VAR = "DTF_FAULT_INJECT"

#: the training verbs (the reference's list)
KINDS = ("kill", "wedge", "sigterm", "sigterm_in_save", "crash",
         "crash_in_publish")

#: the serve-tier verbs (the reference's list), armed by
#: :func:`dtf_tpu_torch.serve.health.install_serve_fault`
SERVE_KINDS = ("wedge_replica", "slow_decode", "poison_request",
               "poison_draft", "corrupt_publish", "wedge_in_swap",
               "corrupt_log_record", "crash_in_log_rotate",
               "crash_in_event_rotate")

#: the data stream's verbs (the reference's list); not yet ported
STREAM_KINDS = ("stall_source", "corrupt_record")


class InjectedCrash(RuntimeError):
    """A crash payload — a host died, in exception form."""


class InjectedPoison(RuntimeError):
    """The ``poison_request@N`` payload — a request whose prefill raises
    wherever it lands (the scheduler must isolate it)."""


def _kind_of(spec: str) -> str:
    return spec.partition("@")[0].strip()


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One seeded training fault: ``<kind>@<step>[:host=<k>]``."""

    kind: str
    step: int
    host: Optional[int] = None     # None = every host

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        body, _, tail = spec.strip().partition(":")
        kind, at, step = body.partition("@")
        if not at:
            raise ValueError(
                f"fault spec {spec!r} needs '<kind>@<step>'")
        host = None
        if tail:
            key, _, val = tail.partition("=")
            if key != "host":
                raise ValueError(
                    f"unknown fault option {key!r} in {spec!r}")
            host = int(val)
        return cls(kind=kind, step=int(step), host=host)

    @classmethod
    def from_env(cls, env: Optional[Mapping] = None) -> Optional["FaultPlan"]:
        spec = (env if env is not None else os.environ).get(ENV_VAR, "")
        kind = _kind_of(spec)
        if not spec or kind in SERVE_KINDS or kind in STREAM_KINDS:
            return None   # serve/stream verbs ride past the trainer hook
        return cls.parse(spec)

    def applies_to(self, host_index: int) -> bool:
        return self.host is None or self.host == host_index


@dataclasses.dataclass(frozen=True)
class ServeFaultPlan:
    """One seeded serve fault: ``<kind>@<tick>[:replica=<k>]``."""

    kind: str
    tick: int
    replica: Optional[int] = None

    def __post_init__(self):
        if self.kind not in SERVE_KINDS:
            raise ValueError(
                f"unknown serve fault kind {self.kind!r}; have {SERVE_KINDS}")
        if self.tick < 0:
            raise ValueError(f"fault tick must be >= 0, got {self.tick}")

    @classmethod
    def parse(cls, spec: str) -> "ServeFaultPlan":
        body, _, tail = spec.strip().partition(":")
        kind, at, tick = body.partition("@")
        if not at:
            raise ValueError(f"fault spec {spec!r} needs '<kind>@<tick>'")
        replica = None
        if tail:
            key, _, val = tail.partition("=")
            if key != "replica":
                raise ValueError(
                    f"unknown serve fault option {key!r} in {spec!r}")
            replica = int(val)
        return cls(kind=kind.strip(), tick=int(tick), replica=replica)

    @classmethod
    def from_env(cls, env: Optional[Mapping] = None
                 ) -> Optional["ServeFaultPlan"]:
        spec = (env if env is not None else os.environ).get(ENV_VAR, "")
        if not spec or _kind_of(spec) not in SERVE_KINDS:
            return None        # trainer verbs ride past the serve installer
        return cls.parse(spec)


class FaultHook:
    """Trainer hook that executes a :class:`FaultPlan` at its seeded step
    (duck-typed against :class:`dtf_tpu_torch.hooks.Hook`).

    Place it FIRST in the hook list: the injected SIGTERM must land before
    ``PreemptionHook.after_step`` runs at the same boundary, so that hook
    saves the exact seeded step. ``checkpointer`` arms ``sigterm_in_save``
    (its ``save`` is wrapped so the signal arrives mid-save), ``publisher``
    arms ``crash_in_publish`` (through its ``_pre_commit`` seam). Each
    firing prints one JSON line first, so a scenario whose recovery check
    fails still shows where the fault landed.
    """

    #: wedge sleep quantum: short, so a SIGKILL reaps it quickly
    WEDGE_POLL_S = 0.5

    def __init__(self, plan: FaultPlan, *, host_index: int = 0,
                 checkpointer=None, publisher=None, emit=None):
        self.plan = plan
        self.host_index = host_index
        self.ckpt = checkpointer
        self._emit = emit or (lambda line: print(line, flush=True))
        self.fired = False
        if (plan.kind == "sigterm_in_save" and checkpointer is not None
                and plan.applies_to(host_index)):
            self._wrap_save(checkpointer)
        if (plan.kind == "crash_in_publish" and publisher is not None
                and plan.applies_to(host_index)):
            self._wrap_publish(publisher)

    def _note(self, what: str) -> None:
        try:
            self._emit(json.dumps({
                "fault_inject": what, "kind": self.plan.kind,
                "step": self.plan.step, "host": self.host_index,
                "pid": os.getpid(), "t": round(time.time(), 3)}))
        except Exception:   # noqa: BLE001 — reporting must not alter the
            pass            # scenario under test

    def _wrap_save(self, ckpt) -> None:
        orig = ckpt.save
        plan = self.plan

        def save(step, state, **kw):
            if not self.fired and step >= plan.step:
                self.fired = True
                self._note("sigterm_in_save")
                # handled at the next bytecode boundary: PreemptionHook's
                # flag is set inside this save call
                os.kill(os.getpid(), signal.SIGTERM)
            return orig(step, state, **kw)

        ckpt.save = save

    def _wrap_publish(self, publisher) -> None:
        """Arm ``crash_in_publish``: the publisher's ``_pre_commit`` seam
        sits after the version's data is durable and before the manifest
        rename, so the crash must leave the previous version servable."""
        plan = self.plan

        def pre_commit(version, step):
            if not self.fired and step >= plan.step:
                self.fired = True
                self._note("crash_in_publish")
                raise InjectedCrash(
                    f"injected crash mid-publish of version {version} "
                    f"(step {step}, host {self.host_index})")

        publisher._pre_commit = pre_commit

    # ------------------------------------------------------- hook lifecycle

    def begin(self, state) -> None: ...

    def before_step(self, step: int) -> None: ...

    def after_step(self, step: int, state, metrics) -> None:
        plan = self.plan
        if (self.fired
                or plan.kind in ("sigterm_in_save", "crash_in_publish")
                or not plan.applies_to(self.host_index)
                or step < plan.step):
            return
        self.fired = True
        self._note("firing")
        if plan.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif plan.kind == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        elif plan.kind == "crash":
            raise InjectedCrash(
                f"injected crash at step {step} (host {self.host_index})")
        elif plan.kind == "wedge":
            # alive but never completing another step: SIGTERM only sets
            # PreemptionHook's flag (checked at a boundary this loop never
            # reaches again), so like a real wedge it takes a SIGKILL; the
            # sleep is on the real clock, what a stall detector measures
            while True:
                time.sleep(self.WEDGE_POLL_S)

    def end(self, state) -> None: ...


def maybe_hook(*, host_index: int = 0, checkpointer=None, publisher=None,
               env: Optional[Mapping] = None) -> Optional[FaultHook]:
    """The training launchers' one-liner: a FaultHook when
    ``DTF_FAULT_INJECT`` names a training verb that targets this host,
    else None. A data-stream verb raises: its target is not ported."""
    spec = (env if env is not None else os.environ).get(ENV_VAR, "")
    if _kind_of(spec) in STREAM_KINDS:
        raise NotImplementedError(
            f"{ENV_VAR}={spec!r}: the data stream's fault verbs "
            f"{STREAM_KINDS} are not yet ported (their target, the "
            "mixture stream, is not)")
    plan = FaultPlan.from_env(env)
    if plan is None or not plan.applies_to(host_index):
        return None
    return FaultHook(plan, host_index=host_index, checkpointer=checkpointer,
                     publisher=publisher)


def corrupt_publish_version(publish_dir: str, version: int, *,
                            mode: str = "garbage",
                            min_bytes: int = 1) -> dict:
    """Damage one published version's files (the ``corrupt_publish`` serve
    verb): ``truncate`` halves every file of at least ``min_bytes``,
    ``garbage`` overwrites its head. The digest check must then skip the
    version with a warning. Returns ``{"version": v, "files": [...]}``."""
    if mode not in ("truncate", "garbage"):
        raise ValueError(f"unknown corruption mode {mode!r}")
    root = os.path.join(publish_dir, str(int(version)))
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"no published version {version} under {publish_dir}")
    touched = []
    for walk_root, _, files in os.walk(root):
        for name in files:
            path = os.path.join(walk_root, name)
            size = os.path.getsize(path)
            if size < min_bytes:
                continue
            with open(path, "r+b") as f:
                if mode == "truncate":
                    f.truncate(size // 2)
                else:
                    f.write(b"\xde\xad\xbe\xef" * 4)
            touched.append(os.path.relpath(path, root))
    return {"version": int(version), "files": sorted(touched)}


__all__ = ["ENV_VAR", "FaultHook", "FaultPlan", "InjectedCrash",
           "InjectedPoison", "KINDS", "SERVE_KINDS", "STREAM_KINDS",
           "ServeFaultPlan", "corrupt_publish_version", "maybe_hook"]
