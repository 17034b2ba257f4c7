"""Seeded serve faults from ``DTF_FAULT_INJECT`` (the serve family of
``dtf_tpu.fault.inject``).

A plan is ``<kind>@<tick>[:replica=<k>]``: ``tick`` counts in the
target's own call domain (the k-th decode call of a replica's engine, or
the N-th submit for the poison verbs), so a plan is deterministic under
open-loop Poisson timing; ``replica`` scopes it to one replica (None =
every replica). :func:`dtf_tpu_torch.serve.health.install_serve_fault`
arms a plan on a live router or scheduler. The parser knows every serve
kind of the reference, so a plan of a verb whose target is not ported
yet parses and raises when installed; the trainer's and the data
stream's verbs ride past it (``from_env`` returns None for them).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

ENV_VAR = "DTF_FAULT_INJECT"

#: the serve-tier verbs, the reference's list: the router's hot-swap
#: (``corrupt_publish``, ``wedge_in_swap``), the serve-log sink's and the
#: event log's are parsed but not installable yet
SERVE_KINDS = ("wedge_replica", "slow_decode", "poison_request",
               "poison_draft", "corrupt_publish", "wedge_in_swap",
               "corrupt_log_record", "crash_in_log_rotate",
               "crash_in_event_rotate")


class InjectedCrash(RuntimeError):
    """A crash payload — a host died, in exception form."""


class InjectedPoison(RuntimeError):
    """The ``poison_request@N`` payload — a request whose prefill raises
    wherever it lands (the scheduler must isolate it)."""


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
        if not spec or spec.partition("@")[0].strip() not in SERVE_KINDS:
            return None        # trainer verbs ride past the serve installer
        return cls.parse(spec)


__all__ = ["ENV_VAR", "InjectedCrash", "InjectedPoison", "SERVE_KINDS",
           "ServeFaultPlan"]
