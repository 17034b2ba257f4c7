"""The call plane of sharded serving: one leader, the other ranks follow.

The reference serves over a mesh from ONE controller: its engines'
programs run under GSPMD on every device at once, so a router, a
scheduler, a client and a health tracker that read the wall clock exist
once. The port runs one process a device, each with its own
:class:`~dtf_tpu_torch.serve.engine.DecodeEngine` replicas (their heads
of the model over the model group, their data line's slots), and the
ranks of a model group must make the same engine calls, with the same
operands, in the same order, or the group's collectives deadlock. Copies
of the router or the scheduler on each rank would not: they read the
clock.

So the mesh's rank 0 LEADS. Each rank holds ONE plane, shared by every
engine of its fleet (a single engine is a fleet of one); the engines
join it in construction order, so an engine's index is the same on
every rank. Each device call of a leader's engine (a prefill chunk, a
decode step with the draft and verify inside it, a draft or verify step
alone, a page load or save, the page steps' warm-up, a weight swap) is
first broadcast over the world as one small object
(:func:`dtf_tpu_torch.core.comms.broadcast_object`, counted with the
other collectives), then run by every rank on its own engine of that
index. The fleet's own steps are calls too, addressed to the fleet
(:data:`FLEET`): the swap's staging of a new version, its commit and its
rollback (each of which also frees the stale prefix pages). Every other
rank runs :meth:`CallPlane.follow`, a loop that receives and runs the
calls until the leader's stop. This is the port's idiom for the
reference's single-controller GSPMD, not a feature of its own.

A message is ``(target, op, args)``: ``target`` the engine's index in the
plane, or :data:`FLEET`; ``op`` the call (``"prefill"``, ``"decode"``,
``"draft"``, ``"verify"``, ``"page_load"``, ``"page_save"``,
``"page_warm"``, ``"swap"``; the fleet's ``"stage"``, ``"commit"``,
``"rollback"``); ``args`` host values only. No parameter tensor crosses
the group: a swap names a set of shard tensors that every rank staged
itself (:class:`ShardSets`; a new version each rank loads from the
publish directory at the version the leader verified). Steps that touch
no device state (the scheduling, a quarantine and its requeue, the skew
tripwire) run on the leader alone; the followers see only the calls they
lead to.

Faults: a fault verb acts on the leader BEFORE the call it disturbs is
announced (a sleep before a decode, a raise before a prefill chunk or a
swap, a corrupted version before the leader's load), so every rank runs
the same calls. A leader that fails INSIDE a call does not broadcast
(its followers may stand inside a collective of that call): it raises,
its process ends, and its peers' collectives fail when its connections
close, or at the process group's timeout.

Ending: :meth:`CallPlane.leading` broadcasts the stop when its body ends,
``ok`` or not, and the followers return it (a launcher exits non-zero on
a stop that was not ok). A leader may open another round after a clean
one (its followers call :meth:`CallPlane.follow` again), as a caller that
serves and then measures the same engines does. A follower's exception
ends its process with a non-zero status the same way. No rank waits
longer than the group's timeout.

Each rank keeps ``op_stats``: a call's count, its seconds on this rank
(the run, not the announcement) and the counted collectives it took,
the announcing broadcast included, by op.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Hashable, Optional

from dtf_tpu_torch.core import comms

#: the op of the leader's last message
STOP = "stop"
#: the target of a fleet-level call (an engine's is its index)
FLEET = "fleet"


class ShardSets:
    """The shard sets a rank holds for a swap, by key: a version staged
    on every rank, and the sets the replicas served when it was staged
    (what a rollback rebinds). Keys are host values the leader announces;
    the tensors stay on their rank. A key names the same set on every
    rank because every rank registers its sets in the same order."""

    def __init__(self):
        self._sets: dict[Hashable, dict] = {}

    def put(self, key: Hashable, tensors: dict) -> None:
        self._sets[key] = tensors

    def get(self, key: Hashable) -> dict:
        return self._sets[key]

    def key_of(self, tensors: dict) -> Hashable:
        """The first key whose set holds exactly ``tensors``, by identity;
        ``KeyError`` if none does (a set no rank staged cannot be
        swapped in over a mesh)."""
        for key, held in self._sets.items():
            if held.keys() == tensors.keys() and all(
                    held[n] is x for n, x in tensors.items()):
                return key
        raise KeyError("these tensors are no staged shard set: over a "
                       "mesh a swap takes a set every rank staged "
                       "(Router.start_swap with a source)")

    def keep_only(self, keys=()) -> None:
        """Drop every set but ``keys``' (a settled roll): the tensors
        a replica no longer serves are freed on this rank."""
        self._sets = {k: v for k, v in self._sets.items() if k in keys}

    def __len__(self) -> int:
        return len(self._sets)


class CallPlane:
    """The leader/follower protocol over the default process group, the
    leader the world's rank ``src``. ``rank``: this process's world
    rank."""

    def __init__(self, rank: int, src: int = 0):
        self.rank = rank
        self.src = src
        #: the engines on this plane, by index (the same on every rank)
        self.members: list = []
        #: what runs :data:`FLEET` calls (a router), if any
        self.fleet = None
        #: the shard sets of a roll on this rank
        self.sets = ShardSets()
        #: the leader stands inside a call it announced
        self.in_call = False
        self.stopped = False
        #: op → {"calls", "seconds", "collectives"} on this rank
        self.op_stats: dict[str, dict] = {}

    @property
    def is_leader(self) -> bool:
        return self.rank == self.src

    def join(self, engine) -> int:
        """Add ``engine`` to the plane; returns its index."""
        self.members.append(engine)
        return len(self.members) - 1

    def _note(self, op: str, before: dict, seconds: float) -> None:
        st = self.op_stats.setdefault(
            op, {"calls": 0, "seconds": 0.0,
                 "collectives": dict.fromkeys(comms.collective_counts, 0)})
        st["calls"] += 1
        st["seconds"] += seconds
        for k, v in comms.collective_counts.items():
            st["collectives"][k] += v - before[k]

    def call(self, target, run: Callable, op: str, args: tuple):
        """The leader: announce ``(target, op, args)`` to every rank, then
        ``run(op, args)`` here; returns what it returns."""
        if not self.is_leader:
            raise RuntimeError("a follower rank makes no engine calls: it "
                               "runs follow() and the leader's calls")
        if self.stopped:
            raise RuntimeError("the leader has stopped its followers")
        before = dict(comms.collective_counts)
        comms.broadcast_object((target, op, args), self.src)
        self.in_call = True
        t0 = time.perf_counter()
        out = run(op, args)
        t1 = time.perf_counter()
        self.in_call = False
        self._note(op, before, t1 - t0)
        return out

    def stop(self, ok: bool = True) -> None:
        """The leader: end every follower's loop (once; a no-op on a
        follower)."""
        if self.is_leader and not self.stopped:
            self.stopped = True
            comms.broadcast_object((None, STOP, bool(ok)), self.src)

    def follow(self) -> bool:
        """A follower: run each call the leader announces on this rank's
        engine of its index (or the fleet), until the leader's stop;
        returns whether it stopped cleanly."""
        if self.is_leader:
            raise RuntimeError("the leader makes the calls; follow() is "
                               "for the other ranks")
        while True:
            before = dict(comms.collective_counts)
            target, op, args = comms.broadcast_object(None, self.src)
            if op == STOP:
                return bool(args)
            who = self.fleet if target == FLEET else self.members[target]
            t0 = time.perf_counter()
            who._run_op(op, args)
            self._note(op, before, time.perf_counter() - t0)

    @contextlib.contextmanager
    def leading(self):
        """The leader's serving round: on leaving it the followers are
        stopped, ``ok`` unless the body raised (module docstring: not
        from inside a call)."""
        self.stopped = False
        try:
            yield self
        except BaseException:
            if not self.in_call:
                self.stop(ok=False)
            raise
        self.stop(ok=True)


def shared_plane(engines) -> Optional[CallPlane]:
    """The one plane ``engines`` share (None without a mesh); raises when
    sharded engines sit on different planes or mix with unsharded ones:
    a fleet's calls must reach every rank in one order."""
    planes = {id(getattr(e, "_plane", None)): getattr(e, "_plane", None)
              for e in engines}
    if len(planes) != 1:
        raise ValueError(
            "a sharded fleet's engines must share ONE call plane (build "
            "them with weights_from= the first, as Router.build does)")
    return next(iter(planes.values()))
