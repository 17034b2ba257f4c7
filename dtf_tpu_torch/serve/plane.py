"""The call plane of a sharded engine: one leader, the other ranks follow.

The reference serves over a mesh from ONE controller: its engine's
programs run under GSPMD on every device at once, so a scheduler, a
client and a health tracker that read the wall clock exist once. The
port runs one process a device, each with its own
:class:`~dtf_tpu_torch.serve.engine.DecodeEngine` (its heads of the model
over the model group, its data line's slots), and the ranks of a model
group must make the same engine calls, with the same operands, in the
same order, or the group's collectives deadlock. Copies of the scheduler
on each rank would not: they read the clock.

So the engine of the mesh's rank 0 LEADS. Each of its device calls (a
prefill chunk, a decode step with the draft and verify inside it, a
draft or verify step alone, a page load or save, the page steps'
warm-up) is first broadcast over the world as one small object
(:func:`dtf_tpu_torch.core.comms.broadcast_object`, counted with the
other collectives), then run by every rank on its own engine. Every
other rank runs :meth:`CallPlane.follow`, a loop that receives and runs
the calls until the leader's stop. This is the port's idiom for the
reference's single-controller GSPMD, not a feature of its own.

Ending: :meth:`CallPlane.leading` broadcasts the stop when its body ends,
``ok`` or not, and the followers return it (a launcher exits non-zero on
a stop that was not ok). A leader may open another round after a
clean one (its followers call :meth:`CallPlane.follow` again), as a
caller that serves and then measures the same engines does. A leader
that fails INSIDE a call does not broadcast (its followers may stand
inside a collective of that call): it raises, its process ends, and its
peers' collectives fail when its connections close, or at the process
group's timeout. A follower's exception ends its process with a
non-zero status the same way. No rank waits longer than the group's
timeout.
"""

from __future__ import annotations

import contextlib
from typing import Callable

from dtf_tpu_torch.core import comms

#: the op of the leader's last message
STOP = "stop"


class CallPlane:
    """The leader/follower protocol over the default process group, the
    leader the world's rank ``src``. ``rank``: this process's world
    rank."""

    def __init__(self, rank: int, src: int = 0):
        self.rank = rank
        self.src = src
        #: the leader stands inside a call it announced
        self.in_call = False
        self.stopped = False

    @property
    def is_leader(self) -> bool:
        return self.rank == self.src

    def call(self, run: Callable, op: str, args: tuple):
        """The leader: announce ``(op, args)`` to every rank, then
        ``run(op, args)`` here; returns what it returns."""
        if not self.is_leader:
            raise RuntimeError("a follower rank makes no engine calls: it "
                               "runs follow() and the leader's calls")
        if self.stopped:
            raise RuntimeError("the leader has stopped its followers")
        comms.broadcast_object((op, args), self.src)
        self.in_call = True
        out = run(op, args)
        self.in_call = False
        return out

    def stop(self, ok: bool = True) -> None:
        """The leader: end every follower's loop (once; a no-op on a
        follower)."""
        if self.is_leader and not self.stopped:
            self.stopped = True
            comms.broadcast_object((STOP, bool(ok)), self.src)

    def follow(self, run: Callable) -> bool:
        """A follower: run each call the leader announces, until its stop;
        returns whether the leader stopped cleanly."""
        if self.is_leader:
            raise RuntimeError("the leader makes the calls; follow() is "
                               "for the other ranks")
        while True:
            op, args = comms.broadcast_object(None, self.src)
            if op == STOP:
                return bool(args)
            run(op, args)

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
