"""The fleet's event log: one structured, durable timeline a run (the
port of ``dtf_tpu.telemetry.events``).

Checkpoint saves and fallbacks, weight publishes, requeue drains, the
rolling swap's start, canary, commit and rollback, health transitions,
SLO excursions, serve-log rotations and the router's tick profile all
land in one log. The on-disk contract is the serve-log sink's, and the
JAX package's, byte for byte:

- ``events-00000.jsonl`` … — one event a line, framed
  ``"<crc32c:08x> <body>"`` by the shared record codec
  (:func:`dtf_tpu_torch.data.stream.servelog.encode_record`);
- ``EVENTS_MANIFEST.json`` — the atomic commit point
  (``atomic_replace``): a shard enters it once rotated or flushed. A
  crash mid-rotation (the ``crash_in_event_rotate`` verb) leaves a fully
  written shard that the next :class:`EventLog` over the directory
  adopts; shard names are never reused. The basenames differ from the
  sink's, so the two can share a directory.

Every record is ``{"event": kind, "seq": n, "t": wall, **fields}``:
``seq`` is the writer's emit counter (the tiebreak when wall stamps
collide), ``t`` the injectable wall clock; a caller's own ``t=`` wins.

Emission never takes a run down: ``emit`` swallows ``OSError`` and
counts it in :meth:`EventLog.stats`; only the injected rotation crash
propagates. Every field is a host value the caller already holds, so
the log adds no device readback. :func:`read_events` never adopts or
commits, so it can read a live run's directory.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import List, Optional

from dtf_tpu_torch._hostio import append_line, atomic_replace
from dtf_tpu_torch.data.stream.servelog import (MANIFEST_VERSION,
                                                decode_record, encode_record)
from dtf_tpu_torch.fault.inject import InjectedCrash

log = logging.getLogger("dtf_tpu_torch")

#: the event log's atomic commit point
EVENTS_MANIFEST_BASENAME = "EVENTS_MANIFEST.json"

#: shard naming: index-ordered, prefix-distinct from ``shard-*.jsonl``
EVENT_SHARD_FMT = "events-%05d.jsonl"


def event_shard_name(index: int) -> str:
    return EVENT_SHARD_FMT % int(index)


def events_manifest_path(events_dir: str) -> str:
    return os.path.join(events_dir, EVENTS_MANIFEST_BASENAME)


def read_events_manifest(events_dir: str) -> Optional[dict]:
    """The committed-shard list, or None (a fresh directory, or one that
    crashed before its first rotation)."""
    try:
        with open(events_manifest_path(events_dir)) as f:
            manifest = json.load(f)
    except (FileNotFoundError, ValueError):
        return None
    if int(manifest.get("version", -1)) != MANIFEST_VERSION:
        raise ValueError(
            f"event manifest version {manifest.get('version')!r} != "
            f"{MANIFEST_VERSION} under {events_dir!r}")
    return manifest


def _on_disk_shards(events_dir: str) -> List[str]:
    try:
        return sorted(n for n in os.listdir(events_dir)
                      if n.startswith("events-") and n.endswith(".jsonl"))
    except FileNotFoundError:
        return []


class EventLog:
    """Size-rotated structured event writer over one directory (module
    docstring). One writer a directory a process (``append_line`` is
    single-writer); a router's fleet shares one — the pump is one thread
    and records carry their replica or subsystem fields."""

    def __init__(self, events_dir: str, *, rotate_bytes: int = 1 << 16,
                 wall=time.time):
        self.dir = os.fspath(events_dir)
        self.rotate_bytes = int(rotate_bytes)
        self.wall = wall
        #: emit and flush may come from more than one thread: the seq and
        #: shard state change under one lock
        self._lock = threading.Lock()
        manifest = read_events_manifest(self.dir)
        self._shards: list = list(manifest["shards"]) if manifest else []
        self._adopted = self._adopt_orphans()
        #: the next shard index after everything on disk, committed or
        #: orphaned: a crashed rotation's name is never reused
        self._shard_index = self._next_index()
        self._seq = 0
        self._open_records = 0
        self._open_bytes = 0
        self._rotations = 0
        self._io_errors = 0
        #: fault seams (install_serve_fault): damage the CRC of the event
        #: with seq N / crash after the N-th rotation's shard is durable
        #: but before its manifest commit
        self._corrupt_at: Optional[int] = None
        self._crash_rotate_at: Optional[int] = None
        self._fault_note = None
        self._injected_corrupt = 0

    # ----------------------------------------------------------- recovery

    def _adopt_orphans(self) -> int:
        """Fold fully written shards that a crashed rotation left
        uncommitted back into the manifest; record counts come from the
        CRC-valid lines."""
        committed = {s["name"] for s in self._shards}
        adopted = 0
        for name in _on_disk_shards(self.dir):
            if name in committed:
                continue
            n = self._count_records(os.path.join(self.dir, name))
            self._shards.append({"name": name, "records": n})
            adopted += 1
            log.warning(
                "event log %s: adopted orphan shard %s (%d events) — a "
                "previous writer crashed between the shard write and its "
                "manifest commit; committed events are never lost",
                self.dir, name, n)
        if adopted:
            self._shards.sort(key=lambda s: s["name"])
            self._commit_manifest()
        return adopted

    @staticmethod
    def _count_records(path: str) -> int:
        with open(path) as f:
            return sum(1 for line in f.read().split("\n")
                       if line and decode_record(line) is not None)

    def _next_index(self) -> int:
        idx = [int(n[len("events-"):-len(".jsonl")])
               for n in _on_disk_shards(self.dir)
               if n[len("events-"):-len(".jsonl")].isdigit()]
        return max(idx) + 1 if idx else 0

    # ------------------------------------------------------------ writing

    def emit(self, kind: str, /, **fields) -> dict:
        """Append one event and return its record. ``fields`` are host
        facts the caller holds; a caller's ``t`` overrides the wall
        stamp, ``event`` and ``seq`` never do. Never raises on IO (the
        error is counted), except for the injected rotation crash."""
        with self._lock:
            rec = {"event": str(kind), "seq": self._seq,
                   "t": round(self.wall(), 6)}
            fields.pop("event", None)
            fields.pop("seq", None)
            rec.update(fields)
            self._seq += 1
            line = encode_record(rec)
            if (self._corrupt_at is not None
                    and rec["seq"] == self._corrupt_at):
                # flip the CRC's bits: the body survives, the frame fails
                # and readers take the skip branch (bit rot)
                self._corrupt_at = None
                self._injected_corrupt += 1
                crc_hex, _, body = line.partition(" ")
                line = f"{int(crc_hex, 16) ^ 0xFFFFFFFF:08x} {body}"
                self._note("corrupt_event_record")
            try:
                append_line(
                    os.path.join(self.dir,
                                 event_shard_name(self._shard_index)),
                    line)
            except OSError:
                self._io_errors += 1
                return rec
            self._open_records += 1
            self._open_bytes += len(line) + 1
            if self.rotate_bytes and self._open_bytes >= self.rotate_bytes:
                self._rotate()
            return rec

    def _rotate(self) -> None:
        """Commit the open shard and start the next. The shard's bytes are
        already durable; the manifest replace is the commit point, and
        the injected crash lands between the two."""
        self._shards.append({"name": event_shard_name(self._shard_index),
                             "records": self._open_records})
        rotation = self._rotations
        self._rotations += 1
        self._shard_index += 1
        self._open_records = 0
        self._open_bytes = 0
        if (self._crash_rotate_at is not None
                and rotation == self._crash_rotate_at):
            self._crash_rotate_at = None
            self._note("crash_in_event_rotate")
            raise InjectedCrash(
                f"injected crash mid-rotation of event shard "
                f"{self._shards[-1]['name']} (the shard is durable; the "
                "manifest commit never ran — adoption must recover it)")
        self._commit_manifest()

    def _commit_manifest(self) -> None:
        try:
            atomic_replace(events_manifest_path(self.dir), json.dumps({
                "version": MANIFEST_VERSION,
                "shards": self._shards,
                "records": int(sum(s["records"] for s in self._shards)),
            }, indent=1, sort_keys=True))
        except OSError:
            self._io_errors += 1

    def flush(self) -> None:
        """Commit the open shard (if it holds events), so a reader sees
        everything emitted so far without orphan recovery."""
        with self._lock:
            if self._open_records:
                self._rotate()

    def close(self) -> None:
        self.flush()

    # -------------------------------------------------------------- faults

    def arm_corrupt(self, nth: int, note=None) -> None:
        """Damage the CRC of the event with ``seq == nth`` (writer
        lifetime): readers must skip it."""
        self._corrupt_at = int(nth)
        self._fault_note = note

    def arm_crash_rotate(self, nth: int, note=None) -> None:
        """``crash_in_event_rotate@N``: raise after the N-th rotation's
        shard is durable but before its manifest commit (0-based)."""
        self._crash_rotate_at = int(nth)
        self._fault_note = note

    def _note(self, what: str) -> None:
        if self._fault_note is not None:
            self._fault_note(what)

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Host counters for a launcher's JSON line."""
        return {
            "events": self._seq,
            "shards_committed": len(self._shards),
            "open_records": self._open_records,
            "rotations": self._rotations,
            "adopted_shards": self._adopted,
            "io_errors": self._io_errors,
            "injected_corrupt": self._injected_corrupt,
        }


def read_events(events_dir: str, *,
                include_orphans: bool = True) -> List[dict]:
    """Every decodable event under ``events_dir`` in causal order:
    committed shards in manifest order, then (by default) orphan shards
    in name order, each shard's lines in write order. Never adopts or
    commits. CRC-damaged lines are dropped."""
    manifest = read_events_manifest(events_dir)
    names = [s["name"] for s in manifest["shards"]] if manifest else []
    if include_orphans:
        committed = set(names)
        names += [n for n in _on_disk_shards(events_dir)
                  if n not in committed]
    out: List[dict] = []
    for name in names:
        try:
            with open(os.path.join(events_dir, name)) as f:
                raw = f.read()
        except OSError:
            continue
        for line in raw.split("\n"):
            if not line:
                continue            # the torn or empty last line
            rec = decode_record(line)
            if rec is not None:
                out.append(rec)
    return out


__all__ = ["EVENTS_MANIFEST_BASENAME", "EventLog", "event_shard_name",
           "events_manifest_path", "read_events", "read_events_manifest"]
