"""The serve-log sink: terminal requests recorded as future training
data (the port of ``dtf_tpu.serve.logsink``).

A scheduler or router attachment that records every terminal ``done``
request — prompt and completion token ids, the param version that
decoded it, its speculative proposal and acceptance counts, TTFT and
latency, its replica — into size-rotated jsonl shards under one
directory, framed by the shared record codec (a CRC32C a record). The
directory reads, record for record, through the JAX package's readers.

Durability:

- every byte goes through :mod:`dtf_tpu_torch._hostio` — records append
  with ``append_line`` (one writer: the serve pump is one thread), the
  manifest commits with ``atomic_replace``;
- a shard enters the manifest only when rotated (or flushed or closed):
  a crash mid-rotation (the ``crash_in_log_rotate`` verb) leaves the
  fully written shard on disk and the next sink over the directory
  adopts it, keeping its name; shard names are never reused;
- no device readback: every fact recorded is a host int or float the
  scheduler already holds.

With an event log attached, rotations (``logsink_rotate``) and adoptions
(``logsink_adopt``) land on the run's timeline.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

from dtf_tpu_torch._hostio import append_line, atomic_replace
from dtf_tpu_torch.data.stream.servelog import (MANIFEST_VERSION,
                                                decode_record, encode_record,
                                                manifest_path, read_manifest,
                                                shard_name)
from dtf_tpu_torch.fault.inject import InjectedCrash

log = logging.getLogger("dtf_tpu_torch")


class LogSink:
    """Size-rotated serve-log writer over one directory.

    ``rotate_bytes`` bounds a shard's payload (checked after each append,
    so one oversized record still lands whole); 0 keeps one shard,
    committed at :meth:`flush` / :meth:`close`. One sink a directory a
    process; a router's replicas share one, and records carry their
    replica. ``events``: an optional
    :class:`dtf_tpu_torch.telemetry.events.EventLog`."""

    def __init__(self, sink_dir: str, *, rotate_bytes: int = 1 << 20,
                 events=None):
        self.dir = os.fspath(sink_dir)
        self.rotate_bytes = int(rotate_bytes)
        #: set before adoption, so a recovery at mount is on the record
        self.events = events
        manifest = read_manifest(self.dir)
        self._shards: list = list(manifest["shards"]) if manifest else []
        self._adopted = self._adopt_orphans()
        #: the open shard: the next index after every shard on disk,
        #: committed or orphaned (two generations never interleave)
        self._shard_index = self._next_index()
        self._open_records = 0
        self._open_bytes = 0
        self._records = 0
        self._rotations = 0
        #: fault seams (install_serve_fault): damage the CRC of the N-th
        #: record written / crash after the N-th rotation's shard is
        #: durable but before its manifest commit
        self._corrupt_at: Optional[int] = None
        self._crash_rotate_at: Optional[int] = None
        self._fault_note = None
        self._injected_corrupt = 0

    # ----------------------------------------------------------- recovery

    def _on_disk(self) -> list:
        try:
            return sorted(n for n in os.listdir(self.dir)
                          if n.startswith("shard-") and n.endswith(".jsonl"))
        except FileNotFoundError:
            return []

    def _adopt_orphans(self) -> int:
        """Fold fully written shards that a crashed rotation left
        uncommitted back into the manifest; record counts come from the
        shard's CRC-valid lines."""
        committed = {s["name"] for s in self._shards}
        adopted = 0
        for name in self._on_disk():
            if name in committed:
                continue
            n = self._count_records(os.path.join(self.dir, name))
            self._shards.append({"name": name, "records": n})
            adopted += 1
            log.warning(
                "serve-log sink %s: adopted orphan shard %s (%d records) "
                "— a previous sink crashed between the shard write and "
                "its manifest commit; committed records are never lost",
                self.dir, name, n)
            if self.events is not None:
                self.events.emit("logsink_adopt", shard=name, records=n)
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
        idx = [int(n[len("shard-"):-len(".jsonl")]) for n in self._on_disk()
               if n[len("shard-"):-len(".jsonl")].isdigit()]
        return max(idx) + 1 if idx else 0

    # ------------------------------------------------------------ writing

    def record(self, rec: dict) -> None:
        """Append one terminal-request record (host facts only)."""
        line = encode_record(rec)
        if self._corrupt_at is not None and self._records == self._corrupt_at:
            # corrupt_log_record: flip the CRC's bits so the body survives
            # but the frame fails, as bit rot would
            self._corrupt_at = None
            self._injected_corrupt += 1
            crc_hex, _, body = line.partition(" ")
            line = f"{int(crc_hex, 16) ^ 0xFFFFFFFF:08x} {body}"
            self._note("corrupt_log_record")
        append_line(os.path.join(self.dir, shard_name(self._shard_index)),
                    line)
        self._records += 1
        self._open_records += 1
        self._open_bytes += len(line) + 1
        if self.rotate_bytes and self._open_bytes >= self.rotate_bytes:
            self._rotate()

    def _rotate(self) -> None:
        """Commit the open shard and start the next. The shard's bytes are
        durable; the manifest replace is the commit point, and the
        injected crash lands between the two."""
        self._shards.append({"name": shard_name(self._shard_index),
                             "records": self._open_records})
        rotation = self._rotations
        self._rotations += 1
        self._shard_index += 1
        self._open_records = 0
        self._open_bytes = 0
        if (self._crash_rotate_at is not None
                and rotation == self._crash_rotate_at):
            self._crash_rotate_at = None
            self._note("crash_in_log_rotate")
            raise InjectedCrash(
                f"injected crash mid-rotation of serve-log shard "
                f"{self._shards[-1]['name']} (the shard is durable; the "
                "manifest commit never ran — adoption must recover it)")
        self._commit_manifest()
        if self.events is not None:
            # only after the commit: a crashed rotation never appears on
            # the timeline as a committed one
            self.events.emit("logsink_rotate",
                             shard=self._shards[-1]["name"],
                             records=self._shards[-1]["records"])

    def _commit_manifest(self) -> None:
        atomic_replace(manifest_path(self.dir), json.dumps({
            "version": MANIFEST_VERSION,
            "shards": self._shards,
            "records": int(sum(s["records"] for s in self._shards)),
        }, indent=1, sort_keys=True))

    def flush(self) -> None:
        """Commit the open shard (if it holds records)."""
        if self._open_records:
            self._rotate()

    def close(self) -> None:
        self.flush()

    # -------------------------------------------------------------- faults

    def arm_corrupt(self, nth: int, note=None) -> None:
        """``corrupt_log_record@N``: damage the CRC of the N-th record
        written (0-based, sink lifetime)."""
        self._corrupt_at = int(nth)
        self._fault_note = note

    def arm_crash_rotate(self, nth: int, note=None) -> None:
        """``crash_in_log_rotate@N``: raise after the N-th rotation's
        shard is durable but before its manifest commit (0-based)."""
        self._crash_rotate_at = int(nth)
        self._fault_note = note

    def _note(self, what: str) -> None:
        if self._fault_note is not None:
            self._fault_note(what)

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Host counters for the launcher's JSON line."""
        return {
            "records": self._records,
            "shards_committed": len(self._shards),
            "open_records": self._open_records,
            "rotations": self._rotations,
            "adopted_shards": self._adopted,
            "injected_corrupt": self._injected_corrupt,
        }


__all__ = ["LogSink"]
