"""The serve-log record codec and manifest (the port of
``dtf_tpu.data.stream.servelog``).

The serving fleet's :class:`dtf_tpu_torch.serve.logsink.LogSink` records
every terminal ``done`` request into size-rotated jsonl shards, and the
fleet's :class:`dtf_tpu_torch.telemetry.events.EventLog` frames its
events the same way. The on-disk format is the JAX package's, byte for
byte, so a directory either package writes reads through the other's
readers:

- ``shard-00000.jsonl`` … — one record a line, framed
  ``"<crc32c:08x> <body>"`` where ``body`` is compact key-sorted JSON;
  the CRC covers the body bytes, and a reader that finds it wrong skips
  the record;
- ``SERVELOG_MANIFEST.json`` — the atomic commit point: the ordered list
  of committed shards. A shard enters it once rotated (or flushed); a
  crash mid-rotation leaves a fully written shard that the next sink over
  the directory adopts.

``ServeLogSource`` (the serve log mounted as a training stream source,
``--stream_spec``'s ``servelog``) is not ported yet and raises.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from dtf_tpu_torch.data.tfrecord import crc32c

#: the sink directory's atomic commit point (written via atomic_replace)
MANIFEST_BASENAME = "SERVELOG_MANIFEST.json"

#: manifest schema version
MANIFEST_VERSION = 1

#: shard naming: index-ordered, so the manifest's list and a directory
#: sort agree on shard order
SHARD_FMT = "shard-%05d.jsonl"


def encode_record(rec: dict) -> str:
    """One record → one framed jsonl line (no trailing newline). The body
    is compact key-sorted JSON, so a record always encodes to the same
    bytes and its CRC is a function of its content."""
    body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    return f"{crc32c(body.encode()):08x} {body}"


def decode_record(line: str) -> Optional[dict]:
    """Framed line → record, or None when the frame, CRC or JSON is
    damaged (the caller decides whether to skip or count)."""
    crc_hex, sep, body = line.partition(" ")
    if not sep or len(crc_hex) != 8:
        return None
    try:
        crc = int(crc_hex, 16)
    except ValueError:
        return None
    if crc32c(body.encode()) != crc:
        return None
    try:
        rec = json.loads(body)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


def shard_name(index: int) -> str:
    return SHARD_FMT % int(index)


def manifest_path(sink_dir: str) -> str:
    return os.path.join(sink_dir, MANIFEST_BASENAME)


def read_manifest(sink_dir: str) -> Optional[dict]:
    """The committed-shard list, or None when the directory never
    committed one (adoption handles orphan shards either way)."""
    try:
        with open(manifest_path(sink_dir)) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        return None
    if int(manifest.get("version", -1)) != MANIFEST_VERSION:
        raise ValueError(
            f"serve-log manifest version {manifest.get('version')!r} != "
            f"{MANIFEST_VERSION} under {sink_dir!r}")
    return manifest


class ServeLogSource:
    """The serve log as a stream source: not yet ported (it comes with
    ``--stream_spec``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ServeLogSource (the serve log as a --stream_spec source) is "
            "not yet ported")


__all__ = ["MANIFEST_BASENAME", "MANIFEST_VERSION", "SHARD_FMT",
           "ServeLogSource", "decode_record", "encode_record",
           "manifest_path", "read_manifest", "shard_name"]
