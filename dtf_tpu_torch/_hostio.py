"""Host-plane file writes (the port of ``dtf_tpu._hostio``).

Every file of the run-record plane that another thread or process reads
while this one writes it — the event log's and the serve-log sink's
manifests and shards, the postmortem file, the serve heartbeat,
``TELEMETRY.json``, an exported chrome trace — is written through one of
two primitives:

- :func:`atomic_replace` — a whole-file replace through a unique
  temporary name and ``os.replace``: a reader sees the complete old bytes
  or the complete new bytes, never a prefix. The temporary name carries
  the pid, so concurrent writers never share a staging file.
- :func:`append_line` — a single-writer line append (jsonl). One short
  line a call from the one owning process lands contiguously, and
  readers skip a torn last line. More than one writer to a file is not
  supported.

Standard library only.
"""

from __future__ import annotations

import os
from typing import Union


def atomic_replace(path: str, data: Union[str, bytes]) -> None:
    """Write ``data`` to ``path`` atomically (unique tmp + ``os.replace``).

    A reader opening ``path`` at any moment sees a complete file. A crash
    mid-write leaves the target untouched, and a failed write removes its
    staging file."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    mode = "wb" if isinstance(data, bytes) else "w"
    try:
        with open(tmp, mode) as f:
            f.write(data)
        os.replace(tmp, path)       # the commit point
    except BaseException:
        # an orphan tmp next to a manifest would read as a crashed commit
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def append_line(path: str, line: str) -> None:
    """Append one newline-terminated record to a single-writer jsonl
    file. ``line`` must hold no newline: readers rely on one record a
    line to skip a torn tail."""
    path = os.fspath(path)
    if "\n" in line:
        raise ValueError("append_line takes ONE record (no embedded "
                         "newlines) — the jsonl torn-tail guard depends "
                         "on one-record-per-line")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(line + "\n")


__all__ = ["append_line", "atomic_replace"]
