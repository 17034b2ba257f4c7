"""Weight publishing: the train → serve transport of the hot-swap (the
port of ``dtf_tpu.publish``).

The trainer publishes parameters-only snapshots every K steps into a
**publish dir**; a serving fleet polls it and rolls new versions across
its replicas without downtime (``Router.start_swap``,
:mod:`dtf_tpu_torch.serve.router`).
Three invariants:

- **Atomic versioned manifest.** A publish is (1) a parameters-only save
  under ``<dir>/<version>/params.pt`` in the port's own format
  (:meth:`dtf_tpu_torch.checkpoint.Checkpointer.save_params`: written
  under a temporary name, renamed into place), (2) a content digest of the
  version directory, (3) one ``PUBLISH_MANIFEST.json`` replacing the
  previous one through a temporary file and ``os.replace``. A crash
  anywhere before (3) leaves the previous manifest, and so the previous
  version, intact (the ``crash_in_publish`` verb lands between (2) and
  (3), the widest window).
- **Monotone versions.** Versions count publishes, not train steps; the
  manifest keeps a ``version -> {step, digest}`` history so a reader can
  fall back past a corrupt newest version with a warning (the guarded
  walk), while an explicitly named version has no fallback.
- **Content digest.** :func:`dir_digest` hashes every file of the
  version directory (name and bytes); :class:`PublishWatcher` verifies it
  before handing parameters to a swap, so a truncated or garbled publish
  is skipped with a warning and the fleet keeps the version it serves.

The JAX package publishes Orbax; the port never reads that. Parameters
are ``{state_dict name: tensor}``: ``hooks.PublishHook`` drives
:class:`ParamPublisher` from the training loop, ``serve_gpt
--publish_dir`` wires :class:`PublishWatcher` to the router's rolling
swap. With ``ParamPublisher.event_log`` set, each committed publish
lands on the run's timeline as ``publish_version`` (after the manifest's
rename: a crashed attempt never appears).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Optional

from dtf_tpu_torch.checkpoint import Checkpointer

log = logging.getLogger("dtf_tpu_torch")

MANIFEST_BASENAME = "PUBLISH_MANIFEST.json"

#: manifest history entries kept (>= the publisher's ``keep``, so every
#: version on disk has a recorded digest)
HISTORY_KEEP = 8


def dir_digest(path: str) -> str:
    """Content digest of every regular file under ``path`` (sorted
    relative path and raw bytes), read in 1-MiB chunks."""
    h = hashlib.sha256()
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            fp = os.path.join(root, name)
            h.update(os.path.relpath(fp, path).encode())
            h.update(b"\0")
            try:
                with open(fp, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
            except OSError:
                h.update(b"<unreadable>")
            h.update(b"\0")
    return "sha256:" + h.hexdigest()


def read_manifest(directory: str) -> Optional[dict]:
    """The publish manifest, or None (nothing published yet, or an
    unreadable file: callers warn and walk the versions on disk)."""
    path = os.path.join(os.fspath(directory), MANIFEST_BASENAME)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError, ValueError) as e:
        log.warning("unreadable publish manifest %s (%s)", path, e)
        return None


def _atomic_write(path: str, text: str) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class ParamPublisher:
    """Trainer-side publisher: parameters-only snapshots and an atomic
    manifest. One per run, on the one process that saves (the launchers
    build it on the chief only). ``keep`` bounds the versions on disk;
    ``wall`` stamps the manifest's ``published_t``."""

    def __init__(self, directory: str, *, keep: int = 3, wall=time.time):
        self.directory = os.fspath(directory)
        self.wall = wall
        os.makedirs(self.directory, exist_ok=True)
        self._ckpt = Checkpointer(self.directory, max_to_keep=keep)
        m = read_manifest(self.directory)
        on_disk = [int(d) for d in os.listdir(self.directory)
                   if d.isdigit()]
        # never reuse a version number with a directory on disk: a crashed
        # publish leaves an uncommitted directory whose bytes are the old
        # attempt's; readers trust only manifest-committed versions, so
        # the orphan is inert until ``keep`` prunes it
        self._next_version = max(int(m["version"]) if m else 0,
                                 max(on_disk, default=0)) + 1
        #: the seam between "version data durable" and "manifest
        #: committed" (``crash_in_publish`` raises here)
        self._pre_commit = None
        self.published = 0
        #: an optional :class:`dtf_tpu_torch.telemetry.events.EventLog`
        self.event_log = None

    @property
    def checkpointer(self) -> Checkpointer:
        return self._ckpt

    def publish(self, step: int, params: dict) -> int:
        """Publish ``params`` (``{state_dict name: tensor}``) as the next
        version; returns it. Durable save, digest, then the manifest's
        rename: a failure before the rename leaves the previous version
        intact, and the next publish takes a fresh number."""
        version = self._next_version
        # consume the number now: a crash below must not let the next
        # publish reuse a version whose directory holds this attempt
        self._next_version = version + 1
        self._ckpt.save_params(version, params)
        digest = dir_digest(os.path.join(self.directory, str(version)))
        if self._pre_commit is not None:
            self._pre_commit(version, step)
        old = read_manifest(self.directory) or {}
        history = dict(old.get("history") or {})
        history[str(version)] = {"step": int(step), "digest": digest}
        for v in sorted(history, key=int)[:-HISTORY_KEEP]:
            del history[v]
        manifest = {"schema": 1, "version": version, "step": int(step),
                    "digest": digest, "published_t": round(self.wall(), 3),
                    "history": history}
        # THE commit point
        _atomic_write(os.path.join(self.directory, MANIFEST_BASENAME),
                      json.dumps(manifest, indent=1, sort_keys=True) + "\n")
        self.published += 1
        if self.event_log is not None:
            # after the rename: only committed versions reach the timeline
            self.event_log.emit("publish_version", version=version,
                                step=int(step), digest=digest)
        log.info("published params version %d (train step %d) to %s",
                 version, step, self.directory)
        return version

    def close(self) -> None:
        self._ckpt.close()


def _known_digest(manifest: Optional[dict], version: int) -> Optional[str]:
    if not manifest:
        return None
    if int(manifest.get("version", -1)) == version:
        return manifest.get("digest")
    return (manifest.get("history") or {}).get(str(version), {}).get("digest")


def published_digest(directory: str, version: int) -> Optional[str]:
    """The digest the manifest records for ``version`` (None when it
    records none)."""
    return _known_digest(read_manifest(os.fspath(directory)), int(version))


def load_published(directory: str,
                   version: Optional[int] = None) -> tuple[int, int, dict]:
    """Published parameters: ``(version, train_step, params)``, the
    parameters ``{state_dict name: CPU tensor}``.

    ``version=None`` is the guarded walk: the manifest's newest version is
    verified against its digest and loaded; a corrupt or unreadable one
    warns and falls back to the next older committed version, raising
    only when nothing is servable. A named ``version`` has no fallback: a
    digest mismatch or a failed load raises."""
    directory = os.fspath(directory)
    manifest = read_manifest(directory)
    ckpt = Checkpointer(directory)

    def try_one(v: int, explicit: bool) -> tuple[int, int, dict]:
        want = _known_digest(manifest, v)
        if want is not None:
            got = dir_digest(os.path.join(directory, str(v)))
            if got != want:
                raise ValueError(
                    f"published version {v} at {directory} fails its "
                    f"digest check ({got[:23]}... != {want[:23]}...) — "
                    "corrupt publish")
        elif explicit:
            log.warning(
                "published version %d at %s has no recorded digest "
                "(manifest pruned/unreadable); restoring unverified", v,
                directory)
        params = ckpt.restore_params(step=v)
        step = int((manifest or {}).get("history", {})
                   .get(str(v), {}).get("step", -1))
        if v == int((manifest or {}).get("version", -2)):
            step = int(manifest["step"])
        return v, step, params

    if version is not None:
        return try_one(int(version), explicit=True)
    on_disk = {int(d) for d in os.listdir(directory) if d.isdigit()}
    if manifest:
        # only manifest-committed versions are candidates: a directory the
        # manifest never named is an orphan of a crashed publish
        known = {int(manifest["version"])} | \
            {int(v) for v in (manifest.get("history") or {})}
        versions = sorted(known & on_disk, reverse=True)
    else:
        versions = sorted(on_disk, reverse=True)
        if versions:
            log.warning("no publish manifest under %s; walking %d on-disk "
                        "version(s) UNVERIFIED", directory, len(versions))
    if not versions:
        raise FileNotFoundError(f"no published version under {directory}")
    last_err: Optional[Exception] = None
    for i, v in enumerate(versions):
        try:
            return try_one(v, explicit=False)
        except Exception as e:  # noqa: BLE001 — any unreadable version
            # falls back (the guarded walk)
            last_err = e
            older = versions[i + 1] if i + 1 < len(versions) else None
            log.warning(
                "published version %d at %s is unservable (%s: %.200s); "
                "falling back to %s", v, directory, type(e).__name__, e,
                f"version {older}" if older is not None
                else "nothing — no older version")
    raise RuntimeError(
        f"every published version under {directory} is unservable "
        f"(tried {versions}); last error: "
        f"{type(last_err).__name__}: {last_err}")


class PublishWatcher:
    """Serve-side poller over a publish dir.

    :meth:`load_new` is what a swap polls: None when nothing is
    new, else ``(version, step, params)`` for a version newer than the
    last applied, digest-verified. A corrupt publish is skipped once with
    a warning and remembered (the fleet keeps serving what it has).
    :meth:`note_applied` after a committed swap; a rolled-back version
    goes into ``skipped``, so only a newer publish is tried again.
    ``last_digest``: the verified digest of the version :meth:`load_new`
    handed over last (what a sharded fleet's other ranks load it with).
    A sharded fleet polls on its leader only: one rank reads the clock
    and the manifest."""

    def __init__(self, directory: str, *, applied_version: int = 0):
        self.directory = os.fspath(directory)
        self.applied_version = applied_version
        self.skipped: set[int] = set()
        self.last_digest: Optional[str] = None

    def manifest(self) -> Optional[dict]:
        return read_manifest(self.directory)

    def poll(self) -> Optional[dict]:
        """The manifest, if it names a version newer than the last applied
        and not already skipped."""
        m = self.manifest()
        if not m:
            return None
        v = int(m.get("version", 0))
        if v <= self.applied_version or v in self.skipped:
            return None
        return m

    def load_new(self) -> Optional[tuple[int, int, dict]]:
        m = self.poll()
        if m is None:
            return None
        v = int(m["version"])
        try:
            got = load_published(self.directory, version=v)
            self.last_digest = _known_digest(m, v)
            return got
        except Exception as e:  # noqa: BLE001 — a corrupt publish must
            # not take serving down: skip it, keep the current version
            self.skipped.add(v)
            log.warning(
                "skipping published version %d at %s (%s: %.200s); the "
                "fleet keeps serving its current version", v,
                self.directory, type(e).__name__, e)
            return None

    def note_applied(self, version: int) -> None:
        self.applied_version = max(self.applied_version, int(version))


__all__ = ["MANIFEST_BASENAME", "ParamPublisher", "PublishWatcher",
           "dir_digest", "load_published", "published_digest",
           "read_manifest"]
