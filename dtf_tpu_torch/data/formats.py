"""On-disk formats (the port's copy of ``dtf_tpu.data.formats``' image,
token and Criteo paths).

``NpyImageData`` reads an ``images.npy`` + ``labels.npy`` pair
(memory-mapped; uint8 scaled to [0, 1)) and ``CifarBinData`` the
canonical CIFAR-10 binary batches; :func:`detect_image_data` picks npy,
then CIFAR, for the ResNet launcher, and raises "not yet ported" on a
directory of TFRecord shards (the host plane's reader is not ported)
rather than train on synthetic data in its place. The same files give
the same batches in both packages.

``TokenBinData`` reads a flat little-endian uint16 token stream (uint32
when ``vocab_size > 65535``), the nanoGPT/GPT-2 ``.bin`` convention, and
windows it into causal-LM batches (``mode="clm"``) or BERT's MLM batches
(``mode="mlm"``: dynamic masking with the 80/10/10 recipe). Batches are
deterministic per (seed, step, host), and single examples per (seed,
global index), with the JAX package's numpy draws: the same file gives
the same batches in both packages.

``CriteoCsvData`` reads a Criteo click-log TSV/CSV into Wide&Deep batches
through a memory-mapped column cache built once next to the source, with
the JAX package's parse (crc32 buckets, log1p dense features) and its
epoch order: the same file gives the same batches in both packages.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import tempfile
import zlib
from typing import Iterator, Optional

import numpy as np

from dtf_tpu_torch.data.sharded import ShardedEpochs

Batch = dict

log = logging.getLogger("dtf_tpu_torch")


class NpyImageData(ShardedEpochs):
    """``images.npy`` + ``labels.npy`` ([N, H, W, C] uint8 or float32, and
    [N]), memory-mapped; uint8 images are scaled to [0, 1) f32. ``split``
    other than train reads ``<split>_images.npy``."""

    def __init__(self, data_dir: str, batch_size: int, *,
                 split: str = "train", seed: int = 0, host_index: int = 0,
                 host_count: int = 1):
        prefix = "" if split == "train" else f"{split}_"
        self.images = np.load(os.path.join(data_dir, f"{prefix}images.npy"),
                              mmap_mode="r")
        self.labels = np.load(os.path.join(data_dir, f"{prefix}labels.npy"),
                              mmap_mode="r")
        if len(self.images) != len(self.labels):
            raise ValueError(
                f"images ({len(self.images)}) / labels ({len(self.labels)}) "
                "row counts differ")
        super().__init__(len(self.images), batch_size, seed=seed,
                         host_index=host_index, host_count=host_count)

    @staticmethod
    def available(data_dir: str, split: str = "train") -> bool:
        prefix = "" if split == "train" else f"{split}_"
        return all(os.path.exists(os.path.join(data_dir, f"{prefix}{n}.npy"))
                   for n in ("images", "labels"))

    def __iter__(self) -> Iterator[Batch]:
        for idx in self._indices():
            idx = np.sort(idx)  # sorted fancy-index: sequential mmap reads
            img = np.asarray(self.images[idx])
            if img.dtype == np.uint8:
                img = (img / 255.0).astype(np.float32)
            yield {"image": img.astype(np.float32, copy=False),
                   "label": np.asarray(self.labels[idx]).astype(np.int32)}


class CifarBinData(ShardedEpochs):
    """The CIFAR-10 binary batches (``data_batch_*.bin``, or
    ``test_batch.bin`` for another split): records of 1 label byte and
    the 32×32 R, G and B planes, read whole into memory (180 MB for the
    real dataset) as [N, 32, 32, 3] f32 in [0, 1]."""

    RECORD = 1 + 3 * 32 * 32

    def __init__(self, data_dir: str, batch_size: int, *,
                 split: str = "train", seed: int = 0, host_index: int = 0,
                 host_count: int = 1):
        files = (sorted(glob.glob(os.path.join(data_dir, "data_batch_*.bin")))
                 if split == "train"
                 else [os.path.join(data_dir, "test_batch.bin")])
        if not files:
            raise FileNotFoundError(f"no CIFAR .bin batches in {data_dir}")
        raw = np.concatenate([np.fromfile(f, np.uint8) for f in files])
        if raw.size % self.RECORD:
            raise ValueError("truncated CIFAR binary batch")
        rec = raw.reshape(-1, self.RECORD)
        self.labels = rec[:, 0].astype(np.int32)
        self.images = (rec[:, 1:].reshape(-1, 3, 32, 32)
                       .transpose(0, 2, 3, 1) / 255.0).astype(np.float32)
        super().__init__(len(self.labels), batch_size, seed=seed,
                         host_index=host_index, host_count=host_count)

    @staticmethod
    def available(data_dir: str) -> bool:
        return bool(glob.glob(os.path.join(data_dir, "data_batch_*.bin")))

    def __iter__(self) -> Iterator[Batch]:
        for idx in self._indices():
            yield {"image": self.images[idx], "label": self.labels[idx]}


def _tfrecord_train_pattern(data_dir: str) -> Optional[str]:
    """The train split's TFRecord shards: ``train*`` ones, else any
    ``*.tfrecord*`` when no shard names a split; None when there are
    none."""
    pat = os.path.join(data_dir, "train*.tfrecord*")
    if glob.glob(pat):
        return pat
    files = glob.glob(os.path.join(data_dir, "*.tfrecord*"))
    prefixed = any(os.path.basename(f).startswith(
        ("test", "validation", "val", "eval")) for f in files)
    return os.path.join(data_dir, "*.tfrecord*") \
        if files and not prefixed else None


def _refuse_tfrecord(pattern: str):
    raise NotImplementedError(
        f"TFRecord image shards ({pattern}): not yet ported (the host "
        "plane's TFRecord reader); convert them to images.npy + "
        "labels.npy")


def detect_image_data(data_dir: str, batch_size: int, **kw):
    """npy pair > CIFAR binary > None, for the ResNet launcher; TFRecord
    shards and neither of the others raise "not yet ported"."""
    if not data_dir:
        return None
    if NpyImageData.available(data_dir):
        return NpyImageData(data_dir, batch_size, **kw)
    if CifarBinData.available(data_dir):
        return CifarBinData(data_dir, batch_size, **kw)
    pat = _tfrecord_train_pattern(data_dir)
    if pat:
        _refuse_tfrecord(pat)
    return None


def detect_image_eval_data(data_dir: str, batch_size: int, **kw):
    """The held-out split: ``test_images.npy``/``test_labels.npy`` or
    CIFAR's ``test_batch.bin``; None when there is none (the caller then
    drops eval rather than score on unrelated data). Held-out TFRecord
    shards raise "not yet ported"."""
    if not data_dir:
        return None
    if NpyImageData.available(data_dir, split="test"):
        return NpyImageData(data_dir, batch_size, split="test", **kw)
    if os.path.exists(os.path.join(data_dir, "test_batch.bin")):
        return CifarBinData(data_dir, batch_size, split="test", **kw)
    for split in ("test", "validation", "val", "eval"):
        pat = os.path.join(data_dir, f"{split}*.tfrecord*")
        if glob.glob(pat):
            _refuse_tfrecord(pat)
    return None


class TokenBinData:
    """Flat binary token stream → LM batches: random ``seq_len + 1``
    windows. ``path`` is a ``.bin`` file or a dir holding
    ``<split>.bin``. ``mode="clm"`` yields {input_ids, labels}
    (next-token); ``mode="mlm"`` masks 15% of the positions (of those, 80%
    → ``mask_token``, 10% → a random token, 10% unchanged; all predicted)
    and yields BERT's {input_ids, segment_ids, attention_mask,
    mlm_labels}."""

    #: the SeedSequence salt of the per-example stream (:meth:`example`),
    #: apart from the per-batch one
    EXAMPLE_SALT = 0x5EED_0001

    def __init__(self, path: str, batch_size: int, seq_len: int, *,
                 mode: str = "clm", vocab_size: int = 0,
                 mask_token: int = 103, seed: int = 0,
                 split: str = "train", host_index: int = 0,
                 host_count: int = 1):
        if os.path.isdir(path):
            path = os.path.join(path, f"{split}.bin")
        dtype = np.uint32 if vocab_size > 65535 else np.uint16
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        if len(self.tokens) < seq_len + 1:
            raise ValueError(f"{path}: {len(self.tokens)} tokens < "
                             f"seq_len+1={seq_len + 1}")
        # a sample against silent dtype/vocab mismatches: an id past the
        # vocab would fail the embedding lookup much later
        sample = np.asarray(self.tokens[:65536])
        if vocab_size and int(sample.max()) >= vocab_size:
            raise ValueError(
                f"{path}: token {int(sample.max())} >= vocab_size "
                f"{vocab_size} — wrong file, vocab, or dtype")
        if dtype == np.uint16 and len(sample) >= 64:
            # a uint32 stream misread as uint16 shows as (low, 0) pairs
            odd_zero = (sample[1::2] == 0).mean()
            even_zero = (sample[0::2] == 0).mean()
            if odd_zero > 0.9 and even_zero < 0.5:
                raise ValueError(
                    f"{path}: looks like uint32 tokens read as uint16 "
                    f"({odd_zero:.0%} of odd positions are 0); pass "
                    "vocab_size > 65535 or repack the file")
        if batch_size % host_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{host_count} hosts")
        if mode not in ("clm", "mlm"):
            raise ValueError(f"mode must be clm|mlm, got {mode!r}")
        self.local_batch = batch_size // host_count
        self.seq_len = seq_len
        self.mode = mode
        self.mask_token = mask_token
        #: the vocab of the MLM's random-token draw: the sample's range
        #: when no vocab_size is given
        self.vocab_for_random = vocab_size or int(sample.max()) + 1
        self.seed = seed
        self.host = host_index

    @staticmethod
    def available(path: str, split: str = "train") -> bool:
        """``<path>/<split>.bin``, or a direct ``.bin`` file (train only)."""
        return (split == "train" and os.path.isfile(path)
                and path.endswith(".bin")) or \
            os.path.exists(os.path.join(path, f"{split}.bin"))

    def example(self, index: int) -> Batch:
        """One example ([seq_len] arrays) by GLOBAL example index, keyed
        (seed, ``EXAMPLE_SALT``, index): the same bytes whichever host
        draws it."""
        r = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.EXAMPLE_SALT,
                                    int(index)]))
        s = int(r.integers(0, len(self.tokens) - self.seq_len - 1))
        win = np.asarray(self.tokens[s:s + self.seq_len + 1]).astype(np.int32)
        if self.mode == "clm":
            return {"input_ids": win[:-1], "labels": win[1:]}
        return self._mlm_mask(r, win[:-1])

    def _mlm_mask(self, r: np.random.Generator, ids: np.ndarray) -> Batch:
        """The 80/10/10 dynamic masking of ``ids`` ([B, T] or [T]), drawn
        from ``r`` after the windows."""
        mask_pos = r.random(ids.shape) < 0.15
        labels = np.where(mask_pos, ids, -100).astype(np.int32)
        u = r.random(ids.shape)
        rand_tok = r.integers(0, self.vocab_for_random, ids.shape)
        masked = np.where(mask_pos & (u < 0.8), self.mask_token,
                          np.where(mask_pos & (u < 0.9), rand_tok, ids))
        return {"input_ids": masked.astype(np.int32),
                "segment_ids": np.zeros_like(ids),
                "attention_mask": np.ones_like(ids),
                "mlm_labels": labels}

    def batch(self, step: int) -> Batch:
        r = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host]))
        starts = r.integers(0, len(self.tokens) - self.seq_len - 1,
                            self.local_batch)
        win = np.stack([
            np.asarray(self.tokens[s:s + self.seq_len + 1]) for s in starts
        ]).astype(np.int32)
        if self.mode == "clm":
            return {"input_ids": win[:, :-1], "labels": win[:, 1:]}
        return self._mlm_mask(r, win[:, :-1])

    def __iter__(self) -> Iterator[Batch]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def detect_token_data(data_dir: str, batch_size: int, seq_len: int, *,
                      mode: str, vocab_size: int = 0, split: str = "train",
                      **kw) -> Optional[TokenBinData]:
    """``<dir>/<split>.bin`` (train.bin / val.bin), or a direct ``.bin``
    path for the train split; None when the split is absent. A present but
    unusable non-train split (too short for seq_len) falls back with a
    warning; the train split fails loudly."""
    if not data_dir or not TokenBinData.available(data_dir, split):
        return None
    try:
        return TokenBinData(data_dir, batch_size, seq_len, mode=mode,
                            vocab_size=vocab_size, split=split, **kw)
    except ValueError:
        if split == "train":
            raise
        log.warning("%s/%s.bin exists but is unusable (too short for "
                    "seq_len=%d?); falling back", data_dir, split, seq_len,
                    exc_info=True)
        return None


def _hash_bucket(s: str, buckets: int) -> int:
    # stable across processes and runs (unlike Python's salted hash())
    return zlib.crc32(s.encode()) % buckets


class CriteoCsvData(ShardedEpochs):
    """Criteo click-log TSV/CSV → Wide&Deep batches, streaming-parsed.

    Columns: label, 13 numeric (I1..I13), 26 categorical (C1..C26, any
    strings; the real dataset uses hex ids). Numerics: blank → 0, then
    log1p of the value clipped at 0. Categoricals: crc32 into
    ``hash_buckets`` (blank → bucket 0). Delimiter detected per chunk
    (tab, else comma); CRLF line ends are stripped.

    The first construction parses the text in ``CHUNK_BYTES`` chunks (peak
    memory one chunk) into column files in a cache directory next to the
    source (``<file>.dtfcache-hb<B>-ns<F>``); later constructions
    memory-map the cache. ``DTF_DATA_CACHE`` moves the cache root (keyed by
    a hash of the source path), and an unwritable source directory falls
    back to a per-user tmp root. The cache is rebuilt when the source's
    mtime or size or the parse config changes. Each parse writes
    pid-unique tmp files and renames them into place, so concurrent
    parses never tear the cache.
    """

    CHUNK_BYTES = 64 << 20

    def __init__(self, path: str, batch_size: int, *, hash_buckets: int = 1000,
                 num_sparse: int = 26, seed: int = 0, host_index: int = 0,
                 host_count: int = 1):
        if os.path.isdir(path):
            # precedence: train.txt > *.csv > *.tsv (sorted within each)
            cands = (glob.glob(os.path.join(path, "train.txt"))
                     + sorted(glob.glob(os.path.join(path, "*.csv")))
                     + sorted(glob.glob(os.path.join(path, "*.tsv"))))
            if not cands:
                raise FileNotFoundError(f"no criteo csv/tsv in {path}")
            path = cands[0]
        cache = self._cache_dir(path, hash_buckets, num_sparse)
        meta_path = os.path.join(cache, "meta.json")
        want_meta = {"version": 2,  # v2: CRLF-stripping parser
                     "mtime": os.path.getmtime(path),
                     "size": os.path.getsize(path),
                     "hash_buckets": hash_buckets, "num_sparse": num_sparse}
        n_rows = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if all(meta.get(k) == v for k, v in want_meta.items()):
                n_rows = meta["n_rows"]
        if n_rows is None:
            n_rows = self._build_cache(path, cache, want_meta, hash_buckets,
                                       num_sparse)
        self.labels = np.memmap(os.path.join(cache, "labels.f32"),
                                np.float32, "r", shape=(n_rows,))
        self.dense = np.memmap(os.path.join(cache, "dense.f32"),
                               np.float32, "r", shape=(n_rows, 13))
        self.sparse = np.memmap(os.path.join(cache, "sparse.i32"),
                                np.int32, "r", shape=(n_rows, num_sparse))
        super().__init__(n_rows, batch_size, seed=seed,
                         host_index=host_index, host_count=host_count)

    @staticmethod
    def _cache_dir(path: str, hash_buckets: int, num_sparse: int) -> str:
        """The writable cache directory for ``(path, parse config)``; the
        config is in the name, so builds of different configs never share
        a directory."""
        tag = f"dtfcache-hb{hash_buckets}-ns{num_sparse}"
        root = os.environ.get("DTF_DATA_CACHE")
        if not root:
            d = f"{path}.{tag}"
            try:
                os.makedirs(d, exist_ok=True)
                probe = os.path.join(d, f".w.{os.getpid()}")
                with open(probe, "w"):
                    pass
                os.remove(probe)
                return d
            except OSError:
                root = os.path.join(tempfile.gettempdir(),
                                    f"dtf_data_cache_{os.getuid()}")
        key = zlib.crc32(os.path.abspath(path).encode())
        d = os.path.join(root, f"{os.path.basename(path)}.{key:08x}.{tag}")
        os.makedirs(d, exist_ok=True)
        return d

    @classmethod
    def _build_cache(cls, path: str, cache: str, meta: dict,
                     hash_buckets: int, num_sparse: int) -> int:
        """Chunked parse → column files, renamed into place; returns the
        row count."""
        os.makedirs(cache, exist_ok=True)
        n_cols = 1 + 13 + num_sparse
        n_rows = 0
        names = ("labels.f32", "dense.f32", "sparse.i32")
        tmp = [os.path.join(cache, f"{n}.tmp.{os.getpid()}") for n in names]
        with open(path, "rb") as src, open(tmp[0], "wb") as f_lab, \
                open(tmp[1], "wb") as f_den, open(tmp[2], "wb") as f_spa:
            carry = b""
            while True:
                block = src.read(cls.CHUNK_BYTES)
                if not block:
                    if carry.strip():
                        n_rows += cls._parse_rows(
                            [carry.decode()], path, n_cols, hash_buckets,
                            f_lab, f_den, f_spa)
                    break
                block = carry + block
                nl = block.rfind(b"\n")
                if nl < 0:
                    carry = block
                    continue
                carry = block[nl + 1:]
                lines = block[:nl].decode().split("\n")
                n_rows += cls._parse_rows(lines, path, n_cols, hash_buckets,
                                          f_lab, f_den, f_spa)
        for t, n in zip(tmp, names):
            os.replace(t, os.path.join(cache, n))
        meta_tmp = os.path.join(cache, f"meta.json.tmp.{os.getpid()}")
        with open(meta_tmp, "w") as f:
            json.dump({**meta, "n_rows": n_rows}, f)
        os.replace(meta_tmp, os.path.join(cache, "meta.json"))
        return n_rows

    @staticmethod
    def _parse_rows(lines, path, n_cols, hash_buckets,
                    f_lab, f_den, f_spa) -> int:
        # rstrip("\r"): binary chunking keeps CRLF terminators; without it
        # the last categorical column would hash with a trailing \r
        rows = [ln.rstrip("\r") for ln in lines if ln.rstrip("\r")]
        if not rows:
            return 0
        sep = "\t" if "\t" in rows[0] else ","
        labels = np.empty(len(rows), np.float32)
        dense = np.empty((len(rows), 13), np.float32)
        sparse = np.empty((len(rows), n_cols - 14), np.int32)
        for i, line in enumerate(rows):
            cols = line.split(sep)
            if len(cols) != n_cols:
                raise ValueError(f"{path}: expected {n_cols} columns, "
                                 f"got {len(cols)}")
            labels[i] = float(cols[0])
            dense[i] = [float(c) if c else 0.0 for c in cols[1:14]]
            sparse[i] = [_hash_bucket(c, hash_buckets) if c else 0
                         for c in cols[14:]]
        labels.tofile(f_lab)
        np.log1p(np.maximum(dense, 0.0)).tofile(f_den)
        sparse.tofile(f_spa)
        return len(rows)

    @staticmethod
    def available(path: str) -> bool:
        if os.path.isdir(path):
            return bool(glob.glob(os.path.join(path, "train.txt"))
                        + glob.glob(os.path.join(path, "*.csv"))
                        + glob.glob(os.path.join(path, "*.tsv")))
        return path.endswith((".csv", ".tsv", ".txt")) and os.path.exists(path)

    def __iter__(self) -> Iterator[Batch]:
        for idx in self._indices():
            idx = np.sort(idx)  # sorted fancy-index: sequential mmap reads
            yield {"dense": np.asarray(self.dense[idx]),
                   "sparse": np.asarray(self.sparse[idx]),
                   "label": np.asarray(self.labels[idx])}


def detect_criteo_data(data_dir: str, batch_size: int,
                       **kw) -> Optional[CriteoCsvData]:
    """A Criteo TSV/CSV in ``data_dir`` (or the file itself), else None."""
    if data_dir and CriteoCsvData.available(data_dir):
        return CriteoCsvData(data_dir, batch_size, **kw)
    return None
