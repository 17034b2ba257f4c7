"""Token files (the port's copy of ``dtf_tpu.data.formats``' token path).

``TokenBinData`` reads a flat little-endian uint16 token stream (uint32
when ``vocab_size > 65535``), the nanoGPT/GPT-2 ``.bin`` convention, and
windows it into causal-LM batches (``mode="clm"``). Batches are
deterministic per (seed, step, host) with the JAX package's numpy draws:
the same file gives the same batches in both packages. The BERT
``mode="mlm"`` (dynamic masking) comes with the BERT slice.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, Optional

import numpy as np

Batch = dict

log = logging.getLogger("dtf_tpu_torch")


class TokenBinData:
    """Flat binary token stream → LM batches: random ``seq_len + 1``
    windows. ``path`` is a ``.bin`` file or a dir holding
    ``<split>.bin``."""

    def __init__(self, path: str, batch_size: int, seq_len: int, *,
                 mode: str = "clm", vocab_size: int = 0, seed: int = 0,
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
        if mode == "mlm":
            raise NotImplementedError(
                "TokenBinData mode='mlm' is not yet ported (BERT slice)")
        if mode != "clm":
            raise ValueError(f"mode must be clm|mlm, got {mode!r}")
        self.local_batch = batch_size // host_count
        self.seq_len = seq_len
        self.seed = seed
        self.host = host_index

    @staticmethod
    def available(path: str, split: str = "train") -> bool:
        """``<path>/<split>.bin``, or a direct ``.bin`` file (train only)."""
        return (split == "train" and os.path.isfile(path)
                and path.endswith(".bin")) or \
            os.path.exists(os.path.join(path, f"{split}.bin"))

    def batch(self, step: int) -> Batch:
        r = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host]))
        starts = r.integers(0, len(self.tokens) - self.seq_len - 1,
                            self.local_batch)
        win = np.stack([
            np.asarray(self.tokens[s:s + self.seq_len + 1]) for s in starts
        ]).astype(np.int32)
        return {"input_ids": win[:, :-1], "labels": win[:, 1:]}

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
