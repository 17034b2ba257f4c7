"""MNIST IDX reader (the port's copy of ``dtf_tpu.data.mnist``).

Reads the classic on-disk format (idx3-ubyte / idx1-ubyte, optionally
``.gz``) from ``--data_dir`` with the reference loader's
shuffle-each-epoch ``next_batch`` semantics; callers fall back to the
synthetic ``mnist`` stream when the files are absent. The JAX package's
native (C++) batch loader is not ported (the host plane).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator

import numpy as np

from dtf_tpu_torch.data.sharded import ShardedEpochs

FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _open(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def read_idx(path: str) -> np.ndarray:
    """Parse an IDX file of uint8 (the MNIST container format)."""
    with _open(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        dtype_code = (magic >> 8) & 0xFF
        ndim = magic & 0xFF
        if magic >> 16 or dtype_code != 0x08:
            raise ValueError(f"{path}: unsupported IDX magic {magic:#x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        if data.size != int(np.prod(dims)):
            raise ValueError(f"{path}: truncated IDX payload")
        return data.reshape(dims)


def write_idx(path: str, arr: np.ndarray, *, gz: bool = False) -> None:
    """Write a uint8 array as an IDX file (:func:`read_idx`'s inverse)."""
    arr = np.asarray(arr, np.uint8)
    header = struct.pack(f">I{arr.ndim}I", 0x0800 | arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(path + (".gz" if gz else ""), "wb") as f:
        f.write(header + arr.tobytes())


def available(data_dir: str) -> bool:
    """All four files (plain or ``.gz``) are in ``data_dir``."""
    return all(
        os.path.exists(os.path.join(data_dir, f))
        or os.path.exists(os.path.join(data_dir, f + ".gz"))
        for f in FILES.values())


class MnistData(ShardedEpochs):
    """Shuffled epochs, host-sharded: images flattened to 784 floats in
    [0, 1], labels int32, reshuffled every epoch; each host reads a
    disjoint 1/host_count of every epoch."""

    def __init__(self, data_dir: str, batch_size: int, *, split: str = "train",
                 seed: int = 0, host_index: int = 0, host_count: int = 1):
        images = read_idx(os.path.join(data_dir, FILES[f"{split}_images"]))
        labels = read_idx(os.path.join(data_dir, FILES[f"{split}_labels"]))
        self.images = (images.reshape(len(images), -1) / 255.0).astype(
            np.float32)
        self.labels = labels.astype(np.int32)
        super().__init__(len(self.images), batch_size, seed=seed,
                         host_index=host_index, host_count=host_count)

    def __iter__(self) -> Iterator[dict]:
        for idx in self._indices():
            yield {"image": self.images[idx], "label": self.labels[idx]}
