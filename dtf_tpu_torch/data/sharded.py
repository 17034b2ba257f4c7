"""Epoch/shuffle/host-shard iteration for array datasets (the port's copy of
``dtf_tpu.data.sharded``): reshuffle each epoch with a deterministic
per-epoch seed, shard rows disjointly across hosts, as the reference
loader's ``next_batch`` did."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """Deterministic per-epoch permutation (same on every host)."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, epoch])).permutation(n)


class ShardedEpochs:
    """Base class: epoch reshuffle + ``order[host::count]`` row sharding +
    ``local_batch`` windowing. Subclasses implement ``__iter__`` by drawing
    index batches from :meth:`_indices`."""

    def __init__(self, n_rows: int, batch_size: int, *, seed: int,
                 host_index: int, host_count: int):
        if batch_size % host_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{host_count} hosts")
        if n_rows // host_count < batch_size // host_count:
            # _indices() would yield nothing and the epoch loop spin
            # forever: an undersized dataset fails loudly instead
            raise ValueError(
                f"dataset has {n_rows} rows — too few to fill one batch of "
                f"{batch_size} across {host_count} host(s)")
        self.n_rows = n_rows
        self.local_batch = batch_size // host_count
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count

    def batches_per_epoch_uniform(self) -> int:
        """Batches a full epoch gives on EVERY host (the least any host
        fills): a sweep that runs collectives takes the same count on
        every rank, or the ranks deadlock."""
        return (self.n_rows // self.host_count) // self.local_batch

    def _indices(self) -> Iterator[np.ndarray]:
        epoch = 0
        while True:
            order = epoch_order(self.n_rows, self.seed, epoch)
            shard = order[self.host_index::self.host_count]
            for i in range(0, len(shard) - self.local_batch + 1,
                           self.local_batch):
                yield shard[i:i + self.local_batch]
            epoch += 1
