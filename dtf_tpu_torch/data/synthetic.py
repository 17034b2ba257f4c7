"""Synthetic batches (the port's copy of ``dtf_tpu.data.synthetic``).

Deterministic per (seed, step, host) with the same numpy draws as the JAX
package, so both packages see the same batches byte for byte. Ported: the
``mnist`` kind, the ``cifar`` (32×32×3, 10 classes learnable from the
mean colour) and ``imagenet`` (224×224×3, 1000 random classes) image
kinds (NHWC f32 in [0, 1)), the ``bert`` kind (MLM batches: 15% of
random tokens masked to [MASK] = 103, labels -100 elsewhere, one
segment, no padding), the ``gpt`` kind (causal-LM next-token batches)
and the ``widedeep`` kind (13 dense + ``num_sparse`` categorical
Criteo-like features).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

Batch = dict

#: the kinds of the JAX package, all drawn by the port
KINDS = ("mnist", "cifar", "imagenet", "bert", "gpt", "widedeep")


def _rng_for(seed: int, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, host]))


class SyntheticData:
    """Host-sharded synthetic batches. ``batch(step)`` is addressable by
    step, so a resumed run draws the batch of the step it resumes at."""

    def __init__(self, kind: str, batch_size: int, *, seed: int = 0,
                 host_index: int = 0, host_count: int = 1,
                 seq_len: int = 128, vocab_size: int = 30522,
                 num_sparse: int = 26, hash_buckets: int = 1000):
        if batch_size % host_count:
            raise ValueError(
                f"global batch {batch_size} not divisible by {host_count} "
                "hosts")
        if kind not in KINDS:
            raise ValueError(f"unknown synthetic dataset kind: {kind!r}")
        self.kind = kind
        self.global_batch = batch_size
        self.local_batch = batch_size // host_count
        self.seed = seed
        self.host = host_index
        self.seq_len = seq_len
        self.vocab = vocab_size
        self.num_sparse = num_sparse
        self.hash_buckets = hash_buckets

    def batch(self, step: int) -> Batch:
        r = _rng_for(self.seed, step, self.host)
        n = self.local_batch
        if self.kind == "mnist":
            x = r.random((n, 784), np.float32)
            w = _rng_for(self.seed, 0, 0).standard_normal((784, 10))
            y = (x @ w).argmax(-1).astype(np.int32)
            return {"image": x, "label": y}
        if self.kind == "cifar":
            x = r.random((n, 32, 32, 3), np.float32)
            y = (x.mean((1, 2)) @ _rng_for(self.seed, 0, 0)
                 .standard_normal((3, 10))).argmax(-1).astype(np.int32)
            return {"image": x, "label": y}
        if self.kind == "imagenet":
            x = r.random((n, 224, 224, 3), np.float32)
            y = r.integers(0, 1000, (n,), np.int32)
            return {"image": x, "label": y}
        if self.kind == "bert":
            ids = r.integers(0, self.vocab, (n, self.seq_len), np.int32)
            mask_pos = r.random((n, self.seq_len)) < 0.15
            labels = np.where(mask_pos, ids, -100).astype(np.int32)
            masked = np.where(mask_pos, 103, ids).astype(np.int32)  # [MASK]
            return {"input_ids": masked,
                    "segment_ids": np.zeros((n, self.seq_len), np.int32),
                    "attention_mask": np.ones((n, self.seq_len), np.int32),
                    "mlm_labels": labels}
        if self.kind == "widedeep":
            dense = r.standard_normal((n, 13)).astype(np.float32)
            sparse = r.integers(0, self.hash_buckets,
                                (n, self.num_sparse), np.int32)
            logits = dense.sum(-1) + (sparse.sum(-1) % 7 - 3) * 0.3
            y = (logits > 0).astype(np.float32)
            return {"dense": dense, "sparse": sparse, "label": y}
        # learnable structure: token t+1 = (a*token_t + b) mod V on half the
        # positions, noise on the rest — next-token CE can fall. Built
        # sequentially so the relation holds on the visible stream.
        ids = r.integers(0, self.vocab, (n, self.seq_len + 1), np.int32)
        use_det = r.random((n, self.seq_len)) < 0.5
        a, b = 3, 7
        for t in range(self.seq_len):
            det = (a * ids[:, t] + b) % self.vocab
            ids[:, t + 1] = np.where(use_det[:, t], det, ids[:, t + 1])
        return {"input_ids": ids[:, :-1].astype(np.int32),
                "labels": ids[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Batch]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
