"""Data pipeline: deterministic synthetic token streams + file-backed corpora.

Ports ``repro.data.pipeline`` as it is: plain numpy, so a batch here equals
the reference's bit for bit (the training tests hold them equal).  The
synthetic stream is a seeded Markov-ish token process with learnable
structure (repetition + local n-gram biases) so a small model's loss
demonstrably falls during training runs — pure-noise tokens would plateau
at log(V) immediately and prove nothing.

Determinism contract: ``batch_at(step)`` is a pure function of
(seed, step, shard), so checkpoint-restart reproduces the exact data order
without persisting iterator state, and each data shard reads a disjoint
slice.  Batches are numpy arrays; the training loop moves them to its
device (``training.train_loop.batch_to``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SyntheticLM", "FileCorpus"]


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_prefix: int = 0
    d_model: int = 0          # for frontend-embed stubs
    shard: int = 0
    n_shards: int = 1

    n_templates: int = 16

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.shard)

    def _bank(self) -> np.ndarray:
        """Fixed per-seed template bank — the stable structure to learn."""
        period = max(4, min(16, self.seq_len // 4))
        return np.random.default_rng(self.seed).integers(
            0, self.vocab_size, size=(self.n_templates, period))

    def batch_at(self, step: int) -> dict:
        rng = self._rng(step)
        b = self.global_batch // self.n_shards
        V = self.vocab_size
        bank = self._bank()
        period = bank.shape[1]
        # each sequence tiles one template from the fixed bank, + 5% noise
        which = rng.integers(0, self.n_templates, size=b)
        reps = -(-self.seq_len // period)
        tokens = np.tile(bank[which], (1, reps))[:, :self.seq_len]
        noise = rng.random((b, self.seq_len)) < 0.05
        tokens = np.where(noise, rng.integers(0, V, size=tokens.shape), tokens)
        out = {"tokens": tokens.astype(np.int32)}
        if self.n_prefix and self.d_model:
            out["embeds"] = (0.02 * rng.standard_normal(
                (b, self.n_prefix, self.d_model))).astype(np.float32)
        return out


class FileCorpus:
    """Token file (np.int32 flat array) -> fixed-length training batches."""

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 shard: int = 0, n_shards: int = 1):
        self.tokens = np.load(path, mmap_mode="r")
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.shard = shard
        self.n_shards = n_shards
        self.n_windows = (len(self.tokens) - 1) // seq_len

    def batch_at(self, step: int) -> dict:
        b = self.global_batch // self.n_shards
        idx0 = (step * self.global_batch + self.shard * b) % self.n_windows
        rows = []
        for i in range(b):
            w = (idx0 + i) % self.n_windows
            rows.append(self.tokens[w * self.seq_len:(w + 1) * self.seq_len])
        return {"tokens": np.stack(rows).astype(np.int32)}
