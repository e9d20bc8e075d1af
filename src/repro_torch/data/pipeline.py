"""Deterministic, resumable token data pipeline.

`TokenStream` is *stateless-indexed*: batch(step) is a pure function of
(seed, step, shard), so a restarted job replays exactly the batches it would
have seen — checkpoint/restart is bitwise reproducible (tested), and elastic
restarts just change the shard grid.  A background prefetch thread hides
host-side batch synthesis (stands in for the storage reader of a real
deployment).  numpy only: the port's copy of the reference's
``pipeline.py``, whose batches it reproduces bit for bit.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class TokenStream:
    def __init__(
        self,
        vocab: int,
        batch: int,
        seq_len: int,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        structured: bool = True,
    ):
        assert batch % shard_count == 0
        self.vocab = vocab
        self.batch = batch
        self.local_batch = batch // shard_count
        self.seq_len = seq_len
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.structured = structured

    def _bigram_table(self) -> np.ndarray:
        """Fixed (per-seed) next-token map — the learnable structure."""
        return np.random.RandomState(self.seed).permutation(self.vocab)

    def batch_at(self, step: int) -> dict:
        """Pure function of step → {"tokens", "labels"} (local shard)."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) * 97 + self.shard_index
        )
        b, s, v = self.local_batch, self.seq_len, self.vocab
        if self.structured:
            # 80 % of transitions follow a fixed bigram map t→table[t];
            # a small model learns it within tens of steps (tested), and the
            # mapping is stable across steps/shards → resumable + learnable.
            table = self._bigram_table()
            seq = np.empty((b, s + 1), dtype=np.int64)
            seq[:, 0] = rng.randint(0, v, b)
            follow = rng.rand(b, s) < 0.8
            noise = rng.randint(0, v, (b, s))
            for t in range(s):
                seq[:, t + 1] = np.where(
                    follow[:, t], table[seq[:, t]], noise[:, t]
                )
            tokens = seq[:, :-1]
            labels = seq[:, 1:]
        else:
            tokens = rng.randint(0, v, (b, s))
            labels = rng.randint(0, v, (b, s))
        return {
            "tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32),
        }

    def prefetching(self, start_step: int, depth: int = 2):
        """Generator with a background prefetch thread."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                q.put((step, self.batch_at(step)))
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            try:
                q.get_nowait()
            except queue.Empty:
                pass
