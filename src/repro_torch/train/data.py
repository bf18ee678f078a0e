"""Synthetic-but-deterministic data pipeline.

For LM training we synthesise token streams from a mixture of n-gram-ish
processes so the loss actually decreases (pure uniform tokens give a flat
loss and hide bugs). The pipeline is seeded, shardable (each data-parallel
rank draws a disjoint stream), and prefetches on a background thread.

A textual copy of ``repro.train.data``: numpy only, so the port's batches
are the reference's bit for bit.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class TokenPipeline:
    """Markov-chain token stream -> (tokens, labels) batches."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0, order: int = 1, rank: int = 0,
                 world: int = 1, prefetch: int = 2):
        # order=1 keeps the context table (vocab^order) small enough that a
        # few hundred demo steps actually see each context repeatedly
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.rng = np.random.default_rng(seed * 9176 + rank)
        # sparse-ish transition preference: each context hashes to a small
        # set of likely next tokens => learnable structure.
        self._hash_a = int(self.rng.integers(1, 2**31 - 1)) | 1
        self._hash_b = int(self.rng.integers(1, 2**31 - 1))
        self.order = order
        self._stop = threading.Event()
        self._q: "queue.Queue[Dict[str, np.ndarray]]" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None

    def _next_tokens(self, ctx: np.ndarray) -> np.ndarray:
        # ctx: (batch, order) int64
        h = (ctx * self._hash_a).sum(-1) + self._hash_b
        base = (h % self.vocab).astype(np.int64)
        noise = self.rng.random(ctx.shape[0])
        rand_tok = self.rng.integers(0, self.vocab, size=ctx.shape[0])
        return np.where(noise < 0.75, base, rand_tok)

    def sample_batch(self) -> Dict[str, np.ndarray]:
        toks = np.zeros((self.batch, self.seq_len + 1), dtype=np.int32)
        toks[:, : self.order] = self.rng.integers(
            0, self.vocab, size=(self.batch, self.order))
        for t in range(self.order, self.seq_len + 1):
            toks[:, t] = self._next_tokens(
                toks[:, t - self.order: t].astype(np.int64))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # background prefetch -------------------------------------------------
    def _worker(self):
        while not self._stop.is_set():
            batch = self.sample_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self.close()

    def close(self):
        self._stop.set()
