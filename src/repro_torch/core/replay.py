"""Uniform replay buffer (numpy ring), paper buffer size 1e6; a copy of
the reference's ``repro.core.replay`` (numpy only), so the same seed gives
the same ``sample()`` draws.

Storage is allocated lazily in geometrically-growing chunks: arrays start
at ``INITIAL_ROWS`` and double (capped at ``capacity``) as transitions
arrive. Once ``capacity`` rows have been written the write index wraps
and old transitions are overwritten in order.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class ReplayBuffer:
    INITIAL_ROWS = 1024

    def __init__(self, state_dim: int, capacity: int = 1_000_000,
                 seed: int = 0):
        self.capacity = capacity
        self.state_dim = state_dim
        rows = min(capacity, self.INITIAL_ROWS)
        self.s = np.zeros((rows, state_dim), np.float32)
        self.a = np.zeros((rows,), np.int32)
        self.r = np.zeros((rows,), np.float32)
        self.s2 = np.zeros((rows, state_dim), np.float32)
        self.done = np.zeros((rows,), np.float32)
        self.idx = 0
        self.full = False
        self.rng = np.random.default_rng(seed)

    @property
    def allocated_rows(self) -> int:
        return self.s.shape[0]

    def _grow(self) -> None:
        """Double the backing arrays (capped at ``capacity``)."""
        rows = min(self.capacity, max(1, 2 * self.allocated_rows))
        extra = rows - self.allocated_rows
        if extra <= 0:
            return
        for name in ("s", "a", "r", "s2", "done"):
            arr = getattr(self, name)
            pad = np.zeros((extra,) + arr.shape[1:], arr.dtype)
            setattr(self, name, np.concatenate([arr, pad]))

    def __len__(self) -> int:
        return self.capacity if self.full else self.idx

    def add(self, s, a, r, s2, done) -> None:
        i = self.idx
        if i >= self.allocated_rows:
            self._grow()
        self.s[i] = s
        self.a[i] = a
        self.r[i] = r
        self.s2[i] = s2
        self.done[i] = float(done)
        self.idx = (i + 1) % self.capacity
        self.full = self.full or self.idx == 0

    def sample(self, batch: int) -> Dict[str, np.ndarray]:
        n = len(self)
        idx = self.rng.integers(0, n, size=batch)
        return {"s": self.s[idx], "a": self.a[idx], "r": self.r[idx],
                "s2": self.s2[idx], "done": self.done[idx]}
