"""Operations and bytes of the paged attention kernels, from shapes.

Per layer a kernel reads the queries, the live K and V rows of each
sequence, the live columns of its block table and its length, and
writes its output; scratch that an implementation adds (split-K
partials) is not counted. Operations are QK and PV, 4 * hd per (query
head, key) pair. float32 K/V and queries, int32 tables.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from perfbench.counts.model import F32, causal_pairs


def _cols(n: int, block_size: int) -> int:
    return -(-n // block_size)


def paged_decode(cfg: Dict, contexts: Iterable[int],
                 block_size: int) -> Tuple[float, float]:
    """(operations, bytes) of one decode forward's paged attention over
    every layer: one query row a sequence, sequence b attending
    ``contexts[b]`` keys."""
    H, KV, hd, L = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                    cfg["n_layers"])
    ctx = list(contexts)
    B = len(ctx)
    keys = sum(ctx)
    nbytes = F32 * (2 * B * H * hd + 2 * keys * KV * hd + B) \
        + 4 * sum(_cols(c, block_size) for c in ctx)
    ops = 4.0 * hd * H * keys
    return L * ops, L * float(nbytes)


def paged_prefill(cfg: Dict, start: int, T: int,
                  block_size: int) -> Tuple[float, float]:
    """(operations, bytes) of one prefill piece's paged attention over
    every layer: T queries at positions start..start+T-1, each attending
    every key up to its own position."""
    H, KV, hd, L = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                    cfg["n_layers"])
    keys = start + T
    nbytes = F32 * (2 * T * H * hd + 2 * keys * KV * hd + 1) \
        + 4 * _cols(keys, block_size)
    ops = 4.0 * hd * H * causal_pairs(start, T)
    return L * ops, L * float(nbytes)
