"""The measured latency and occupancy models the instance pool and its
scheduler calibrate and read: the part of ``repro.serving.latency_model``
they call, unchanged. Every fit here is over samples the pool records
itself (iteration wall ms against overlap, against tokens processed, and
KV tokens against resident sequences), so nothing in it describes a
particular accelerator.

The analytic edge-platform model behind the simulator (hardware specs,
batching efficiency, the Fig.-1 interference curve) and the swap-cost fit
of the host KV tier come with the simulator and the host tier (ROADMAP.md,
Queue A items 8 and 5).
"""
from __future__ import annotations

from typing import Sequence, Tuple


def _least_squares(xs: Sequence[float], ys: Sequence[float]
                   ) -> Tuple[float, float]:
    """Ordinary least squares ``y ≈ intercept + slope * x``. With fewer
    than two distinct x values the slope is unidentifiable:
    ``(mean(y), 0.0)`` is returned."""
    n = len(xs)
    if len(set(xs)) < 2:
        return sum(ys) / n, 0.0
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    slope = sxy / sxx
    return my - slope * mx, slope


def fit_contention(samples: Sequence[Tuple[int, float]]
                   ) -> Tuple[float, float]:
    """Calibrate the linear part of :func:`interference_factor` from
    MEASURED per-iteration latencies (docs/RUNTIME.md: the multi-model
    runtime records (total live instances, iteration wall latency) pairs
    while instances overlap).

    Fits ``iter_ms ≈ t1 * (1 + c * (n - 1))`` by least squares and returns
    ``(t1_ms, c)`` — the single-instance iteration latency and the
    per-extra-instance slowdown coefficient (the measured counterpart of
    ``HardwareSpec.contention``). With fewer than two distinct overlap
    levels the slope is unidentifiable and ``c = 0.0`` is returned.
    """
    if not samples:
        return 0.0, 0.0
    xs = [float(max(1, n) - 1) for n, _ in samples]
    ys = [float(t) for _, t in samples]
    t1, slope = _least_squares(xs, ys)
    if t1 <= 1e-9:  # degenerate fit: fall back to the overlap-1 mean
        base = [y for x, y in zip(xs, ys) if x == min(xs)]
        t1 = sum(base) / len(base)
    return t1, max(0.0, slope / max(t1, 1e-9))


def predicted_iter_ms(t1_ms: float, contention: float, n_instances: int
                      ) -> float:
    """Iteration latency the :func:`fit_contention` model predicts when
    ``n_instances`` engine instances are live on the host."""
    return t1_ms * (1.0 + contention * max(0, n_instances - 1))


def fit_token_cost(samples: Sequence[Tuple[int, float]]
                   ) -> Tuple[float, float]:
    """Calibrate per-iteration cost as a function of the tokens the
    iteration actually processed (docs/RUNTIME.md §8: the pool records
    (prefill-chunk + decode tokens, iteration wall ms) pairs, excluding
    compile iterations).

    Fits ``iter_ms ≈ base + per_token * tokens`` by least squares and
    returns ``(base_ms, per_token_ms)``. This is what makes the
    per-iteration token budget a schedulable knob: the guard can price a
    proposed budget directly instead of assuming iteration cost is
    independent of prefill work. With fewer than two distinct token
    counts the slope is unidentifiable and ``per_token_ms = 0.0``.
    """
    if not samples:
        return 0.0, 0.0
    xs = [float(max(0, t)) for t, _ in samples]
    ys = [float(ms) for _, ms in samples]
    base, slope = _least_squares(xs, ys)
    slope = max(0.0, slope)
    # re-anchor the intercept to the clamped slope so the prediction
    # still passes through the sample mean
    base = max(0.0, sum(ys) / len(ys) - slope * sum(xs) / len(xs))
    return base, slope


def predicted_token_iter_ms(base_ms: float, per_token_ms: float,
                            tokens: int) -> float:
    """Iteration latency the :func:`fit_token_cost` model predicts for an
    iteration processing ``tokens`` (decode + prefill-chunk) tokens."""
    return base_ms + per_token_ms * max(0, tokens)


def fit_occupancy(samples: Sequence[Tuple[int, float]]) -> float:
    """Calibrate mean KV tokens per resident sequence from MEASURED
    occupancy (docs/RUNTIME.md: the pool records
    (total resident sequences, Σ engine ``kv_used_tokens``) pairs every
    pure-decode iteration).

    Through-origin least squares — zero resident sequences must use zero
    tokens. This replaces :func:`instance_memory_gb`'s analytic
    activation curve as the memory term the ``PoolScheduler`` guard uses
    once a paged pool reports real occupancy: a proposed (b, m_c) is
    memory-feasible iff ``b * m_c * fit_occupancy(...)`` (plus the other
    tenants' measured usage) fits the shared block budget.
    """
    num = sum(float(n) * float(t) for n, t in samples)
    den = sum(float(n) * float(n) for n, _ in samples)
    return num / den if den > 0.0 else 0.0


def predicted_kv_tokens(tokens_per_seq: float, n_seqs: int) -> float:
    """KV tokens the :func:`fit_occupancy` model predicts for ``n_seqs``
    concurrently resident sequences."""
    return tokens_per_seq * max(0, n_seqs)
