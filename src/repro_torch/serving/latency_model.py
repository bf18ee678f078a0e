"""Latency and memory models of the serving stack: the port of
``repro.serving.latency_model`` (numpy and math only, so a copy).

The analytic edge-platform half (computing model, paper §III-A-3) prices
the simulator's rounds and sessions. End-to-end latency of a request
(Eq. 2)::

    t_r = t_t (transmit) + t_s (serialize) + t_w (queue) + t_m (infer) + t_o

The simulator produces t_w from actual queueing; this module models t_t,
t_s, t_m and memory. The inference term reproduces the qualitative
surface of the paper's Fig. 1: throughput rises with batch size until the
batching-efficiency curve saturates; concurrent instances first help (fill
the accelerator) then hurt via contention, super-linearly once memory
pressure passes the knee; past memory capacity the batch fails (the Fig. 1
overflow region).

The measured half holds the fits the instance pool and its scheduler
calibrate from samples the pool records itself (iteration wall ms against
overlap, against tokens processed, and KV tokens against resident
sequences, and each host-tier transfer's bytes against its ms), so
nothing in it describes a particular accelerator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

from repro_torch.configs.paper_edge_models import EdgeModelProfile
from repro_torch.serving.platforms import HardwareSpec


@dataclasses.dataclass(frozen=True)
class ExecutionEstimate:
    """One batch execution under the §III-A-3 computing model: raw
    compute time, interference inflation (docs/ARCHITECTURE.md §2), and
    the Eq.-4 memory-overflow flag."""
    compute_ms: float
    interference_factor: float
    mem_used_gb: float     # total accelerator memory in use (all instances)
    overflow: bool

    @property
    def total_ms(self) -> float:
        return self.compute_ms * self.interference_factor


def batching_efficiency(hw: HardwareSpec, b: int) -> float:
    return hw.eff_max * b / (b + hw.eff_half)


def instance_memory_gb(model: EdgeModelProfile, b: int) -> float:
    # fp16 weights + activations scale with batch; +20% runtime arena
    return 1.2 * (2.0 * model.params_m / 1024.0
                  + model.activation_mb * b / 1024.0)


def interference_factor(hw: HardwareSpec, total_instances: int,
                        mem_used_gb: float) -> float:
    """Latency inflation from co-located execution (what the NN predictor
    learns). Linear in extra instances; super-linear past the memory knee."""
    f = 1.0 + hw.contention * max(0, total_instances - 1)
    pressure = mem_used_gb / hw.mem_gb
    if pressure > hw.mem_knee:
        over = (pressure - hw.mem_knee) / max(1e-6, 1.0 - hw.mem_knee)
        f *= 1.0 + 2.5 * over ** 2 * total_instances
    return f


def estimate_execution(hw: HardwareSpec, model: EdgeModelProfile, b: int,
                       m_c: int, other_instances: int = 0,
                       other_mem_gb: float = 0.0) -> ExecutionEstimate:
    """Latency of ONE batch of size b when m_c instances of this model (and
    ``other_instances`` of other tenants) run concurrently. Each instance
    time-shares the accelerator => effective throughput divides by the
    number of co-resident instances."""
    total_inst = max(1, m_c + other_instances)
    eff = batching_efficiency(hw, b)
    # one instance only achieves eff(b) of peak (launch gaps, host pre/post);
    # n co-resident instances fill the accelerator up to saturation — this
    # is WHY concurrency helps at small batches (Fig. 1), and why it stops
    # helping once n*eff(b) >= 1 and contention takes over.
    util = min(1.0, total_inst * eff)
    gops = model.gflops * b
    compute_ms = gops * total_inst / (hw.tops * util) + hw.overhead_ms
    mem = m_c * instance_memory_gb(model, b) + other_mem_gb
    overflow = mem > hw.mem_gb
    f = interference_factor(hw, total_inst, mem)
    return ExecutionEstimate(compute_ms, f, mem, overflow)


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


def transmission_ms(hw: HardwareSpec, model: EdgeModelProfile) -> float:
    size_mb = 2.0 * math.prod(model.input_shape) / 1e6  # fp16 payload
    return hw.io_ms_per_mb * size_mb + 0.2


def serialization_ms(b: int) -> float:
    return 0.05 * b + 0.1


def peak_throughput_rps(hw: HardwareSpec, model: EdgeModelProfile,
                        b: int, m_c: int) -> float:
    est = estimate_execution(hw, model, b, m_c)
    if est.overflow:
        return 0.0
    return 1000.0 * b * m_c / (est.total_ms)


def fit_swap_cost(samples: Sequence[Tuple[int, float]]
                  ) -> Tuple[float, float]:
    """Calibrate the one-way KV swap cost from measured transfers: the
    engine records (bytes moved, ms) for every host-tier swap-out,
    swap-in, spill and revival.

    Fits ``transfer_ms ~ base + per_mb * megabytes`` by least squares and
    returns ``(base_ms, ms_per_mb)``, the per-transfer overhead and the
    inverse link bandwidth. The pool's ``_pick_preempt_mode`` compares
    ``2 * predicted_swap_ms(...)`` (out and back in) against the
    recompute prefill priced by :func:`fit_token_cost`. With fewer than
    two distinct sizes the slope cannot be identified and is 0."""
    if not samples:
        return 0.0, 0.0
    xs = [max(0.0, float(b)) / 1e6 for b, _ in samples]
    ys = [float(ms) for _, ms in samples]
    base, slope = _least_squares(xs, ys)
    slope = max(0.0, slope)
    # re-anchor the intercept to the clamped slope so the prediction
    # still passes through the sample mean
    base = max(0.0, sum(ys) / len(ys) - slope * sum(xs) / len(xs))
    return base, slope


def predicted_swap_ms(base_ms: float, ms_per_mb: float, mb: float) -> float:
    """One-way transfer time the :func:`fit_swap_cost` model predicts for
    ``mb`` megabytes of KV blocks."""
    return base_ms + ms_per_mb * max(0.0, mb)
