"""Beyond-paper figure: REAL multi-model concurrency (utility vs m_c).

Sweeps the number of live engine instances per model on the
``ModelInstancePool`` runtime: two heterogeneous reduced models served
CONCURRENTLY on ``device``, wall-clock latencies and all. This is the
paper's Fig.-1 concurrency axis measured on real execution instead of
the analytic simulator: scaling m_c up first buys throughput (more KV
slots drain the queue), then costs latency as the instances contend
(the pool's calibrated contention model quantifies that inflation).

The models are tiny on purpose: the point is the *shape* of the
utility-vs-m_c curve under real contention, not absolute numbers.
``BENCH_FAST=0`` lengthens the per-point episodes.

Artifacts: ``experiments/figures_torch/fig_multimodel_concurrency.json``
(always) and ``.png`` beside it (when matplotlib imports).

Run:  PYTHONPATH=src python -m repro_torch.figures.fig_multimodel_concurrency
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from repro_torch.config.base import ModelConfig
from repro_torch.figures.common import (OUT_DIR, emit, profile, pyplot,
                                        write_json)
from repro_torch.serving.runtime import ModelInstancePool

MODELS = {
    "tiny-dense": ModelConfig(name="tiny-dense", family="dense",
                              n_layers=2, d_model=64, n_heads=2,
                              n_kv_heads=2, d_ff=128, vocab_size=211),
    "tiny-wide": ModelConfig(name="tiny-wide", family="dense",
                             n_layers=2, d_model=96, n_heads=2,
                             n_kv_heads=2, d_ff=192, vocab_size=193),
}
M_C_SWEEP = (1, 2, 3)
MAX_SLOTS = 2
MAX_NEW = 12
SLO_MS = 350.0
#: offered load per model: just above one instance's service capacity
#: on an idle host, so the m_c=1 point queues and scaling up has a
#: regime to escape from
RPS_PER_MODEL = 28.0


def _run_point(m_c: int, duration_s: float, rps_per_model: float,
               seed: int = 0, device="cuda") -> dict:
    """One fixed-allocation episode: every model pinned at m_c."""
    pool = ModelInstancePool(MODELS, max_instances=m_c * len(MODELS),
                             max_slots=MAX_SLOTS, max_seq=64, seed=seed,
                             device=device)
    rng = np.random.default_rng(seed)
    for m in MODELS:
        pool.scale_to(m, m_c)
    pool.warmup(seed=seed)

    next_arrival = {m: rng.exponential(1.0 / rps_per_model)
                    for m in MODELS}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < duration_s:
        now = time.perf_counter() - t0
        for m, cfg in MODELS.items():
            while next_arrival[m] <= now:
                prompt = rng.integers(1, cfg.vocab_size,
                                      rng.integers(4, 16)).astype(np.int32)
                pool.submit(m, prompt, slo_ms=SLO_MS,
                            max_new_tokens=MAX_NEW)
                next_arrival[m] += rng.exponential(1.0 / rps_per_model)
        if any(i.n_resident for i in pool.live()) \
                or any(pool.queues.values()):
            pool.step()
        else:
            time.sleep(0.001)
    # arrivals stop at the cutoff, but everything still queued/in-flight
    # is drained and COUNTED: saturated points must pay for their
    # backlog, or slo_attainment at low m_c would be inflated
    pool.run_until_drained()
    dur = time.perf_counter() - t0

    t1, c = pool.contention()
    iters = [ms for _, ms in pool.contention_samples]
    row = {"m_c": m_c, "contention_t1_ms": t1, "contention_c": c,
           "mean_iter_ms": float(np.mean(iters)) if iters else 0.0,
           "per_model": {}}
    for m in MODELS:
        served = [r for r in pool.results(m) if not r.rejected]
        lats = [r.latency_ms for r in served]
        rep = pool.report()[m]
        row["per_model"][m] = {
            "throughput_rps": len(served) / max(dur, 1e-6),
            "offered_rps": rps_per_model,
            "slo_attainment": rep["slo_attainment"],
            "mean_utility": rep["mean_utility"],
            "p50_latency_ms": float(np.percentile(lats, 50)) if lats
            else 0.0,
            "p99_latency_ms": float(np.percentile(lats, 99)) if lats
            else 0.0,
        }
    return row


def _plot(rows: list, path: str) -> bool:
    plt = pyplot()
    if plt is None:
        return False
    xs = [r["m_c"] for r in rows]
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))
    for ax, metric, title in (
            (axes[0], "mean_utility", "mean utility (Eq. 3)"),
            (axes[1], "p50_latency_ms", "p50 latency (ms)"),
            (axes[2], "slo_attainment", "SLO attainment")):
        for m in MODELS:
            ax.plot(xs, [r["per_model"][m][metric] for r in rows],
                    marker="o", label=m)
        ax.set_xlabel("m_c (live instances per model)")
        ax.set_xticks(xs)
        ax.set_title(title)
        ax.legend()
    fig.suptitle("real multi-model concurrency on the instance pool "
                 f"(slots/instance={MAX_SLOTS}, {MAX_NEW} decode iters)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(device="cuda") -> dict:
    fast = profile().fast
    duration_s = 4.0 if fast else 12.0
    rps_per_model = RPS_PER_MODEL
    rows = []
    for m_c in M_C_SWEEP:
        row = _run_point(m_c, duration_s, rps_per_model, device=device)
        rows.append(row)
        for m in MODELS:
            pm = row["per_model"][m]
            emit(f"fig_mm.mc{m_c}.{m}", 0.0,
                 f"thr={pm['throughput_rps']:.1f}rps "
                 f"p50={pm['p50_latency_ms']:.0f}ms "
                 f"slo={pm['slo_attainment']:.2f} "
                 f"u={pm['mean_utility']:.2f}")
        emit(f"fig_mm.mc{m_c}.contention", 0.0,
             f"t1={row['contention_t1_ms']:.1f}ms "
             f"c={row['contention_c']:.2f}")

    # headline: the utility-maximising m_c per model (the knob BCEdge's
    # scheduler is supposed to find)
    best = {m: max(rows, key=lambda r: r["per_model"][m]["mean_utility"])
            ["m_c"] for m in MODELS}
    emit("fig_mm.best_mc", 0.0, json.dumps(best))

    payload = {"m_c_sweep": list(M_C_SWEEP), "max_slots": MAX_SLOTS,
               "max_new_tokens": MAX_NEW, "slo_ms": SLO_MS,
               "rps_per_model": rps_per_model, "duration_s": duration_s,
               "rows": rows, "best_mc": best}
    emit("fig_mm.json", 0.0,
         write_json("fig_multimodel_concurrency", payload))
    png_path = os.path.join(OUT_DIR, "fig_multimodel_concurrency.png")
    if _plot(rows, png_path):
        emit("fig_mm.plot", 0.0, png_path)
    return payload


if __name__ == "__main__":
    main()
