"""Beyond-paper figure: continuous (iteration-level) vs round batching.

Runs the SAME decode-heavy workload (autoregressive requests, geometric
decode lengths) through both execution modes of the simulator and
compares goodput (SLO-met throughput), p50 latency and utility. Round
mode runs every batch to completion (the whole batch waits for its
longest sequence), while continuous mode evicts finished sequences at
iteration boundaries and admits queued ones into the freed slots, which
is where the goodput gap comes from. A ``FixedScheduler`` over the exact
simulator: no device work.

Artifacts: ``experiments/figures_torch/fig_continuous_vs_round.json``
(always) and ``.png`` beside it (when matplotlib imports).

Run:  PYTHONPATH=src python -m repro_torch.figures.fig_continuous_vs_round
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.config.base import ServingConfig
from repro_torch.core.baselines import FixedScheduler
from repro_torch.device import resolve_device
from repro_torch.figures.common import (OUT_DIR, emit, profile, pyplot,
                                        write_json)
from repro_torch.serving.bcedge import run_episode
from repro_torch.serving.simulator import EdgeServingEnv

#: decode-heavy workload: mean 6 geometric decode iterations per request
DECODE_STEPS_MEAN = 6.0
CONFIGS = ((4, 2), (8, 2))  # (b, m_c) slot/concurrency points


def _run(mode: str, b: int, m_c: int, seeds, episode_ms: float,
         rps: float) -> dict:
    keys = ("goodput_rps", "throughput_rps", "p50_latency_ms",
            "mean_latency_ms", "slo_violation_rate", "mean_utility",
            "mean_queue_wait_ms", "mean_iters")
    acc = {k: [] for k in keys}
    for seed in seeds:
        cfg = ServingConfig(arrival_rps=rps, exec_mode=mode,
                            decode_steps_mean=DECODE_STEPS_MEAN)
        env = EdgeServingEnv(cfg, episode_ms=episode_ms, seed=seed)
        sched = FixedScheduler(cfg.pair_to_action(b, m_c))
        res = run_episode(env, sched, predictor=None, guard=False,
                          learn=False)
        for k in keys:
            acc[k].append(res.summary.get(k, 0.0))
    return {k: float(np.mean(v)) for k, v in acc.items()}


def _plot(rows: dict, path: str) -> bool:
    plt = pyplot()
    if plt is None:
        return False
    labels = [f"b={b},mc={m}" for b, m in CONFIGS]
    x = np.arange(len(labels))
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    for ax, metric, title in (
            (axes[0], "goodput_rps", "goodput (SLO-met rps)"),
            (axes[1], "p50_latency_ms", "p50 latency (ms)")):
        for i, mode in enumerate(("round", "continuous")):
            vals = [rows[f"{mode}.b{b}.mc{m}"][metric] for b, m in CONFIGS]
            ax.bar(x + (i - 0.5) * 0.35, vals, width=0.35, label=mode)
        ax.set_xticks(x, labels)
        ax.set_title(title)
        ax.legend()
    fig.suptitle(f"continuous vs round, decode-heavy workload "
                 f"(mean {DECODE_STEPS_MEAN:.0f} iters/request)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(device="cuda") -> dict:
    resolve_device(device)
    fast = profile().fast
    seeds = (0, 1) if fast else (0, 1, 2, 3, 4)
    episode_ms = 10_000.0 if fast else 30_000.0
    rps = 30.0
    rows = {}
    for b, m_c in CONFIGS:
        for mode in ("round", "continuous"):
            key = f"{mode}.b{b}.mc{m_c}"
            rows[key] = _run(mode, b, m_c, seeds, episode_ms, rps)
            emit(f"fig_cont.{key}", 0.0,
                 f"goodput={rows[key]['goodput_rps']:.1f}rps "
                 f"p50={rows[key]['p50_latency_ms']:.0f}ms "
                 f"viol={rows[key]['slo_violation_rate']:.2f}")

    # headline: best config per mode
    best = {m: max((rows[f"{m}.b{b}.mc{mc}"] for b, mc in CONFIGS),
                   key=lambda r: r["goodput_rps"])
            for m in ("round", "continuous")}
    wins = best["continuous"]["goodput_rps"] >= best["round"]["goodput_rps"]
    emit("fig_cont.summary", 0.0,
         f"continuous_goodput={best['continuous']['goodput_rps']:.1f} "
         f"round_goodput={best['round']['goodput_rps']:.1f} "
         f"continuous_wins={wins}")

    payload = {
        "decode_steps_mean": DECODE_STEPS_MEAN,
        "arrival_rps": rps,
        "episode_ms": episode_ms,
        "seeds": list(seeds),
        "rows": rows,
        "best": best,
        "continuous_wins_goodput": bool(wins),
    }
    emit("fig_cont.json", 0.0, write_json("fig_continuous_vs_round", payload))
    png_path = os.path.join(OUT_DIR, "fig_continuous_vs_round.png")
    if _plot(rows, png_path):
        emit("fig_cont.plot", 0.0, png_path)
    return payload


if __name__ == "__main__":
    main()
