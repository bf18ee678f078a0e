"""Paper Fig. 1: throughput/latency surface over (batch, concurrency).

Reproduces the motivational observation: both knobs matter, moderate
settings win, extremes collapse (memory overflow region included). A
``FixedScheduler`` over the exact simulator: no device work.
"""
from __future__ import annotations

from repro_torch.config.base import ServingConfig
from repro_torch.core.baselines import FixedScheduler
from repro_torch.device import resolve_device
from repro_torch.figures.common import emit, profile, timed
from repro_torch.serving.bcedge import run_episode
from repro_torch.serving.simulator import EdgeServingEnv

GRID_B = (1, 4, 16, 64, 128)
GRID_M = (1, 2, 4, 8)


def main(device="cuda") -> dict:
    resolve_device(device)
    cfg = ServingConfig()
    ep_ms = 10_000.0 if profile().fast else 30_000.0
    surface = {}
    best, worst = None, None
    for b in GRID_B:
        for mc in GRID_M:
            env = EdgeServingEnv(cfg, episode_ms=ep_ms, seed=1)
            agent = FixedScheduler(cfg.pair_to_action(b, mc))
            res, us = timed(run_episode, env, agent, learn=False)
            s = res.summary
            surface[(b, mc)] = s
            emit(f"fig1.b{b}.mc{mc}", us,
                 f"thr={s['throughput_rps']:.1f}rps "
                 f"lat={s['mean_latency_ms']:.1f}ms "
                 f"viol={s['slo_violation_rate']:.3f} "
                 f"ovf={s['overflow_rate']:.2f}")
            key = (b, mc)
            if best is None or s["mean_utility"] > surface[best][
                    "mean_utility"]:
                best = key
            if worst is None or s["mean_utility"] < surface[worst][
                    "mean_utility"]:
                worst = key
    # the paper's claim: the optimum is interior (moderate b AND m_c)
    interior = best[0] not in (GRID_B[0], GRID_B[-1]) or \
        best[1] not in (GRID_M[0], GRID_M[-1])
    emit("fig1.summary", 0.0,
         f"best=(b={best[0]},mc={best[1]}) worst=(b={worst[0]},"
         f"mc={worst[1]}) interior_optimum={interior}")
    return {"best": best, "worst": worst, "surface": surface}


if __name__ == "__main__":
    main()
