"""Paper Fig. 16: scheduling overhead (decision latency) per scheduler.

Paper: BCEdge's average overhead is 26%/43% lower than DeepRT/TAC. We
measure wall-clock ``act()`` per decision with the agents on ``device``:
each ``act`` reads its action back to the host, a device synchronisation
per decision. ``device="cpu"`` gives the host-CPU column. (The comparison
across schedulers is the artifact; absolute numbers are the machine's.)
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.config.base import ServingConfig
from repro_torch.figures.common import emit, train_agent
from repro_torch.serving.simulator import EdgeServingEnv


def main(device="cuda") -> dict:
    cfg = ServingConfig()
    out = {}
    for kind in ("sac", "tac", "edf"):
        agent, pred, _ = train_agent(kind, cfg, guard=(kind == "sac"),
                                     device=device)
        env = EdgeServingEnv(cfg, episode_ms=10_000.0, seed=5)
        s = env.reset()
        times = []
        done, steps = False, 0
        while not done and steps < 400:
            # deployment-path overhead: the paper trains offline and
            # deploys the policy, so the per-decision cost is act() only
            t0 = time.perf_counter()
            a = agent.act(s, greedy=True)
            times.append((time.perf_counter() - t0) * 1e3)
            s, _, done, _ = env.step(a)
            steps += 1
        # drop warm-up outliers
        arr = np.sort(np.asarray(times))[: max(1, int(0.95 * len(times)))]
        mean_ms = float(np.mean(arr))
        out[kind] = mean_ms
        emit(f"fig16.{kind}", mean_ms * 1e3, f"decision_ms={mean_ms:.3f}")
    emit("fig16.summary", 0.0,
         f"bcedge={out['sac']:.3f}ms tac={out['tac']:.3f}ms "
         f"deeprt={out['edf']:.3f}ms")
    return out


if __name__ == "__main__":
    main()
