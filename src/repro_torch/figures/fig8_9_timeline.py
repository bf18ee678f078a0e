"""Paper Figs. 8/9: per-model throughput + latency over the scheduling
run, starting untrained (paper: 3000 s, saturating ~1500 s once the
scheduler finds the per-model sweet spots).

Rendered from the online-training trajectory of the shared BCEdge agent
(each episode = one timeline segment). Signature behaviour checked:
utility rises / violations fall from the first third to the last third."""
from __future__ import annotations

import numpy as np

from repro_torch.config.base import ServingConfig
from repro_torch.figures.common import MODELS, emit, train_agent


def main(device="cuda") -> dict:
    cfg = ServingConfig()
    # shared with fig7/14/16
    agent, pred, hist = train_agent("sac", cfg, device=device)
    n = len(hist)
    thr = {m: [h["per_model_throughput"].get(m, 0.0) for h in hist]
           for m in MODELS}
    lat = {m: [h["per_model_latency"].get(m, 0.0) for h in hist]
           for m in MODELS}
    for m in MODELS:
        emit(f"fig8.thr.{m}", 0.0,
             "rps_per_episode=[" + " ".join(f"{v:.1f}" for v in thr[m]) + "]")
        emit(f"fig9.lat.{m}", 0.0,
             "ms_per_episode=[" + " ".join(f"{v:.0f}" for v in lat[m]) + "]")
    utils = [h.get("mean_utility", 0.0) for h in hist]
    viols = [h.get("slo_violation_rate", 1.0) for h in hist]
    third = max(1, n // 3)
    early_u, late_u = np.mean(utils[:third]), np.mean(utils[-third:])
    early_v, late_v = np.mean(viols[:third]), np.mean(viols[-third:])
    emit("fig8_9.summary", 0.0,
         f"util_early={early_u:.2f} util_late={late_u:.2f} "
         f"viol_early={early_v:.3f} viol_late={late_v:.3f} "
         f"improving={late_u >= early_u or late_v <= early_v}")
    return {"thr": thr, "utils": utils}


if __name__ == "__main__":
    main()
