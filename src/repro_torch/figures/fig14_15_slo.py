"""Paper Figs. 14/15: SLO violation rates.

Fig. 14: BCEdge with vs without the interference predictor at 30 rps
(paper: 9.2% -> 4.1%). Fig. 15: violation rate vs request rate for
BCEdge / TAC / DeepRT (paper: BCEdge lowest everywhere, <=5% at 40 rps,
53%/25% lower than DeepRT/TAC on average)."""
from __future__ import annotations

import numpy as np

from repro_torch.config.base import ServingConfig
from repro_torch.figures.common import (emit, eval_agent, profile,
                                        train_agent)


def main(device="cuda") -> dict:
    fast = profile().fast
    out = {}

    # ---- Fig. 14: predictor ablation at 30 rps -------------------------
    cfg = ServingConfig(arrival_rps=30.0)
    for label, guard in (("with_predictor", True), ("without", False)):
        agent, pred, _ = train_agent("sac", cfg, guard=guard, device=device)
        env, res = eval_agent(agent, cfg, pred, guard=guard)
        v = res.summary.get("slo_violation_rate", 1.0)
        out[f"fig14.{label}"] = v
        emit(f"fig14.{label}", 0.0, f"violation_rate={v:.3f}")
    emit("fig14.summary", 0.0,
         f"with={out['fig14.with_predictor']:.3f} "
         f"without={out['fig14.without']:.3f} "
         f"improved={out['fig14.with_predictor'] < out['fig14.without']} "
         "(paper: 9.2%->4.1%)")

    # ---- Fig. 15: violation vs rps --------------------------------------
    rates = (10, 20, 30, 40) if not fast else (10, 30, 40)
    rows = {}
    for kind, guard in (("sac", True), ("tac", False), ("edf", False)):
        rows[kind] = []
        for rps in rates:
            cfg_r = ServingConfig(arrival_rps=float(rps))
            agent, pred, _ = train_agent(kind, cfg_r,
                                         episodes=10 if fast else 24,
                                         guard=guard, device=device)
            env, res = eval_agent(agent, cfg_r, pred, guard=guard)
            rows[kind].append(res.summary.get("slo_violation_rate", 1.0))
        emit(f"fig15.{kind}", 0.0,
             " ".join(f"rps{r}={v:.3f}" for r, v in zip(rates, rows[kind])))
    sac_avg = np.mean(rows["sac"])
    lowest = all(np.mean(rows["sac"]) <= np.mean(rows[k])
                 for k in ("tac", "edf"))
    emit("fig15.summary", 0.0,
         f"bcedge_avg={sac_avg:.3f} tac_avg={np.mean(rows['tac']):.3f} "
         f"deeprt_avg={np.mean(rows['edf']):.3f} "
         f"bcedge_lowest={lowest}")
    out["fig15"] = rows
    return out


if __name__ == "__main__":
    main()
