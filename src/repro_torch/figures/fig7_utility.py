"""Paper Fig. 7: normalized utility per model: BCEdge vs TAC vs DeepRT.

Paper claim: BCEdge beats DeepRT by ~37% and TAC by ~25% on average.
"""
from __future__ import annotations

from repro_torch.config.base import ServingConfig
from repro_torch.figures.common import MODELS, emit, eval_agent, train_agent


def main(device="cuda") -> dict:
    cfg = ServingConfig()
    results = {}
    per_model = {}
    for kind, guard in (("sac", True), ("tac", False), ("edf", False)):
        agent, pred, hist = train_agent(kind, cfg, guard=guard,
                                        device=device)
        env, res = eval_agent(agent, cfg, pred, guard=guard)
        results[kind] = res.summary.get("mean_utility", float("-inf"))
        per_model[kind] = res.per_model_utility
    for m in MODELS:
        row = " ".join(
            f"{k}={per_model[k].get(m, 0.0):.2f}" for k in per_model)
        emit(f"fig7.{m}", 0.0, row)
    sac, tac, edf = results["sac"], results["tac"], results["edf"]
    gain_deeprt = 100.0 * (sac - edf) / max(abs(edf), 1e-6)
    gain_tac = 100.0 * (sac - tac) / max(abs(tac), 1e-6)
    emit("fig7.summary", 0.0,
         f"bcedge={sac:.3f} tac={tac:.3f} deeprt={edf:.3f} "
         f"gain_vs_deeprt={gain_deeprt:.1f}% gain_vs_tac={gain_tac:.1f}% "
         f"(paper: +37%/+25%)")
    return {"results": results, "per_model": per_model}


if __name__ == "__main__":
    main()
