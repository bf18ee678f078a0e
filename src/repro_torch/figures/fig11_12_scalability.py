"""Paper Figs. 11/12: scalability across heterogeneous edge platforms
(Jetson Nano / TX2 / Xavier NX): utility, peak throughput, mean latency
for BCEdge vs TAC vs DeepRT. Paper: BCEdge wins on all three platforms;
more compute => higher utility (+30%/+19% on Nano, +39%/+27% on TX2)."""
from __future__ import annotations

from repro_torch.config.base import ServingConfig
from repro_torch.figures.common import emit, eval_agent, train_agent

PLATFORMS = ("jetson_nano", "jetson_tx2", "xavier_nx")


def main(device="cuda") -> dict:
    out = {}
    for platform in PLATFORMS:
        cfg = ServingConfig(platform=platform)
        row = {}
        for kind, guard in (("sac", True), ("tac", False), ("edf", False)):
            agent, pred, _ = train_agent(kind, cfg, guard=guard,
                                         device=device)
            env, res = eval_agent(agent, cfg, pred, guard=guard)
            s = res.summary
            row[kind] = s
            emit(f"fig11_12.{platform}.{kind}", 0.0,
                 f"util={s.get('mean_utility', 0):.2f} "
                 f"thr={s.get('throughput_rps', 0):.1f}rps "
                 f"lat={s.get('mean_latency_ms', 0):.0f}ms "
                 f"viol={s.get('slo_violation_rate', 0):.3f}")
        out[platform] = row
        sac_u = row["sac"].get("mean_utility", 0)
        edf_u = row["edf"].get("mean_utility", 1e-9)
        tac_u = row["tac"].get("mean_utility", 1e-9)
        emit(f"fig11_12.{platform}.summary", 0.0,
             f"gain_vs_deeprt={100*(sac_u-edf_u)/abs(edf_u):.0f}% "
             f"gain_vs_tac={100*(sac_u-tac_u)/abs(tac_u):.0f}%")
    # ordering check: richer platform => higher BCEdge utility
    order = [out[p]["sac"].get("mean_utility", 0) for p in PLATFORMS]
    emit("fig11_12.ordering", 0.0,
         f"nano={order[0]:.2f} tx2={order[1]:.2f} nx={order[2]:.2f} "
         f"monotone={order[0] <= order[1] <= order[2]}")
    return out


if __name__ == "__main__":
    main()
