"""Quickstart: train the BCEdge SAC scheduler in the edge simulator and
compare against DeepRT (EDF) and the best fixed Triton-style config, with
the PyTorch port. The agent and the interference predictor run on the GPU
unless ``--device cpu``.

Run:  python examples_torch/quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.config.base import ServingConfig  # noqa: E402
from repro_torch.core.baselines import EDFScheduler, FixedScheduler  # noqa: E402
from repro_torch.core.interference import NNInterferencePredictor  # noqa: E402
from repro_torch.core.sac import SACAgent, SACConfig  # noqa: E402
from repro_torch.serving.bcedge import run_episode  # noqa: E402
from repro_torch.serving.features import queue_feature_index, state_dim  # noqa: E402
from repro_torch.serving.simulator import EdgeServingEnv  # noqa: E402


def main(device="cuda"):
    cfg = ServingConfig()  # Xavier NX, 30 rps/model, paper Table IV SLOs
    models = list(EdgeServingEnv(cfg, episode_ms=1).models)
    dim = state_dim(models)

    print("== BCEdge (max-entropy SAC + interference guard), training ==")
    agent = SACAgent(dim, cfg.n_actions, SACConfig(batch_size=256, lr=5e-4),
                     device=device)
    pred = NNInterferencePredictor(device=device)
    for ep in range(6):
        env = EdgeServingEnv(cfg, episode_ms=20_000, seed=ep)
        res = run_episode(env, agent, pred, guard=True)
        s = res.summary
        print(f"  ep{ep}: utility={s['mean_utility']:.2f} "
              f"violations={s['slo_violation_rate']:.1%} "
              f"latency={s['mean_latency_ms']:.0f}ms")

    print("== Evaluation (greedy) vs baselines ==")

    class Greedy:
        def act(self, s, greedy=False):
            return agent.act(s, greedy=True)

        def observe(self, *a):
            pass

        def update(self):
            return {}

    rows = {}
    for name, sched, guard in (
            ("BCEdge", Greedy(), True),
            ("DeepRT(EDF)", EDFScheduler(cfg.batch_sizes,
                                         cfg.concurrency_levels,
                                         queue_feature_index(models)), False),
            ("Fixed(b=2,mc=2)", FixedScheduler(cfg.pair_to_action(2, 2)),
             False)):
        env = EdgeServingEnv(cfg, episode_ms=20_000, seed=99)
        res = run_episode(env, sched, pred if guard else None, guard=guard,
                          learn=False)
        rows[name] = res.summary
        s = res.summary
        print(f"  {name:16s} utility={s['mean_utility']:6.2f} "
              f"thr={s['throughput_rps']:6.1f}rps "
              f"viol={s['slo_violation_rate']:.1%} "
              f"lat={s['mean_latency_ms']:.0f}ms")
    gain = rows["BCEdge"]["mean_utility"] - rows["DeepRT(EDF)"]["mean_utility"]
    print(f"\nBCEdge utility gain vs DeepRT: {gain:+.2f} "
          f"(paper reports +37% on average)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
