"""Paper Fig. 10: convergence of SAC (ours) vs PPO / DDQN / GA.

Paper claim: max-entropy SAC converges 1.8x-3.7x faster. We measure
episodes-to-threshold on the episode-mean utility curve.
"""
from __future__ import annotations

import numpy as np

from repro_torch.config.base import ServingConfig
from repro_torch.figures.common import emit, profile, train_agent


def _episodes_to_reach(curve, frac=0.85):
    curve = np.asarray(curve, np.float64)
    if len(curve) == 0:
        return len(curve)
    lo = curve[0]
    hi = np.max(curve)
    if hi <= lo:
        return len(curve)
    thresh = lo + frac * (hi - lo)
    # smoothed first crossing
    smooth = np.convolve(curve, np.ones(2) / 2, mode="same")
    for i, v in enumerate(smooth):
        if v >= thresh:
            return i + 1
    return len(curve)


def main(device="cuda") -> dict:
    cfg = ServingConfig()
    prof = profile()
    eps = 2 if prof.smoke else (8 if prof.fast else 24)
    curves, losses = {}, {}
    for kind in ("sac", "ppo", "ddqn", "ga"):
        _, _, hist = train_agent(kind, cfg, episodes=eps,
                                 guard=(kind == "sac"), cache=False,
                                 device=device)
        curves[kind] = [h.get("mean_utility", 0.0) for h in hist]
        losses[kind] = [h.get("mean_loss", 0.0) for h in hist]
        emit(f"fig10.curve.{kind}", 0.0,
             "utility=[" + " ".join(f"{u:.2f}" for u in curves[kind]) + "]")
    conv = {k: _episodes_to_reach(v) for k, v in curves.items()}
    speedups = {k: conv[k] / max(conv["sac"], 1)
                for k in ("ppo", "ddqn", "ga")}
    emit("fig10.summary", 0.0,
         " ".join(f"{k}_episodes={v}" for k, v in conv.items()) + " " +
         " ".join(f"speedup_vs_{k}={v:.1f}x" for k, v in speedups.items())
         + " (paper: 1.8x-3.7x)")
    return {"conv": conv, "curves": curves}


if __name__ == "__main__":
    main()
