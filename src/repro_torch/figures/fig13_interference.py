"""Paper Fig. 13: interference-predictor error CDF: NN vs linear
regression. Paper: NN predicts 90% of cases within 2.69% error and 95%
within 3.25%, about half the linear model's error."""
from __future__ import annotations

import numpy as np

from repro_torch.config.base import ServingConfig
from repro_torch.core.interference import (LinearInterferencePredictor,
                                           NNInterferencePredictor)
from repro_torch.figures.common import emit, profile
from repro_torch.serving.bcedge import collect_interference_dataset


def dataset(smoke: bool):
    """The paper's protocol: 2000 samples (200 at smoke scale), split
    80/20 into train and validation rows; returns (X, y, train, val)."""
    X, y = collect_interference_dataset(ServingConfig(),
                                        n=200 if smoke else 2000, seed=3)
    n_train = int(0.8 * len(X))
    idx = np.random.default_rng(0).permutation(len(X))
    return X, y, idx[:n_train], idx[n_train:]


def errors(predictor, X, y, tr, va, epochs: int):
    """Fit ``predictor`` on the train rows; the validation rows' median,
    p90 and p95 relative error, in percent."""
    predictor.fit(X[tr], y[tr], epochs=epochs)
    preds = np.array([predictor.predict(x) for x in X[va]])
    rel_err = np.abs(preds - y[va]) / np.maximum(np.abs(y[va]), 1e-9)
    return tuple(float(np.percentile(rel_err, q) * 100)
                 for q in (50, 90, 95))


def main(device="cuda") -> dict:
    prof = profile()
    smoke = prof.smoke
    X, y, tr, va = dataset(smoke)
    epochs = 300 if smoke else (4000 if prof.fast else 8000)
    out = {}
    for predictor in (NNInterferencePredictor(lr=3e-3, device=device),
                      LinearInterferencePredictor()):
        med, p90, p95 = errors(predictor, X, y, tr, va, epochs)
        out[predictor.name] = (med, p90, p95)
        emit(f"fig13.{predictor.name}", 0.0,
             f"median_err={med:.2f}% p90_err={p90:.2f}% p95_err={p95:.2f}%")
    ratio = out["linear"][1] / max(out["nn"][1], 1e-9)
    emit("fig13.summary", 0.0,
         f"nn_p90={out['nn'][1]:.2f}% linear_p90={out['linear'][1]:.2f}% "
         f"linear/nn={ratio:.2f}x (paper: ~2x, nn p90<=2.69%)")
    return out


if __name__ == "__main__":
    main()
