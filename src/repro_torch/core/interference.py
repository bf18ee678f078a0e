"""SLO-aware interference predictor (paper §IV-F, Figs. 5/13/14); the port
of ``repro.core.interference``.

A two-layer MLP predicts the end-to-end latency of a (batch, concurrency)
schedule from the currently available resources, capturing the nonlinear
latency inflation when concurrent instances contend (the paper shows a
linear-regression model has about 2x the error). Trained online from
measured iterations by minimising squared error on log latency.

Feature vector (matches Fig. 5): [mem_avail, cpu_util, accel_util,
m_c, b, model_gflops, model_mem].

The net is ``repro_torch.core.networks.MLP`` and the optimizer
``torch.optim.Adam``: the reference's ``adam`` math (bias-corrected
moments, ``eps`` added to ``sqrt(v_hat)``) with its defaults, stepped in
the reference's order (full batch, ``epochs`` steps per fit). Feature
standardisation stays in numpy, as in the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.networks import MLP
from repro_torch.device import resolve_device

N_FEATURES = 7


class NNInterferencePredictor:
    """Predicts log-latency (seconds); exp() at the boundary for stability.

    Runs on ``device`` (default ``"cuda"``, which raises without a GPU;
    pass ``device="cpu"`` to run on the CPU). Weights are drawn from
    ``seed`` with torch's generator (not the reference's values);
    :meth:`load_net` carries the reference's across."""

    name = "nn"

    def __init__(self, lr: float = 1e-3, seed: int = 0,
                 batch_size: int = 64, device="cuda"):
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.net = MLP(N_FEATURES, 1, generator=gen, device=self.device)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=lr)
        self.lr = lr
        self.batch_size = batch_size
        self.xs: list = []
        self.ys: list = []
        # running feature standardisation (Welford-ish, numpy)
        self._mu = np.zeros(N_FEATURES, np.float32)
        self._var = np.ones(N_FEATURES, np.float32)
        self._count = 0

    def load_net(self, state_dict: Dict) -> None:
        """Replace the MLP's weights (see
        ``repro_torch.models.bridge.interference_from_jax``); the
        optimizer state is left as it is."""
        self.net.load_state_dict(state_dict)

    def _norm(self, X: np.ndarray) -> np.ndarray:
        # winsorize: feature dims the training data barely varied (e.g.
        # model-specific footprints when one model dominates the
        # samples) otherwise normalise to huge values for other models,
        # and the MLP saturates at its output clip instead of falling
        # back on the dims it did learn (b, m_c, utilisation)
        z = (X - self._mu) / np.sqrt(self._var + 1e-6)
        return np.clip(z, -6.0, 6.0)

    def _update_stats(self, X: np.ndarray) -> None:
        X = np.atleast_2d(X)
        n = len(X)
        tot = self._count + n
        mu = (self._mu * self._count + X.sum(0)) / tot
        var = (self._var * self._count
               + ((X - mu) ** 2).sum(0)) / tot
        self._mu, self._var, self._count = mu.astype(np.float32), \
            np.maximum(var, 1e-6).astype(np.float32), tot

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    @torch.no_grad()
    def predict(self, feats: np.ndarray) -> float:
        x = self._norm(np.asarray(feats, np.float32))
        out = self.net(self._tensor(x))[..., 0].cpu().numpy()
        return float(np.exp(np.clip(out, -10, 6)))

    def _train(self, x: torch.Tensor, y: torch.Tensor, epochs: int) -> float:
        """``epochs`` full-batch Adam steps on the squared error of the
        predicted log latency; returns the last step's loss (taken before
        its update, as the reference's ``value_and_grad``)."""
        loss = torch.zeros(())
        for _ in range(epochs):
            loss = (self.net(x)[:, 0] - y).square().mean()
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
            self.opt.step()
        return float(loss.detach())

    def observe(self, feats: np.ndarray, latency_s: float) -> None:
        self.xs.append(np.asarray(feats, np.float32))
        self.ys.append(np.log(max(latency_s, 1e-6)))
        if len(self.xs) >= self.batch_size:
            self.fit_step()

    def fit_step(self, epochs: int = 8) -> float:
        if not self.xs:
            return 0.0
        X = np.stack(self.xs)
        self._update_stats(X)
        loss = self._train(self._tensor(self._norm(X)),
                           self._tensor(np.asarray(self.ys, np.float32)),
                           epochs)
        self.xs, self.ys = [], []
        return loss

    def fit(self, X: np.ndarray, y_latency: np.ndarray,
            epochs: int = 200) -> float:
        """Offline fit (Fig. 13 protocol: 1600 train / 400 validation)."""
        self._update_stats(np.asarray(X, np.float32))
        x = self._tensor(self._norm(np.asarray(X, np.float32)))
        y = self._tensor(np.log(np.maximum(y_latency, 1e-6)))
        return self._train(x, y, epochs)


class LinearInterferencePredictor:
    """Ridge linear regression baseline [refs 16, 46 in the paper]."""

    name = "linear"

    def __init__(self, ridge: float = 1e-3, **_):
        self.w = np.zeros(N_FEATURES + 1, np.float32)
        self.ridge = ridge
        self._X: list = []
        self._y: list = []

    def _design(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(X)
        return np.concatenate([X, np.ones((len(X), 1))], axis=1)

    def predict(self, feats: np.ndarray) -> float:
        z = float((self._design(np.asarray(feats, np.float32)) @ self.w)[0])
        return float(np.exp(np.clip(z, -10, 6)))

    def observe(self, feats: np.ndarray, latency_s: float) -> None:
        self._X.append(np.asarray(feats, np.float32))
        self._y.append(np.log(max(latency_s, 1e-6)))
        if len(self._X) % 256 == 0:
            self.fit(np.stack(self._X), np.exp(np.asarray(self._y)))

    def fit(self, X: np.ndarray, y_latency: np.ndarray, **_) -> float:
        A = self._design(X)
        y = np.log(np.maximum(y_latency, 1e-6))
        reg = self.ridge * np.eye(A.shape[1])
        self.w = np.linalg.solve(A.T @ A + reg, A.T @ y).astype(np.float32)
        resid = A @ self.w - y
        return float(np.mean(resid ** 2))


def interference_features(mem_avail_gb: float, cpu_util: float,
                          accel_util: float, m_c: int, b: int,
                          gflops: float, model_mem_gb: float) -> np.ndarray:
    return np.array([mem_avail_gb, cpu_util, accel_util, float(m_c),
                     np.log1p(float(b)), np.log1p(gflops),
                     model_mem_gb], np.float32)


def engine_features(cfg, m_c: int, b: int,
                    total_instances: int) -> np.ndarray:
    """Fig.-5 feature vector for a MEASURED engine iteration
    (docs/RUNTIME.md): the pool reads no hardware counters, so
    utilisation is proxied by live-instance counts and the per-sample
    compute/memory footprint is derived analytically from the served
    ``ModelConfig`` (2 FLOPs per active parameter per token), exactly as
    the reference does.

    ``m_c``/``b`` are the instances and active slots of the observed
    model; ``total_instances`` counts every live instance in the pool
    (other tenants included), which is what drives contention.
    """
    active_p = cfg.param_count_estimate(active_only=True)
    gflops = 2.0 * active_p / 1e9
    weights_gb = 4.0 * cfg.param_count_estimate() / 1e9  # fp32 weights
    return interference_features(
        mem_avail_gb=max(0.0, 8.0 - total_instances * weights_gb),
        cpu_util=min(1.0, 0.125 * total_instances),
        accel_util=min(1.0, 0.125 * total_instances),
        m_c=m_c, b=b, gflops=gflops,
        model_mem_gb=m_c * weights_gb)
