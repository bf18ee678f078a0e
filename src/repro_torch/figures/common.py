"""Shared figure utilities: the run profile, agent training with a cache,
greedy evaluation, CSV rows and the JSON artifacts; the port of the
reference's ``benchmarks/common.py``.

The profile is read from the environment when a figure's ``main`` runs
(:func:`profile`), never at import: ``BENCH_SMOKE=1`` runs every code
path at toy scale (numbers NOT meaningful), ``BENCH_FAST=0`` the full
length, anything else the fast profile. Agents and predictors are built
on an explicit ``device``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.config.base import ServingConfig
from repro_torch.configs.paper_edge_models import EDGE_MODELS
from repro_torch.core.baselines import (DDQNAgent, EDFScheduler,
                                        FixedScheduler, GAScheduler,
                                        PPOAgent, TACAgent)
from repro_torch.core.interference import NNInterferencePredictor
from repro_torch.core.sac import SACAgent, SACConfig
from repro_torch.serving.bcedge import run_episode
from repro_torch.serving.features import queue_feature_index, state_dim
from repro_torch.serving.simulator import EdgeServingEnv

MODELS = list(EDGE_MODELS.keys())
STATE_DIM = state_dim(MODELS)

#: where the figures write their JSON (and PNG) artifacts, under the
#: working directory
OUT_DIR = os.path.join("experiments", "figures_torch")


class Profile(NamedTuple):
    """One run's scale: ``smoke`` (toy scale, the rot check), ``fast``
    (the default), else full length; episode length and training
    episodes follow."""
    smoke: bool
    fast: bool
    ep_ms: float
    train_eps: int


def profile() -> Profile:
    """The profile the environment selects now (``BENCH_SMOKE``,
    ``BENCH_FAST``), with the reference's values."""
    smoke = os.environ.get("BENCH_SMOKE", "0") == "1"
    fast = smoke or os.environ.get("BENCH_FAST", "1") != "0"
    return Profile(smoke, fast,
                   2_000.0 if smoke else (20_000.0 if fast else 60_000.0),
                   2 if smoke else (16 if fast else 36))


#: trained-agent cache: figures sharing a (kind, platform, rps, guard)
#: configuration reuse one training run (the paper trains once offline
#: and deploys, §V-A)
_AGENT_CACHE: Dict[tuple, tuple] = {}


def make_agent(kind: str, cfg: ServingConfig, seed: int = 0,
               device="cuda"):
    """A fresh scheduler of ``kind`` with the reference's
    hyperparameters; the learning agents live on ``device``."""
    n = cfg.n_actions
    if kind == "sac":
        return SACAgent(STATE_DIM, n, SACConfig(batch_size=256, lr=5e-4),
                        seed=seed, device=device)
    if kind == "tac":
        return TACAgent(STATE_DIM, n, batch_size=256, seed=seed,
                        device=device)
    if kind == "ppo":
        return PPOAgent(STATE_DIM, n, seed=seed, device=device)
    if kind == "ddqn":
        return DDQNAgent(STATE_DIM, n, batch_size=256, seed=seed,
                         device=device)
    if kind == "ga":
        return GAScheduler(STATE_DIM, n, seed=seed)
    if kind == "edf":
        return EDFScheduler(cfg.batch_sizes, cfg.concurrency_levels,
                            queue_feature_index(MODELS),
                            n_models=len(MODELS),
                            arrival_rps=cfg.arrival_rps,
                            platform=cfg.platform)
    if kind == "fixed":
        return FixedScheduler(cfg.pair_to_action(2, 2))
    raise KeyError(kind)


class GreedyWrapper:
    """Frozen greedy policy view of a trained agent."""

    def __init__(self, agent):
        self.agent = agent
        self.name = agent.name

    def act(self, s, greedy=False):
        return self.agent.act(s, greedy=True)

    def observe(self, *a):
        pass

    def update(self):
        return {}


def train_agent(kind: str, cfg: ServingConfig,
                episodes: Optional[int] = None, seed: int = 0,
                guard: bool = True,
                predictor: Optional[NNInterferencePredictor] = None,
                cache: bool = True, device="cuda"):
    """Online training over ``episodes`` episodes (the profile's
    ``train_eps`` by default); returns (agent, predictor, history).
    Non-learning schedulers skip training (one probe episode for the
    history). Results are cached by the reference's key (kind, platform,
    rps, guard, episodes, seed) plus the episode length and the device,
    so a smoke run never hands a fast one its agents and an agent trained
    on the GPU never stands in for one on the CPU.
    """
    prof = profile()
    if episodes is None:
        episodes = prof.train_eps
    key = (kind, cfg.platform, cfg.arrival_rps, guard, episodes, seed,
           prof.ep_ms, str(device))
    if cache and key in _AGENT_CACHE:
        return _AGENT_CACHE[key]
    agent = make_agent(kind, cfg, seed, device)
    history: List[Dict] = []
    pred = predictor
    if pred is None and guard:
        pred = NNInterferencePredictor(seed=seed, device=device)
    learns = getattr(agent, "learns", False)
    for ep in range(episodes if learns else 1):
        env = EdgeServingEnv(cfg, episode_ms=prof.ep_ms,
                             seed=seed * 100 + ep)
        res = run_episode(env, agent, pred, guard=guard, learn=learns)
        row = dict(res.summary)
        row["episode"] = ep
        row["mean_loss"] = float(np.mean(res.losses)) if res.losses else 0.0
        row["per_model_throughput"] = dict(res.per_model_throughput)
        row["per_model_latency"] = dict(res.per_model_latency)
        history.append(row)
    out = (agent, pred, history)
    if cache:
        _AGENT_CACHE[key] = out
    return out


def eval_agent(agent, cfg: ServingConfig, predictor=None, guard=True,
               seed: int = 999, episode_ms: Optional[float] = None,
               n_seeds: int = 3):
    """Greedy evaluation averaged over ``n_seeds`` episodes of
    ``episode_ms`` (the profile's by default; single-episode serving
    metrics are high-variance). Returns (last_env, result) where
    result.summary holds seed-averaged metrics and the per-model maps come
    from the pooled episodes."""
    if episode_ms is None:
        episode_ms = profile().ep_ms
    envs, results = [], []
    for i in range(n_seeds):
        env = EdgeServingEnv(cfg, episode_ms=episode_ms, seed=seed + i)
        res = run_episode(env, GreedyWrapper(agent), predictor, guard=guard,
                          learn=False)
        envs.append(env)
        results.append(res)
    keys = set().union(*(r.summary.keys() for r in results))
    avg = {k: float(np.mean([r.summary.get(k, 0.0) for r in results]))
           for k in keys}
    pooled_u, pooled_thr, pooled_lat = {}, {}, {}
    for r in results:
        for m, v in r.per_model_utility.items():
            pooled_u.setdefault(m, []).append(v)
        for m, v in r.per_model_throughput.items():
            pooled_thr[m] = pooled_thr.get(m, 0.0) + v / n_seeds
        for m, v in r.per_model_latency.items():
            pooled_lat.setdefault(m, []).append(v)
    out = results[-1]
    out.summary = avg
    out.per_model_utility = {m: float(np.mean(v))
                             for m, v in pooled_u.items()}
    out.per_model_throughput = pooled_thr
    out.per_model_latency = {m: float(np.mean(v))
                             for m, v in pooled_lat.items()}
    return envs[-1], out


def check(ok: bool, msg: str) -> None:
    """A figure's own assertion: raises ``AssertionError`` with ``msg``
    when ``ok`` is false (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise AssertionError(msg)


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.2f},{derived}", flush=True)


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, (time.perf_counter() - t0) * 1e6


def write_json(name: str, payload: dict) -> str:
    """Write ``payload`` to ``OUT_DIR/<name>.json``; returns the path."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return path


def pyplot():
    """matplotlib's ``pyplot`` on the Agg backend, or None where it does
    not import (a PNG is optional)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt
