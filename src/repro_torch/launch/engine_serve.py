"""Real-engine serving driver (importable entry point for
``python -m repro_torch.launch.serve --engine``): the port of
``repro.launch.engine_serve``'s ``serve_round`` and ``serve_continuous``.

Requests with random token prompts arrive Poisson; latencies are
wall-clock and utilities are computed from them (Eq. 3).

* ``round`` — the SAC scheduler picks the batch size per round and the
  ``InferenceEngine`` runs each round to completion (paper §IV-D);
* ``continuous`` — arrivals are submitted into the
  ``ContinuousBatchingEngine`` as they land and join the running batch
  at iteration boundaries (dense or paged KV layout).

The multi-model pool and HTTP serving are still to port (ROADMAP.md).

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --engine
      PYTHONPATH=src python -m repro_torch.launch.serve --engine \
          --exec-mode continuous --kv-layout dense
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from repro_torch.config import get_reduced_config
from repro_torch.config.base import ModelConfig, ServingConfig
from repro_torch.core.sac import SACAgent, SACConfig
from repro_torch.core.utility import utility
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        InferenceEngine)


def _report(served: int, violations: int, rounds: int, lat_sum: float,
            dur: float, slo_ms: float, label: str) -> None:
    print(f"[{label}] served {served} requests in {dur:.1f}s "
          f"({served/max(dur,1e-6):.1f} rps) over {rounds} rounds/iters")
    print(f"[{label}] mean latency {lat_sum/max(served,1):.0f}ms, "
          f"violations {violations/max(served,1):.1%} (SLO {slo_ms:.0f}ms)")


def serve_round(arch: str = "qwen3-0.6b", duration_s: float = 20.0,
                rps: float = 12.0, slo_ms: float = 1500.0,
                cfg: Optional[ModelConfig] = None,
                device="cuda") -> Dict[str, float]:
    """Round mode: the SAC agent picks b per round from the queue state,
    the engine runs the round to completion, and the round's utility is
    the agent's reward; the agent's first update comes once its replay
    holds a mini-batch of 32 rounds. ``cfg`` overrides the reduced
    registry config of ``arch`` (for example with the full-width one).
    Runs on ``device`` (default ``"cuda"``, which raises without a GPU).
    Returns served/violations/rounds, the number of SAC updates and the
    mean host milliseconds of ``act`` per round and of an ``update``."""
    cfg = cfg if cfg is not None else get_reduced_config(arch)
    print(f"loading {cfg.name} (d={cfg.d_model}, L={cfg.n_layers}), round "
          f"mode, on {device}...")
    engine = InferenceEngine(cfg, max_seq=128, device=device)
    # first-use costs: cuBLAS handles, kernel builds
    engine.generate([np.arange(8, dtype=np.int32)], max_new_tokens=2)

    scfg = ServingConfig(batch_sizes=(1, 2, 4, 8), concurrency_levels=(1,))
    agent = SACAgent(4, scfg.n_actions,
                     SACConfig(batch_size=32, lr=1e-3), seed=0,
                     device=device)
    rng = np.random.default_rng(0)

    queue = []
    t0 = time.perf_counter()
    next_arrival = rng.exponential(1.0 / rps)
    served = violations = rounds = n_updates = 0
    lat_sum = act_s = update_s = 0.0
    while time.perf_counter() - t0 < duration_s:
        now = time.perf_counter() - t0
        while next_arrival <= now:
            queue.append((next_arrival,
                          rng.integers(1, cfg.vocab_size,
                                       rng.integers(4, 24)).astype(np.int32)))
            next_arrival += rng.exponential(1.0 / rps)
        if not queue:
            time.sleep(0.002)
            continue
        oldest_age = now - queue[0][0]
        state = np.array([np.log1p(len(queue)), oldest_age,
                          np.log1p(served), 1.0], np.float32)
        ta = time.perf_counter()
        a = agent.act(state)
        act_s += time.perf_counter() - ta
        b, _ = scfg.action_to_pair(a)
        batch = queue[:b]
        queue = queue[b:]
        res = engine.generate([p for _, p in batch], max_new_tokens=4)
        done_t = time.perf_counter() - t0
        lats = [(done_t - arr) * 1000.0 for arr, _ in batch]
        viol = sum(1 for lat in lats if lat > slo_ms)
        served += len(batch)
        violations += viol
        lat_sum += sum(lats)
        rounds += 1
        u = utility(len(batch) / max(res.total_ms / 1000, 1e-3),
                    np.mean(lats) / 1000.0,
                    slo_ms / 1000.0 * len(batch), 1) - 2.0 * viol / len(batch)
        s2 = np.array([np.log1p(len(queue)), 0.0, np.log1p(served), 1.0],
                      np.float32)
        agent.observe(state, a, u, s2, False)
        tu = time.perf_counter()
        if agent.update():
            n_updates += 1
            update_s += time.perf_counter() - tu
    _report(served, violations, rounds, lat_sum,
            time.perf_counter() - t0, slo_ms, "round")
    stats = {"served": float(served), "violations": float(violations),
             "rounds": float(rounds), "sac_updates": float(n_updates),
             "sac_act_ms": act_s * 1e3 / max(rounds, 1),
             "sac_update_ms": update_s * 1e3 / max(n_updates, 1)}
    print(f"[round] stats: {stats}")
    return stats


def serve_continuous(arch: str = "qwen3-0.6b", duration_s: float = 20.0,
                     rps: float = 12.0, slo_ms: float = 1500.0,
                     max_slots: int = 4, kv_layout: str = "dense",
                     kv_block_budget: Optional[int] = None,
                     token_budget: Optional[int] = None,
                     cfg: Optional[ModelConfig] = None,
                     device="cuda") -> Dict[str, float]:
    """Continuous mode: arrivals are submitted into the slot engine as
    they land and join the running batch at iteration boundaries.
    ``kv_layout`` is ``"dense"`` (as the reference's default) or
    ``"paged"``; ``kv_block_budget`` caps the paged engine's block pool
    (default: the dense-equivalent worst case); ``token_budget`` caps
    per-iteration prefill+decode tokens. ``cfg`` overrides the reduced
    registry config of ``arch`` (for example with the full-width one).
    Runs on ``device`` (default ``"cuda"``, which raises without a GPU).
    Returns the engine's ``stats()`` plus ``served`` and ``violations``."""
    cfg = cfg if cfg is not None else get_reduced_config(arch)
    print(f"loading {cfg.name} (d={cfg.d_model}, L={cfg.n_layers}), "
          f"{max_slots} slots, {kv_layout} KV, "
          f"token budget {token_budget or 'uncapped'}, on {device}...")
    engine = ContinuousBatchingEngine(cfg, max_slots=max_slots, max_seq=128,
                                      kv_layout=kv_layout,
                                      kv_blocks=kv_block_budget,
                                      token_budget=token_budget,
                                      device=device)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    next_arrival = rng.exponential(1.0 / rps)
    submit_t = {}
    served = violations = 0
    lat_sum = 0.0
    while time.perf_counter() - t0 < duration_s:
        now = time.perf_counter() - t0
        while next_arrival <= now:
            prompt = rng.integers(1, cfg.vocab_size,
                                  rng.integers(4, 24)).astype(np.int32)
            rid = engine.submit(prompt, max_new_tokens=4)
            submit_t[rid] = next_arrival
            next_arrival += rng.exponential(1.0 / rps)
        if not engine.active_slots and not engine.waiting:
            time.sleep(0.002)
            continue
        for r in engine.step():
            done_t = time.perf_counter() - t0
            lat = (done_t - submit_t.pop(r.request_id, done_t)) * 1000.0
            served += 1
            lat_sum += lat
            violations += int(lat > slo_ms)
    _report(served, violations, engine.n_iters, lat_sum,
            time.perf_counter() - t0, slo_ms, "continuous")
    stats = engine.stats()
    print(f"[continuous] engine stats: {stats}")
    return {**stats, "served": float(served),
            "violations": float(violations)}


def main(exec_mode: str = "round", arch: str = "qwen3-0.6b",
         duration_s: float = 20.0, rps: float = 12.0,
         slo_ms: float = 1500.0, kv_layout: str = "dense",
         kv_block_budget: Optional[int] = None,
         token_budget: Optional[int] = None, device="cuda") -> None:
    if exec_mode == "continuous":
        serve_continuous(arch, duration_s, rps, slo_ms, kv_layout=kv_layout,
                         kv_block_budget=kv_block_budget,
                         token_budget=token_budget, device=device)
        return
    if kv_layout != "dense":
        print("round mode always uses the dense per-round cache; "
              "--kv-layout applies to continuous serving")
    if token_budget or kv_block_budget:
        print("--token-budget / --kv-block-budget are continuous-engine "
              "features; ignored in round mode")
    serve_round(arch, duration_s, rps, slo_ms, device=device)
