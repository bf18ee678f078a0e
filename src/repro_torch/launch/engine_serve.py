"""Real-engine serving driver (importable entry point for
``python -m repro_torch.launch.serve --engine``): the port of
``repro.launch.engine_serve.serve_continuous``.

Requests with random token prompts arrive Poisson, are submitted into
the paged ``ContinuousBatchingEngine`` as they land and join the running
batch at iteration boundaries; latencies are wall-clock. Round mode,
the multi-model pool and HTTP serving are still to port (ROADMAP.md).

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --engine \
          --exec-mode continuous --kv-layout paged
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from repro_torch.config import get_reduced_config
from repro_torch.config.base import ModelConfig
from repro_torch.serving.engine import ContinuousBatchingEngine


def _report(served: int, violations: int, rounds: int, lat_sum: float,
            dur: float, slo_ms: float, label: str) -> None:
    print(f"[{label}] served {served} requests in {dur:.1f}s "
          f"({served/max(dur,1e-6):.1f} rps) over {rounds} rounds/iters")
    print(f"[{label}] mean latency {lat_sum/max(served,1):.0f}ms, "
          f"violations {violations/max(served,1):.1%} (SLO {slo_ms:.0f}ms)")


def serve_continuous(arch: str = "qwen3-0.6b", duration_s: float = 20.0,
                     rps: float = 12.0, slo_ms: float = 1500.0,
                     max_slots: int = 4, kv_layout: str = "paged",
                     kv_block_budget: Optional[int] = None,
                     token_budget: Optional[int] = None,
                     cfg: Optional[ModelConfig] = None,
                     device="cuda") -> Dict[str, float]:
    """Continuous mode: arrivals are submitted into the slot engine as
    they land and join the running batch at iteration boundaries.
    ``kv_block_budget`` caps the engine's block pool (default: the
    dense-equivalent worst case); ``token_budget`` caps per-iteration
    prefill+decode tokens. ``cfg`` overrides the reduced registry config
    of ``arch`` (for example with the full-width one). Runs on ``device``
    (default ``"cuda"``, which raises without a GPU). Returns the
    engine's ``stats()`` plus ``served`` and ``violations``."""
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


def main(exec_mode: str = "continuous", arch: str = "qwen3-0.6b",
         duration_s: float = 20.0, rps: float = 12.0,
         slo_ms: float = 1500.0, kv_layout: str = "paged",
         kv_block_budget: Optional[int] = None,
         token_budget: Optional[int] = None, device="cuda") -> None:
    if exec_mode != "continuous":
        raise NotImplementedError(
            f"exec mode {exec_mode!r} is not ported yet (ROADMAP.md, Queue "
            "A item 4); the port serves --exec-mode continuous")
    serve_continuous(arch, duration_s, rps, slo_ms, kv_layout=kv_layout,
                     kv_block_budget=kv_block_budget,
                     token_budget=token_budget, device=device)
