"""Performance profiler (paper §IV-E); a copy of the reference's
``repro.serving.profiler`` (numpy only).

Periodically collects per-(model, b, m_c) execution records — throughput,
end-to-end latency, utilisation, memory — and exposes the aggregated
profile the scheduler and the interference predictor consume. This is the
component that lets BCEdge "avoid system overload and improve resource
utilization" (§IV-E): the guard asks it for observed latency quantiles and
the benchmark harness uses it to build Fig.-1-style surfaces from live
traffic instead of probe episodes.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.simulator import CompletedRound, EdgeServingEnv


@dataclasses.dataclass
class ProfileEntry:
    """Aggregated per-(model, b, m_c) execution record (paper §IV-E)."""
    count: int = 0
    total_requests: int = 0
    lat_ms: List[float] = dataclasses.field(default_factory=list)
    exec_ms: List[float] = dataclasses.field(default_factory=list)
    violations: int = 0
    overflows: int = 0
    mem_gb: List[float] = dataclasses.field(default_factory=list)

    def add(self, rnd: CompletedRound) -> None:
        self.count += 1
        self.total_requests += rnd.n_requests
        self.lat_ms.extend(rnd.latencies_ms)
        self.exec_ms.append(rnd.finish_ms - rnd.start_ms)
        self.violations += rnd.violations
        self.overflows += int(rnd.overflow)
        self.mem_gb.append(rnd.mem_used_gb)

    def summary(self) -> Dict[str, float]:
        lat = np.asarray(self.lat_ms) if self.lat_ms else np.zeros(1)
        return {
            "rounds": float(self.count),
            "requests": float(self.total_requests),
            "mean_latency_ms": float(lat.mean()),
            "p95_latency_ms": float(np.percentile(lat, 95)),
            "mean_exec_ms": float(np.mean(self.exec_ms)) if self.exec_ms
            else 0.0,
            "violation_rate": self.violations / max(self.total_requests, 1),
            "overflow_rate": self.overflows / max(self.count, 1),
            "mean_mem_gb": float(np.mean(self.mem_gb)) if self.mem_gb
            else 0.0,
        }


class PerformanceProfiler:
    """Incremental consumer of the simulator's round history — the §IV-E
    periodic performance profiler (continuous-mode sessions are ingested
    the same way, one CompletedRound per session)."""

    def __init__(self, window_rounds: int = 512):
        self.window = window_rounds
        self.table: Dict[Tuple[str, int, int], ProfileEntry] = \
            defaultdict(ProfileEntry)
        self._seen = 0
        self._recent: List[CompletedRound] = []

    # ---- collection -----------------------------------------------------
    def poll(self, env: EdgeServingEnv) -> int:
        """Ingest rounds completed since the last poll. Returns #new."""
        new = env.history[self._seen:]
        self._seen = len(env.history)
        for rnd in new:
            self.table[(rnd.model, rnd.b, rnd.m_c)].add(rnd)
            self._recent.append(rnd)
        if len(self._recent) > self.window:
            self._recent = self._recent[-self.window:]
        return len(new)

    def reset_env(self) -> None:
        """Call when the env is reset (history index restarts)."""
        self._seen = 0

    # ---- queries ---------------------------------------------------------
    def profile(self, model: str, b: int, m_c: int
                ) -> Optional[Dict[str, float]]:
        e = self.table.get((model, b, m_c))
        return e.summary() if e else None

    def best_config(self, model: str, max_violation: float = 0.1
                    ) -> Optional[Tuple[int, int]]:
        """Highest-throughput (b, m_c) whose observed violation rate is
        within budget — the profiler-informed fallback configuration."""
        best, best_thr = None, -1.0
        for (m, b, mc), e in self.table.items():
            if m != model or e.count < 3:
                continue
            s = e.summary()
            thr = s["requests"] / max(sum(e.exec_ms) / 1000.0, 1e-6)
            if s["violation_rate"] <= max_violation and thr > best_thr:
                best, best_thr = (b, mc), thr
        return best

    def utilization(self) -> Dict[str, float]:
        """Recent-window platform-level metrics (§IV-E periodic report)."""
        if not self._recent:
            return {"mem_gb_mean": 0.0, "busy_frac": 0.0}
        span = max(self._recent[-1].finish_ms
                   - self._recent[0].decision_ms, 1e-3)
        busy = sum(r.finish_ms - r.start_ms for r in self._recent)
        return {
            "mem_gb_mean": float(np.mean([r.mem_used_gb
                                          for r in self._recent])),
            "busy_frac": min(1.0, busy / span),
        }

    def fig1_surface(self, model: str) -> Dict[Tuple[int, int],
                                               Dict[str, float]]:
        """Observed throughput/latency surface for one model (live Fig. 1)."""
        return {(b, mc): e.summary()
                for (m, b, mc), e in self.table.items() if m == model}
