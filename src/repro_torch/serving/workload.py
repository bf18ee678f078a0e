"""The paper's open-loop Poisson request generator (§V-A: arrivals at 30
rps per model, Poisson, across the six Table-IV models): the port of
``repro.serving.workload.PoissonWorkload``, numpy only. The same seed
draws the same requests in the same order as the reference.

The reference module's non-stationary arrival traces and closed-loop
HTTP clients come with the HTTP front-end (ROADMAP.md, Queue A item 7).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.configs.paper_edge_models import EDGE_MODELS
from repro_torch.serving.request import Request


class PoissonWorkload:
    """Open-loop Poisson request generator (paper §V-A), optionally
    autoregressive via ``decode_steps_mean`` (docs/ARCHITECTURE.md §5)."""

    def __init__(self, rps: float = 30.0, models: Optional[Sequence[str]] = None,
                 mix: Optional[Dict[str, float]] = None, seed: int = 0,
                 decode_steps_mean: float = 1.0,
                 prefill_tokens_mean: float = 0.0,
                 shared_prefix_tokens: float = 0.0,
                 prefix_population: int = 4):
        """``rps`` is the PER-MODEL arrival rate (paper §V-A: 30 rps per
        served model); the aggregate rate is rps * len(models).

        ``decode_steps_mean`` > 1 makes the workload autoregressive: each
        request draws a geometric number of decode iterations with that
        mean, so sequences finish at different lengths — the regime
        continuous batching (docs/ARCHITECTURE.md §5) exploits.
        ``prefill_tokens_mean`` > 0 additionally gives each request a
        geometric prompt length that must be prefilled before decoding
        (the chunked-prefill regime).

        ``shared_prefix_tokens`` > 0 makes the trace *templated*
        (docs/ARCHITECTURE.md §5): each request's prompt starts with one
        of ``prefix_population`` shared prefixes of that length (drawn
        uniformly), prepended to its geometric unique tail — the
        workload regime the prefix cache exploits."""
        self.models = list(models or EDGE_MODELS.keys())
        self.rps = rps * len(self.models)
        if mix is None:
            mix = {m: 1.0 for m in self.models}
        total = sum(mix.values())
        self.probs = np.array([mix[m] / total for m in self.models])
        self.rng = np.random.default_rng(seed)
        self.decode_steps_mean = max(1.0, decode_steps_mean)
        self.prefill_tokens_mean = max(0.0, prefill_tokens_mean)
        self.shared_prefix_tokens = max(0.0, shared_prefix_tokens)
        self.prefix_population = max(1, prefix_population)
        self.now_ms = 0.0

    def _draw_decode_steps(self) -> int:
        if self.decode_steps_mean <= 1.0:
            return 1
        return int(self.rng.geometric(1.0 / self.decode_steps_mean))

    def _draw_prefill_tokens(self) -> int:
        if self.prefill_tokens_mean <= 0.0:
            return 0
        return int(self.rng.geometric(1.0 / self.prefill_tokens_mean))

    def _draw_prefix(self) -> tuple:
        """(prefix_id, prefix_tokens) of the shared template this
        request starts with; (-1, 0) for untemplated workloads."""
        if self.shared_prefix_tokens <= 0.0:
            return -1, 0
        return (int(self.rng.integers(self.prefix_population)),
                int(self.shared_prefix_tokens))

    def next_request(self) -> Request:
        gap_ms = self.rng.exponential(1000.0 / self.rps)
        self.now_ms += gap_ms
        name = self.rng.choice(self.models, p=self.probs)
        prof = EDGE_MODELS[name]
        prefix_id, prefix_tokens = self._draw_prefix()
        return Request(model=name, input_type=prof.task,
                       input_shape=prof.input_shape, slo_ms=prof.slo_ms,
                       arrival_ms=self.now_ms,
                       decode_steps=self._draw_decode_steps(),
                       prefill_tokens=prefix_tokens
                       + self._draw_prefill_tokens(),
                       prefix_id=prefix_id, prefix_tokens=prefix_tokens)

    def until(self, t_ms: float) -> Iterator[Request]:
        while True:
            r = self.next_request()
            if r.arrival_ms > t_ms:
                # rewind the clock so the pending gap is preserved
                self.now_ms = t_ms
                return
            yield r

    def burst(self, n: int) -> List[Request]:
        return [self.next_request() for _ in range(n)]
