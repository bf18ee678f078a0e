"""Workload generators, the port of ``repro.serving.workload``: the
paper's open-loop Poisson trace (§V-A: arrivals at 30 rps, Poisson,
across the six Table-IV models), plus the non-stationary arrival traces
and the closed-loop HTTP load generator of the push-mode front-end
(docs/RUNTIME.md §11): diurnal, bursty and flash-crowd rate profiles,
mixed SLO tiers, client abandonment, and client-observed TTFT/TPOT
through the real front-end. numpy and the standard library only; the
same seed draws the same requests in the same order as the reference.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import time
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

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


# ---------------------------------------------------------------------
# non-stationary arrival traces (docs/RUNTIME.md §11)
# ---------------------------------------------------------------------
#: mixed SLO tiers for trace workloads: (slo_ms, mix weight). "tight" is
#: the tier the async serving figure's attainment assertion reads.
SLO_TIERS: Dict[str, Tuple[float, float]] = {
    "tight": (400.0, 0.25),
    "standard": (2000.0, 0.50),
    "relaxed": (8000.0, 0.25),
}


class ArrivalTrace:
    """Non-homogeneous Poisson arrivals from a rate function ``rate_fn:
    t_s -> requests/s``, sampled by thinning against the peak rate. The
    three canonical profiles are the load regimes an edge serving stack
    must survive (BCEdge §I; SLICE/EdgeServing evaluate the same
    shapes): a **diurnal** sinusoid, **bursty** on/off square waves, and
    a **flash crowd** — baseline load with a sudden many-fold spike."""

    def __init__(self, rate_fn: Callable[[float], float],
                 duration_s: float, peak_rps: float):
        self.rate_fn = rate_fn
        self.duration_s = duration_s
        self.peak_rps = peak_rps

    def arrival_times(self, seed: int = 0) -> np.ndarray:
        """Arrival offsets in [0, duration_s), by thinning: candidate
        arrivals at the peak rate, kept with probability rate(t)/peak."""
        rng = np.random.default_rng(seed)
        out: List[float] = []
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.peak_rps)
            if t >= self.duration_s:
                return np.asarray(out)
            if rng.random() < self.rate_fn(t) / self.peak_rps:
                out.append(t)

    @classmethod
    def diurnal(cls, duration_s: float, base_rps: float,
                peak_rps: float) -> "ArrivalTrace":
        """One full sinusoidal day compressed into ``duration_s``:
        trough at t=0, peak at duration/2."""
        def rate(t: float) -> float:
            phase = 2.0 * math.pi * t / duration_s
            return base_rps + (peak_rps - base_rps) \
                * 0.5 * (1.0 - math.cos(phase))
        return cls(rate, duration_s, peak_rps)

    @classmethod
    def bursty(cls, duration_s: float, base_rps: float, burst_rps: float,
               period_s: float, duty: float = 0.3) -> "ArrivalTrace":
        """Square-wave bursts: ``burst_rps`` for the first ``duty``
        fraction of every ``period_s``, ``base_rps`` otherwise."""
        def rate(t: float) -> float:
            return burst_rps if (t % period_s) < duty * period_s \
                else base_rps
        return cls(rate, duration_s, burst_rps)

    @classmethod
    def flash_crowd(cls, duration_s: float, base_rps: float,
                    flash_rps: float, flash_start_frac: float = 0.3,
                    flash_frac: float = 0.3) -> "ArrivalTrace":
        """Steady ``base_rps`` with a ``flash_rps`` spike over
        ``[start, start + flash_frac * duration)`` — the regime where
        accept-everything collapses and backpressure keeps the tight
        tier alive (benchmarks/fig_async_serving.py)."""
        t0 = flash_start_frac * duration_s
        t1 = t0 + flash_frac * duration_s

        def rate(t: float) -> float:
            return flash_rps if t0 <= t < t1 else base_rps
        return cls(rate, duration_s, flash_rps)


@dataclasses.dataclass
class TraceRequest:
    """One client of a trace workload: issue time, shape, SLO tier, and
    the abandonment deadline after which the client hangs up."""
    t_s: float                 # issue offset from trace start
    model: str
    prompt: np.ndarray
    max_new_tokens: int
    slo_ms: float
    tier: str
    #: client walks away (disconnects mid-stream) after this many
    #: seconds without completion; None = infinitely patient
    abandon_after_s: Optional[float] = None


def make_trace_requests(trace: ArrivalTrace, models: Dict[str, int],
                        seed: int = 0, prompt_len: Tuple[int, int] = (4, 24),
                        max_new: Tuple[int, int] = (4, 12),
                        tiers: Optional[Dict[str, Tuple[float, float]]]
                        = None,
                        abandon_factor: float = 4.0
                        ) -> List[TraceRequest]:
    """Materialise a trace into concrete per-client requests. ``models``
    maps model name -> vocab size (prompts are uniform token ids).
    Each request draws a tier from the ``tiers`` mix (default
    ``SLO_TIERS``) and abandons at ``abandon_factor``× its SLO — patient
    enough to outwait transient queueing, impatient enough that a
    collapsed pool sees mass disconnects."""
    tiers = tiers or SLO_TIERS
    rng = np.random.default_rng(seed)
    names = sorted(tiers)
    weights = np.asarray([tiers[n][1] for n in names])
    weights = weights / weights.sum()
    model_names = sorted(models)
    out: List[TraceRequest] = []
    for t in trace.arrival_times(seed):
        model = model_names[int(rng.integers(len(model_names)))]
        tier = names[int(rng.choice(len(names), p=weights))]
        slo_ms = tiers[tier][0]
        n_p = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        n_new = int(rng.integers(max_new[0], max_new[1] + 1))
        prompt = rng.integers(
            1, models[model], n_p).astype(np.int32)
        out.append(TraceRequest(
            float(t), model, prompt, n_new, slo_ms, tier,
            abandon_after_s=abandon_factor * slo_ms / 1000.0))
    return out


# ---------------------------------------------------------------------
# closed-loop HTTP client (docs/RUNTIME.md §11) — stdlib asyncio only
# ---------------------------------------------------------------------
@dataclasses.dataclass
class ClientOutcome:
    """Client-observed result of one streamed request: wall-clock TTFT /
    TPOT as the CLIENT saw them (connect -> first token event), and how
    the exchange ended."""
    outcome: str               # finished|rejected|throttled|abandoned|error
    tier: str = "standard"
    slo_ms: float = 0.0
    issue_s: float = 0.0       # wall clock at first connect
    ttft_s: float = -1.0       # first token event - issue
    finish_s: float = -1.0     # terminal event - issue
    n_tokens: int = 0
    retry_after_s: float = -1.0
    n_attempts: int = 1

    @property
    def tpot_s(self) -> float:
        if self.ttft_s < 0 or self.n_tokens < 2 or self.finish_s < 0:
            return -1.0
        return (self.finish_s - self.ttft_s) / (self.n_tokens - 1)

    @property
    def attained(self) -> bool:
        """Finished within the SLO, measured from the FIRST issue —
        retries after a 429 do not reset the clock."""
        return self.outcome == "finished" \
            and self.finish_s * 1000.0 <= self.slo_ms


async def _read_chunked_events(reader: asyncio.StreamReader):
    """Yield parsed ndjson events from a chunked HTTP body (the server
    writes exactly one event line per chunk)."""
    while True:
        size_line = await reader.readline()
        if not size_line:
            return
        size = int(size_line.strip() or b"0", 16)
        if size == 0:
            return
        data = await reader.readexactly(size)
        await reader.readexactly(2)  # trailing CRLF
        yield json.loads(data.decode())


async def http_generate(host: str, port: int, model: str,
                        prompt: np.ndarray, max_new_tokens: int,
                        slo_ms: float, tier: str = "standard",
                        abandon_after_s: Optional[float] = None,
                        t0: Optional[float] = None) -> ClientOutcome:
    """One closed-loop client: POST /v1/generate, stream events, record
    client-observed TTFT/TPOT. Abandons (closes the socket mid-stream —
    the server must propagate that to a cancel) when no terminal event
    arrives within ``abandon_after_s``."""
    issue = time.perf_counter() if t0 is None else t0
    out = ClientOutcome("error", tier=tier, slo_ms=slo_ms)
    body = json.dumps({
        "model": model, "prompt": [int(t) for t in prompt],
        "max_new_tokens": int(max_new_tokens),
        "slo_ms": float(slo_ms)}).encode()
    try:
        reader, writer = await asyncio.open_connection(host, port)
    except OSError:
        return out
    try:
        writer.write((
            f"POST /v1/generate HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        status_line = await reader.readline()
        status = int(status_line.split()[1])
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        if status == 429:
            out.outcome = "throttled"
            out.retry_after_s = float(headers.get("retry-after", "0.05"))
            out.finish_s = time.perf_counter() - issue
            return out
        if status != 200:
            out.finish_s = time.perf_counter() - issue
            return out

        async def consume() -> None:
            async for ev in _read_chunked_events(reader):
                now = time.perf_counter() - issue
                kind = ev.get("event")
                if kind == "token":
                    if out.ttft_s < 0:
                        out.ttft_s = now
                    out.n_tokens = max(out.n_tokens, ev["index"] + 1)
                elif kind in ("finished", "rejected", "cancelled"):
                    out.outcome = kind
                    out.finish_s = now
                    if kind == "finished":
                        out.n_tokens = len(ev.get("tokens", []))
                    return

        try:
            await asyncio.wait_for(consume(), timeout=abandon_after_s)
        except asyncio.TimeoutError:
            out.outcome = "abandoned"
            out.finish_s = time.perf_counter() - issue
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            out.finish_s = time.perf_counter() - issue
        return out
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def run_closed_loop(host: str, port: int,
                          requests: Sequence[TraceRequest],
                          time_scale: float = 1.0,
                          retry_on_429: bool = True,
                          max_retries: int = 2
                          ) -> List[ClientOutcome]:
    """Drive a materialised trace against a live server: one asyncio
    task per client, issued at ``t_s * time_scale`` offsets. Each client
    is closed-loop — it waits for its own completion (or abandons) and,
    on a 429, honours ``Retry-After`` before retrying (up to
    ``max_retries``; the abandonment clock keeps running from first
    issue, so a throttled tight-SLO client gives up rather than retry
    forever)."""
    start = time.perf_counter()

    async def one(tr: TraceRequest) -> ClientOutcome:
        await asyncio.sleep(max(0.0, tr.t_s * time_scale
                                - (time.perf_counter() - start)))
        issue = time.perf_counter()
        attempts = 0
        while True:
            budget = None if tr.abandon_after_s is None else \
                tr.abandon_after_s - (time.perf_counter() - issue)
            if budget is not None and budget <= 0:
                return ClientOutcome("abandoned", tier=tr.tier,
                                     slo_ms=tr.slo_ms, issue_s=issue,
                                     finish_s=time.perf_counter() - issue,
                                     n_attempts=attempts + 1)
            res = await http_generate(
                host, port, tr.model, tr.prompt, tr.max_new_tokens,
                tr.slo_ms, tier=tr.tier, abandon_after_s=budget, t0=issue)
            attempts += 1
            res.issue_s = issue
            res.n_attempts = attempts
            if res.outcome == "throttled" and retry_on_429 \
                    and attempts <= max_retries:
                await asyncio.sleep(max(0.01, res.retry_after_s))
                continue
            return res

    return list(await asyncio.gather(*(one(tr) for tr in requests)))


def summarize_outcomes(outcomes: Sequence[ClientOutcome]
                       ) -> Dict[str, float]:
    """Client-observed serving metrics over a closed-loop run: outcome
    counts, TTFT/TPOT percentiles (finished requests), and per-tier SLO
    attainment over ALL issued requests of that tier — throttled and
    abandoned clients count against attainment, which is exactly why
    backpressure has to EARN its 429s."""
    out: Dict[str, float] = {"n": float(len(outcomes))}
    for kind in ("finished", "rejected", "throttled", "abandoned",
                 "cancelled", "error"):
        out[f"n_{kind}"] = float(
            sum(1 for o in outcomes if o.outcome == kind))
    ttfts = [o.ttft_s * 1000.0 for o in outcomes if o.ttft_s >= 0]
    tpots = [o.tpot_s * 1000.0 for o in outcomes if o.tpot_s >= 0]
    out["ttft_ms_p50"] = float(np.percentile(ttfts, 50)) if ttfts else 0.0
    out["ttft_ms_p99"] = float(np.percentile(ttfts, 99)) if ttfts else 0.0
    out["tpot_ms_p50"] = float(np.percentile(tpots, 50)) if tpots else 0.0
    out["tpot_ms_p99"] = float(np.percentile(tpots, 99)) if tpots else 0.0
    for tier in sorted({o.tier for o in outcomes}):
        of_tier = [o for o in outcomes if o.tier == tier]
        out[f"attainment_{tier}"] = \
            sum(1 for o in of_tier if o.attained) / len(of_tier)
    return out
