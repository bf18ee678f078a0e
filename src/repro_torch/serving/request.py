"""Request model, the simulator's SLO-priority queue, and the per-request
lifecycle state machine the pool pushes events through: the port of
``repro.serving.request`` (``Request``, ``RequestQueue`` and
``RequestLifecycle``, docs/RUNTIME.md §11), unchanged.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional

_counter = itertools.count()


# ---------------------------------------------------------------------
# request lifecycle state machine (docs/RUNTIME.md §11)
# ---------------------------------------------------------------------
#: lifecycle states: a request is QUEUED from submission until an engine
#: assigns it a slot, PREFILLING while its prompt chunks advance,
#: DECODING once tokens stream, and ends in exactly one terminal state.
#: Preemption sends DECODING back to QUEUED; the edge is annotated with
#: whether the KV was swapped to the host tier (resume skips recompute)
#: or freed (recompute-on-resume).
QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
FINISHED = "finished"
CANCELLED = "cancelled"
REJECTED = "rejected"

#: who may drive each edge is specified in docs/RUNTIME.md §11; the
#: machine itself only enforces the edge set. CANCELLED is reachable
#: from every non-terminal state (client disconnect at any phase).
LIFECYCLE_TRANSITIONS: Dict[str, frozenset] = {
    QUEUED: frozenset({PREFILL, DECODE, CANCELLED, REJECTED}),
    PREFILL: frozenset({DECODE, CANCELLED}),
    DECODE: frozenset({QUEUED, FINISHED, CANCELLED}),
    FINISHED: frozenset(),
    CANCELLED: frozenset(),
    REJECTED: frozenset(),
}

TERMINAL_STATES = frozenset({FINISHED, CANCELLED, REJECTED})


class RequestLifecycle:
    """Event-driven view of one request (docs/RUNTIME.md §11): the
    explicit QUEUED → PREFILL → DECODE → {FINISHED, CANCELLED, REJECTED}
    state machine, with wall-clock timestamps (enqueue, first token,
    finish) and per-token / per-event callbacks.

    The serving core owns the transitions (the engine reports
    slot-assignment and prefill completion, the pool reports terminal
    outcomes); the callbacks are how a streaming front-end observes
    them without polling. ``to()`` raises on an illegal edge — a
    lifecycle bug must fail loudly, not silently skip a state."""

    def __init__(self, request_id: int, enqueue_s: float,
                 on_event: Optional[Callable] = None,
                 on_token: Optional[Callable] = None):
        self.request_id = request_id
        self.state = QUEUED
        self.enqueue_s = enqueue_s
        self.admit_s = -1.0        # slot assignment (QUEUED -> PREFILL)
        self.first_token_s = -1.0  # first emitted token
        self.finish_s = -1.0       # terminal transition
        self.n_tokens = 0
        self.n_preempted = 0
        #: preemptions whose KV went to the host tier instead of being
        #: recomputed (subset of ``n_preempted``)
        self.n_swapped = 0
        #: ``on_event(lifecycle, state)`` after every transition;
        #: ``on_token(lifecycle, token, index)`` per emitted token
        self.on_event = on_event
        self.on_token = on_token

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def to(self, state: str, now_s: float, swapped: bool = False) -> None:
        """Transition to ``state``, stamping the matching timestamp.
        ``swapped`` annotates the preemption edge (DECODE -> QUEUED):
        True means the KV pages moved to the host tier and resume will
        skip recompute. Raises ``ValueError`` on an edge outside
        ``LIFECYCLE_TRANSITIONS`` (e.g. FINISHED -> anything)."""
        if state not in LIFECYCLE_TRANSITIONS:
            raise ValueError(f"unknown lifecycle state {state!r}")
        if state not in LIFECYCLE_TRANSITIONS[self.state]:
            raise ValueError(
                f"illegal lifecycle transition {self.state} -> {state} "
                f"(request {self.request_id})")
        prev, self.state = self.state, state
        if state == PREFILL or (state == DECODE and prev == QUEUED):
            self.admit_s = now_s
        elif state == QUEUED:
            self.n_preempted += 1  # DECODE -> QUEUED is preemption
            if swapped:
                self.n_swapped += 1
        elif state in TERMINAL_STATES:
            self.finish_s = now_s
        if self.on_event is not None:
            self.on_event(self, state)

    def token(self, tok: int, index: int, now_s: float) -> None:
        """Record one emitted token (``index`` is the global position in
        the completion, stable across preemption/resume)."""
        if self.first_token_s < 0:
            self.first_token_s = now_s
        self.n_tokens = max(self.n_tokens, index + 1)
        if self.on_token is not None:
            self.on_token(self, tok, index)

    # ---- derived timing (the client-observed serving metrics) ------------
    def ttft_s(self) -> float:
        """Enqueue -> first token (negative means no token yet)."""
        return self.first_token_s - self.enqueue_s \
            if self.first_token_s >= 0 else -1.0

    def tpot_s(self) -> float:
        """Mean seconds per output token after the first (-1 before two
        tokens have landed)."""
        if self.first_token_s < 0 or self.n_tokens < 2 \
                or self.finish_s < 0:
            return -1.0
        return (self.finish_s - self.first_token_s) / (self.n_tokens - 1)


@dataclasses.dataclass(order=False)
class Request:
    """One inference request (paper §III-A-1 request model)."""
    model: str            # m_t: DNN model type
    input_type: str       # d_t: "image" | "text" | "speech"
    input_shape: tuple    # d_s
    slo_ms: float         # SLO_i
    arrival_ms: float
    seq: int = dataclasses.field(default_factory=lambda: next(_counter))
    #: decode iterations this request needs (1 = single-shot inference;
    #: >1 models an autoregressive request under exec_mode="continuous",
    #: docs/ARCHITECTURE.md §5)
    decode_steps: int = 1
    #: iterations still to run once admitted (continuous-mode bookkeeping)
    remaining: int = 0
    #: prompt tokens that must be prefilled before decoding (0 = the
    #: paper's single-shot regime; >0 models long-prompt arrivals whose
    #: prefill is chunked under the per-iteration token budget)
    prefill_tokens: int = 0
    #: prefill tokens still to process (reset to prompt + emitted context
    #: on preemption — recompute-on-resume, docs/RUNTIME.md §8)
    prefill_remaining: int = 0
    #: templated workload (docs/ARCHITECTURE.md §5): the leading
    #: ``prefix_tokens`` of the prompt are one of a small population of
    #: shared prefixes, identified by ``prefix_id`` (-1 = no shared
    #: prefix); a prefix-cache hit skips their prefill
    prefix_id: int = -1
    prefix_tokens: int = 0
    #: times this request was preempted (hysteresis caps it)
    n_preempted: int = 0
    # filled at dispatch/completion:
    start_ms: Optional[float] = None
    finish_ms: Optional[float] = None

    @property
    def deadline_ms(self) -> float:
        return self.arrival_ms + self.slo_ms

    def queue_wait_ms(self) -> float:
        assert self.start_ms is not None
        return self.start_ms - self.arrival_ms

    def latency_ms(self) -> float:
        assert self.finish_ms is not None
        return self.finish_ms - self.arrival_ms

    def violated(self) -> bool:
        return self.latency_ms() > self.slo_ms


class RequestQueue:
    """SLO-priority queue (paper §IV-C: "the shorter the SLO, the higher
    the priority"): pops shortest-SLO first, FIFO among equals."""

    def __init__(self, model: str, max_len: int = 4096):
        self.model = model
        self._heap: List[tuple] = []
        self.max_len = max_len
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, r: Request) -> bool:
        if len(self._heap) >= self.max_len:
            self.dropped += 1
            return False
        heapq.heappush(self._heap, (r.slo_ms, r.seq, r))
        return True

    def pop_batch(self, b: int) -> List[Request]:
        out = []
        while self._heap and len(out) < b:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def peek_oldest_age(self, now_ms: float) -> float:
        if not self._heap:
            return 0.0
        return max(now_ms - r.arrival_ms for _, _, r in self._heap)

    def peek_most_urgent(self, now_ms: float):
        """(slack_ms, request) of the queued request closest to its
        deadline — the preemption trigger reads this
        (docs/RUNTIME.md §8). (inf, None) when empty."""
        best, slack = None, float("inf")
        for _, _, r in self._heap:
            s = r.deadline_ms - now_ms
            if s < slack:
                best, slack = r, s
        return slack, best

    def slo_sum_ms(self, b: int) -> float:
        slos = sorted(r.slo_ms for _, _, r in self._heap)[:b]
        return float(sum(slos))
