"""The per-request lifecycle state machine the pool pushes events
through: the port of ``repro.serving.request``'s ``RequestLifecycle``
(docs/RUNTIME.md §11), unchanged.

The simulator's ``Request`` and ``RequestQueue`` come with the simulator
(ROADMAP.md, Queue A item 8).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional


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
