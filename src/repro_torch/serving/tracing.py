"""The serving engine's spans: in memory, process-wide, on the host clock.

``ContinuousBatchingEngine`` records spans around its own calls: each
``step``, and inside it ``admit``, every blocking host-to-device
``upload``, each prefill piece's forward (``prefill``), the decode and
verify forwards (``decode``, ``verify``) and each token ``readback``. A
step records them only while a ``torch.profiler`` session runs in its
thread: it reads ``torch.autograd._profiler_enabled()`` once at its top,
and otherwise records nothing, allocates nothing and creates no CUDA
event. The spans go to one process-wide ``Recorder`` (``RECORDER``), so
a reader with no handle on the engine finds them, as it finds the
profiler's trace.

Times are ``time.perf_counter()`` seconds, the clock a profiler trace is
laid on, so each gap in the device trace can be set against what the
engine was doing then. A span has a name, its host start and end, its
parent (the span that caused it; 0 for a step), the engine it belongs
to (its ``span_key``, from ``engine_key``), the request it serves (-1
where it serves several or none) and attributes: a step's ``iteration``
(the engine's ``n_iters`` at its start), the slots ``admit``
assigned, an upload's ``bytes``, a prefill piece's ``T``, ``start``,
``pad``, ``real`` and ``last`` (``piece``), a decode forward's ``rows``,
``contexts_active`` and ``real_contexts`` (each decoding row's context,
and that less its prompt's bucket padding) and a verify forward's
``rows`` and ``width``.

On a CUDA device each forward span also carries its device interval on
the same clock (``dev``): CUDA events recorded on the current stream
before the forward's first launch and after its last, placed from an
anchor event that the previous traced step recorded just after its last
readback, when the host had waited for the stream to drain. The events
are read once the step has ended, after its own readback; a forward
whose end event has not completed then, and every forward of a step
with no anchor (the first traced step), keeps ``dev`` None. Tracing adds
no synchronisation, no device work and no profiler range.

To read them, run the engine under the profiler and take the
recorder's spans::

    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import tracing

    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(n):
            engine.step()
    spans = tracing.RECORDER.spans(engine)

A step's self time (its span less its children's) is the engine's
bookkeeping: token appends, ``on_token`` hooks, block allocation and
eviction. ``engine.stats()`` reports the recorder's ``n_spans_dropped``
beside the engine's ``n_host_syncs``.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

import torch

#: spans the recorder keeps; past it the oldest are dropped and counted
CAPACITY = 1 << 20

_engine_keys = itertools.count(1)


def engine_key() -> int:
    """A key no other engine of this process holds (``id()`` values are
    reused once an engine is gone)."""
    return next(_engine_keys)


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    id: int
    parent: int
    engine: int
    t0: float
    t1: float = 0.0
    request: int = -1
    attrs: Dict = dataclasses.field(default_factory=dict)
    #: the forward's device interval on the host clock (CUDA, anchored
    #: steps only)
    dev: Optional[Tuple[float, float]] = None


class Recorder:
    """A bounded buffer of finished spans: full, it drops the oldest and
    counts the drops (``n_dropped``)."""

    def __init__(self, capacity: int = CAPACITY):
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self.n_dropped = 0
        self.ids = itertools.count(1)

    def add(self, span: Span) -> None:
        if len(self._spans) == self._spans.maxlen:
            self.n_dropped += 1
        self._spans.append(span)

    def spans(self, engine=None) -> List[Span]:
        """The kept spans in the order they ended, ``engine``'s alone
        where one is given."""
        if engine is None:
            return list(self._spans)
        key = engine.span_key
        return [s for s in self._spans if s.engine == key]


RECORDER = Recorder()


def piece(T: int, start: int, pad: int, seq_len: int) -> Dict:
    """A prefill piece's attributes: ``T`` positions from ``start`` of a
    sequence of ``seq_len`` whose prompt sits behind ``pad`` positions of
    bucket padding; ``real`` of them lie past that padding, and ``last``
    says the piece ends the sequence."""
    return {"T": T, "start": start, "pad": pad,
            "real": max(0, start + T - max(start, pad)),
            "last": start + T >= seq_len}


class StepTrace:
    """The spans of one traced engine step while it runs. ``anchor`` is
    the (event, host time) the previous traced step's last readback left,
    or None."""

    def __init__(self, engine, index: int, anchor):
        self.engine = engine.span_key
        self.stream = torch.cuda.current_stream(engine.device) \
            if engine.device.type == "cuda" else None
        self.anchor = anchor
        #: (event, host time) just after this step's last readback
        self.drained = None
        self._stack: List[Span] = []
        self._forwards: List[list] = []  # [span, start event, end event]
        self.open("step", iteration=index)

    def open(self, name: str, request: int = -1, **attrs) -> Span:
        parent = self._stack[-1].id if self._stack else 0
        sp = Span(name, next(RECORDER.ids), parent, self.engine,
                  time.perf_counter(), request=request, attrs=attrs)
        self._stack.append(sp)
        return sp

    def close(self, sp: Span) -> None:
        sp.t1 = time.perf_counter()
        while self._stack.pop() is not sp:  # children an exception left
            pass
        RECORDER.add(sp)

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def forward(self, name: str, request: int = -1, **attrs) -> Span:
        """Open a forward's span; on CUDA mark its device start."""
        sp = self.open(name, request, **attrs)
        if self.stream is not None:
            self._forwards.append([sp, self._event(), None])
        return sp

    def forward_done(self, sp: Span) -> None:
        if self.stream is not None:
            self._forwards[-1][2] = self._event()
        self.close(sp)

    def readback_done(self) -> None:
        """The host has just waited for the stream: mark the anchor the
        next step places its device intervals from."""
        if self.stream is not None:
            self.drained = (self._event(), time.perf_counter())

    def finish(self):
        """Place the forwards' device intervals and close the step's
        span; returns the next step's anchor."""
        if self.anchor is not None:
            a, ta = self.anchor
            for sp, e0, e1 in self._forwards:
                if e1 is not None and e1.query():
                    sp.dev = (ta + 1e-3 * a.elapsed_time(e0),
                              ta + 1e-3 * a.elapsed_time(e1))
        while self._stack:
            self.close(self._stack[-1])
        return self.drained
