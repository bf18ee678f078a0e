"""Driving the program's continuous-batching engine with a schedule, and
the host-clock records a run keeps.

Every timestamp is ``time.perf_counter()`` in this process. The engine's
``on_token`` and ``on_state`` hooks stamp each emitted token and each
admission; the loop stamps when each request was due and when it was
submitted. In a traced run the profiler covers the window from its first
step boundary to the end of the loop, and ``Spans`` wraps the model's two
forward entry points on this engine's instance, recording each forward's
shape (the prefill piece's length and start, the decode step's rows and
each row's context, read from the engine's host-side state, so no wrapper
waits for the device) and host spans around the calls into each layer.
A forward record also says which of its work the requests need: the
program left-pads a prompt to its bucket and decodes every slot's row,
so a piece's ``real`` positions are those past its prompt's padding, and
a decode step's ``real_contexts`` are its decoding rows' contexts less
their padding.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional

from perfbench.traffic.generator import Request, Schedule

#: seconds past the window's close allowed for the window's first tokens
MAX_WAIT_S = 60.0


@dataclasses.dataclass
class Stamps:
    """What the host saw of each request, by the engine's request id."""
    req: Dict[int, Request] = dataclasses.field(default_factory=dict)
    due: Dict[int, float] = dataclasses.field(default_factory=dict)
    submit: Dict[int, float] = dataclasses.field(default_factory=dict)
    admit: Dict[int, float] = dataclasses.field(default_factory=dict)
    tokens: Dict[int, List[float]] = dataclasses.field(default_factory=dict)
    results: Dict[int, object] = dataclasses.field(default_factory=dict)

    def on_token(self, rid: int, token: int, index: int) -> None:
        self.tokens.setdefault(rid, []).append(time.perf_counter())

    def on_state(self, rid: int, state: str) -> None:
        if state == "prefill":
            self.admit.setdefault(rid, time.perf_counter())


class Spans:
    """Host spans and forward records of a traced run (see module doc)."""

    def __init__(self, engine, stamps: Stamps):
        self.spans: List[tuple] = []
        self.forwards: List[Dict] = []
        model = engine.model
        prefill, decode = model.prefill_chunk, model.decode_step

        def pad(slot) -> int:
            """The bucket padding ahead of the slot's prompt."""
            return slot.base_len - len(stamps.req[slot.request_id].prompt)

        def prefill_chunk(params, cache, batch):
            slot = engine.slots[engine.prefilling_slots[0]]
            T, start, p = int(batch["tokens"].shape[1]), slot.prefill_pos, \
                pad(slot)
            rec = {"kind": "prefill", "T": T, "start": start, "pad": p,
                   "real": max(0, start + T - max(start, p)),
                   "last": start + T >= len(slot.seq_tokens)}
            with self.span("model.prefill_chunk", rec):
                return prefill(params, cache, batch)

        def decode_step(params, cache, batch):
            pos = engine.pos
            dec = engine.decoding_slots
            rec = {"kind": "decode", "rows": int(batch["tokens"].shape[0]),
                   "contexts_active": [int(pos[i]) + 1 for i in dec],
                   "real_contexts": [int(pos[i]) + 1 - pad(engine.slots[i])
                                     for i in dec]}
            with self.span("model.decode_step", rec):
                return decode(params, cache, batch)

        model.prefill_chunk = prefill_chunk
        model.decode_step = decode_step

    @contextlib.contextmanager
    def span(self, name: str, forward: Optional[Dict] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.spans.append((name, t0, t1))
            if forward is not None:
                forward.update(t0=t0, t1=t1)
                self.forwards.append(forward)


@dataclasses.dataclass
class Window:
    """The measured window, and the traced part of it (host seconds)."""
    start: float = 0.0
    end: float = 0.0
    #: when the loop stopped
    stopped: float = 0.0
    trace: Optional[object] = None  # trace.DeviceTrace
    stats: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    window_rids: List[int] = dataclasses.field(default_factory=list)


class Driver:
    """One engine, one schedule, one window."""

    def __init__(self, engine, stamps: Stamps, spans: Optional[Spans],
                 tracer_factory: Optional[Callable] = None):
        self.engine = engine
        self.stamps = stamps
        self.spans = spans
        self.tracer_factory = tracer_factory
        engine.on_token = stamps.on_token
        engine.on_state = stamps.on_state
        self.win = Window()
        #: seconds past the window's close allowed for its first tokens
        self.max_wait = MAX_WAIT_S

    def _span(self, name: str):
        return self.spans.span(name) if self.spans is not None \
            else contextlib.nullcontext()

    def submit(self, r: Request, due: float) -> int:
        with self._span("engine.submit"):
            t = time.perf_counter()
            rid = self.engine.submit(r.prompt, r.max_new)
        st = self.stamps
        st.req[rid], st.due[rid], st.submit[rid] = r, due, t
        return rid

    def step(self) -> None:
        self._window_edge()
        self._trace_edges()
        with self._span("engine.step"):
            done = self.engine.step()
        for res in done:
            self.stamps.results[res.request_id] = res

    def _busy(self) -> bool:
        return bool(self.engine.waiting or self.engine.active_slots)

    def _window_edge(self) -> None:
        """Note the time and the engine's step count at the first step
        boundary in the window (every run; ``_finish_trace`` notes them
        where the loop stops)."""
        w = self.win
        if w.start and "steps_from" not in w.stats \
                and time.perf_counter() >= w.start:
            w.stats["steps_from"] = (time.perf_counter(),
                                     self.engine.n_iters)

    def _trace_edges(self) -> None:
        """Start the profiler at the first step boundary in the window."""
        w = self.win
        if self.tracer_factory is None or not w.start or w.trace is not None:
            return
        if time.perf_counter() >= w.start:
            w.stats["trace_start"] = self.engine.stats()
            w.trace = self.tracer_factory()
            w.trace.start()

    def _finish_trace(self) -> None:
        """Stop the profiler once the loop is over: reading the trace
        takes seconds, and inside the loop it would hold up arrivals."""
        w = self.win
        w.stats["steps_to"] = (time.perf_counter(), self.engine.n_iters)
        if w.trace is not None and not w.trace.stopped:
            w.trace.stop()
            w.stats["trace_end"] = self.engine.stats()

    # ---- the two loops --------------------------------------------------
    def run_open(self, sched: Schedule, rate: float, seconds: float,
                 preadmit: int) -> Window:
        """An open loop at ``rate``: the preadmitted population prefilled
        first, then the lead-in's, the window's and the tail's arrivals
        on schedule until every request due in the window has its first
        token (or ``MAX_WAIT_S`` past the close)."""
        mix = sched.mix
        for r in sched.preadmit(preadmit):
            self.submit(r, time.perf_counter())
        while self.engine.waiting or self.engine.prefilling_slots:
            self.step()
        segs = sched.open_loop(rate, mix["lead_in_s"], seconds,
                               mix["tail_s"])
        t0 = time.perf_counter()
        w = self.win
        w.start = t0 + mix["lead_in_s"]
        w.end = w.start + seconds
        base = {"lead_in": t0, "window": w.start, "tail": w.end}
        arrivals = [(base[name] + r.due, r) for name in base
                    for r in segs[name]]
        i = 0
        while True:
            now = time.perf_counter()
            while i < len(arrivals) and arrivals[i][0] <= now:
                due, r = arrivals[i]
                rid = self.submit(r, due)
                if r.segment == "window":
                    w.window_rids.append(rid)
                i += 1
            if now >= w.end:
                if all(rid in self.stamps.tokens for rid in w.window_rids) \
                        or now >= w.end + self.max_wait:
                    break
            if self._busy():
                self.step()
            elif i < len(arrivals):
                with self._span("harness.wait"):
                    time.sleep(max(0.0, min(arrivals[i][0] - now, 0.01)))
            else:
                break
        w.stopped = time.perf_counter()
        self._finish_trace()
        return w

    def run_closed(self, sched: Schedule, n_slots: int,
                   seconds: float) -> Window:
        """A closed queue: ``n_slots`` preadmitted requests, then the
        queue topped up before every step so that a free slot always
        finds work; the window opens ``lead_in_s`` after the preadmitted
        population's first tokens and closes ``seconds`` later."""
        queue: Iterator[Request] = sched.queue()
        pre = [self.submit(r, time.perf_counter())
               for r in sched.preadmit(n_slots)]
        w = self.win

        def top_up():
            eng = self.engine
            for _ in range(len(eng.free_slots) + 2 - len(eng.waiting)):
                self.submit(next(queue), time.perf_counter())

        while not all(rid in self.stamps.tokens for rid in pre):
            top_up()
            self.step()
        w.start = time.perf_counter() + sched.mix["lead_in_s"]
        w.end = w.start + seconds
        while True:
            now = time.perf_counter()
            if now >= w.end:
                break
            top_up()
            self.step()
        w.stopped = time.perf_counter()
        self._finish_trace()
        return w
