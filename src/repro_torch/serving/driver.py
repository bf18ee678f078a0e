"""Background serving driver (docs/RUNTIME.md §11): the port of
``repro.serving.driver``, the non-blocking iteration loop that turns the
pull-mode pool (caller drives ``step()``) into a push-mode serving core.

``ServingDriver`` owns a daemon thread that steps a
:class:`~repro_torch.serving.runtime.ModelInstancePool` continuously
whenever work is pending, sleeping briefly when idle. Every pool access —
the loop's ``step()``, front-end ``submit``/``cancel``, the scheduler's
control epoch — serialises on one re-entrant lock, so the pool itself
stays single-threaded (engines hold device caches and numpy state that
are not thread-safe) while callers never block on a drain.

The loop thread launches the pool's device work. On a GPU it enters the
pool's device and the CUDA stream that was current on that device when
``start()`` ran (``stream``): a thread's current stream is its own, so
without this the loop's kernels could land on another stream than the
one the pool's tensors were made on.

The optional ``on_tick`` hook is the scheduler's new decision cadence:
instead of deciding "between drains", the driver invokes it on a
wall-clock interval against live queue state (BCEdge's Eq. 1 slot,
docs/RUNTIME.md §2) while holding the pool lock.

Lifecycle events reach front-ends through the pool's per-request
listeners (``pool.add_listener``), which fire inside ``step()`` on THIS
thread — listeners must be cheap and non-reentrant (bridge to your own
loop, e.g. ``asyncio.call_soon_threadsafe``).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

import torch

from repro_torch.serving.runtime import ModelInstancePool, PoolResult


class ServingDriver:
    """Steps ``pool`` on a background thread; thread-safe facade for
    submit/cancel/stats. Usable as a context manager::

        with ServingDriver(pool, on_tick=sched_tick) as driver:
            rid = driver.submit("qwen", prompt, slo_ms=500.0)
            ...
    """

    def __init__(self, pool: ModelInstancePool,
                 idle_sleep_s: float = 0.002,
                 on_tick: Optional[Callable] = None,
                 tick_interval_s: float = 0.25):
        self.pool = pool
        self.idle_sleep_s = idle_sleep_s
        #: ``on_tick(pool)`` invoked under the pool lock at most once per
        #: ``tick_interval_s`` — the scheduler's wall-clock control epoch
        self.on_tick = on_tick
        self.tick_interval_s = tick_interval_s
        self.lock = threading.RLock()
        self.n_loop_steps = 0
        self.n_ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_tick = 0.0
        #: a loop-thread exception is re-raised to the NEXT caller of
        #: stop() instead of dying silently on a daemon thread
        self._error: Optional[BaseException] = None
        #: the CUDA stream the loop launches on (None for a CPU pool)
        self.stream: Optional[torch.cuda.Stream] = None

    # ---- lifecycle -------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ServingDriver":
        if self.running:
            raise RuntimeError("driver already running")
        self._stop.clear()
        self._error = None
        self._next_tick = time.perf_counter()
        if self.pool.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.pool.device)
        self._thread = threading.Thread(
            target=self._loop, name="serving-driver", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the loop (idempotent). Re-raises a loop-thread crash so
        test/benchmark harnesses cannot pass on a dead driver."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():  # pragma: no cover - hang guard
                raise RuntimeError("serving driver failed to stop")
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __enter__(self) -> "ServingDriver":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- thread-safe pool facade ----------------------------------------
    def submit(self, *args, **kwargs) -> int:
        with self.lock:
            return self.pool.submit(*args, **kwargs)

    def cancel(self, request_id: int) -> Optional[PoolResult]:
        with self.lock:
            return self.pool.cancel(request_id)

    def add_listener(self, request_id: int, fn: Callable) -> None:
        with self.lock:
            self.pool.add_listener(request_id, fn)

    def remove_listener(self, request_id: int) -> None:
        with self.lock:
            self.pool.remove_listener(request_id)

    def admission_headroom(self, *args, **kwargs):
        with self.lock:
            return self.pool.admission_headroom(*args, **kwargs)

    def stats(self):
        with self.lock:
            return self.pool.stats()

    def report(self):
        with self.lock:
            return self.pool.report()

    def drain(self, timeout_s: float = 60.0) -> None:
        """Block the CALLING thread until the pool has no progressable
        work (the background loop keeps stepping; this only polls)."""
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            with self.lock:
                if not (self.pool._work_pending()
                        and self.pool._can_progress()):
                    return
            time.sleep(self.idle_sleep_s)
        raise TimeoutError(f"pool not drained after {timeout_s}s")

    # ---- loop ------------------------------------------------------------
    def _device_scope(self) -> contextlib.ExitStack:
        """The loop thread's device and stream: the pool's device and the
        stream captured at ``start()`` (nothing for a CPU pool)."""
        scope = contextlib.ExitStack()
        if self.stream is not None:
            scope.enter_context(torch.cuda.device(self.pool.device))
            scope.enter_context(torch.cuda.stream(self.stream))
        return scope

    def _loop(self) -> None:
        try:
            with self._device_scope():
                self._run()
        except BaseException as e:  # noqa: BLE001 - surfaced in stop()
            self._error = e

    def _run(self) -> None:
        while not self._stop.is_set():
            stepped = False
            with self.lock:
                now = time.perf_counter()
                if self.on_tick is not None and now >= self._next_tick:
                    self._next_tick = now + self.tick_interval_s
                    self.on_tick(self.pool)
                    self.n_ticks += 1
                if self.pool._work_pending() \
                        and self.pool._can_progress():
                    self.pool.step()
                    self.n_loop_steps += 1
                    stepped = True
            if not stepped:
                # idle (or unprogressable until a tick scales up):
                # yield the lock so submits/cancels never starve
                time.sleep(self.idle_sleep_s)
            else:
                # let a thread waiting on the lock take it between steps:
                # without this yield the loop takes the lock back at once
                # and a front-end's handlers wait for the whole drain
                time.sleep(0)
