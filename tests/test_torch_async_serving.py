"""Push-mode serving on the port, on the CPU: cancellation in the engine
and the pool, pool events and timing stats, the background
``ServingDriver``, the HTTP ``ServingFrontend`` and ``serve_http``.

tests/test_async_serving.py's engine, pool, driver and HTTP halves,
mirrored. Engine and pool tests run the same submit/step/cancel schedule
through the reference and the port (the reference's weights bridged in,
the pools' clocks frozen) and compare tokens, the ``cancelled`` and
``truncated`` flags, instance ids, events and counters. Driver and HTTP
tests serve the reference's weights and compare the streamed tokens with
the reference pool's offline tokens.

No test here races the serving thread: where a request must still be
running when it is cancelled, the pool's ``_can_progress`` is held
false from its first token on (``_Hold``), so the driver idles, without
its lock, until the cancel has landed. Every thread and socket wait has
its own timeout of at most 30 s.
"""
import asyncio
import dataclasses
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from conftest import TINY, make_cont_engine, make_pool
from repro.serving.driver import ServingDriver as JaxDriver
from repro_torch.config.base import ModelConfig
from repro_torch.launch import engine_serve
from repro_torch.launch.server import ServingFrontend
from repro_torch.serving.driver import ServingDriver
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.runtime import ModelInstancePool
from repro_torch.serving.workload import (_read_chunked_events,
                                          http_generate)

TTINY = ModelConfig(**dataclasses.asdict(TINY))
WAIT_S = 30.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, TINY.vocab_size, n).astype(np.int32)


def _engines(max_slots=1, max_seq=64, **kw):
    je = make_cont_engine(TINY, max_slots=max_slots, max_seq=max_seq, **kw)
    te = ContinuousBatchingEngine(TTINY, max_slots=max_slots,
                                  max_seq=max_seq, device="cpu", **kw)
    te.load_jax_params(jax.tree.map(np.asarray, je.params))
    return {"ref": je, "port": te}


def _drain(eng, results):
    guard = 600
    while (eng.waiting or eng.active_slots) and guard:
        for r in eng.step():
            results[r.request_id] = r
        guard -= 1
    assert guard, "engine failed to drain"


def _assert_no_leak(eng):
    if eng.allocator is not None:
        assert eng.allocator.n_live == 0
        assert eng.allocator.n_reserved == 0


def _res(r):
    if r is None:
        return None
    return (r.request_id, list(map(int, r.tokens)), r.cancelled,
            r.truncated, r.n_preempted, r.n_iters)


def _counters(eng):
    st = eng.stats()
    return {k: st[k] for k in ("n_cancelled", "n_preempted", "n_evicted",
                               "n_admitted", "n_iters")}


# ------------------------------------------------------------ engine
def test_engine_cancel_queued_and_survivor_identity():
    out = {}
    for name, eng in _engines(kv_layout="paged", block_size=8).items():
        p1, p2 = _prompt(8, 1), _prompt(8, 2)
        r1 = eng.submit(p1, max_new_tokens=5)
        r2 = eng.submit(p2, max_new_tokens=5)  # waits: one slot
        for _ in range(2):
            eng.step()
        res = eng.cancel(r2)
        assert res is not None and res.cancelled and res.request_id == r2
        assert not eng.waiting, "cancelled request still queued"
        results = {}
        _drain(eng, results)
        assert eng.stats()["n_cancelled"] == 1
        _assert_no_leak(eng)
        out[name] = (_res(res), _res(results[r1]), _counters(eng))
    assert out["port"] == out["ref"]


def test_engine_cancel_mid_decode_frees_blocks_synchronously():
    out = {}
    for name, eng in _engines(2, kv_layout="paged", block_size=8).items():
        r1 = eng.submit(_prompt(8, 3), max_new_tokens=6)
        r2 = eng.submit(_prompt(8, 4), max_new_tokens=20)
        for _ in range(3):
            eng.step()
        live_before = eng.allocator.n_live
        res = eng.cancel(r2)
        assert res.cancelled and 0 < len(res.tokens) < 20
        assert eng.allocator.n_live < live_before, \
            "blocks not freed synchronously on cancel"
        results = {}
        _drain(eng, results)
        _assert_no_leak(eng)
        out[name] = (_res(res), _res(results[r1]), _counters(eng),
                     live_before)
    assert out["port"] == out["ref"]


def test_engine_cancel_mid_prefill_and_preempted():
    """A mid-prefill cancel (the token budget forces chunks), then a
    cancel while a preempted sequence waits to resume: both carry the
    same partial tokens as the reference's, and the survivor's tokens
    are the reference's."""
    out = {}
    for name, eng in _engines(2, kv_layout="paged", block_size=8,
                              token_budget=8).items():
        long_p, short_p = _prompt(30, 5), _prompt(6, 6)
        rid_long = eng.submit(long_p, max_new_tokens=5)
        eng.step()  # the first chunk lands: the slot is mid-prefill
        res1 = eng.cancel(rid_long)
        assert res1 is not None and res1.cancelled
        _assert_no_leak(eng)
        rid_a = eng.submit(long_p, max_new_tokens=5)
        rid_b = eng.submit(short_p, max_new_tokens=5)
        guard = 100
        while rid_a not in [eng.slots[i].request_id
                            for i in eng.decoding_slots] and guard:
            eng.step()
            guard -= 1
        assert guard, "request never reached decode"
        eng.step()  # one more token before the eviction
        slot = next(i for i in eng.decoding_slots
                    if eng.slots[i].request_id == rid_a)
        eng.preempt(slot)
        res2 = eng.cancel(rid_a)  # preempted, awaiting resume
        assert res2 is not None and res2.cancelled and len(res2.tokens)
        results = {}
        _drain(eng, results)
        assert eng.stats()["n_cancelled"] == 2
        _assert_no_leak(eng)
        out[name] = (_res(res1), _res(res2), _res(results[rid_b]),
                     _counters(eng))
    assert out["port"] == out["ref"]


def test_engine_cancel_unknown_or_finished_is_noop():
    for eng in _engines(1).values():
        assert eng.cancel(999) is None
        rid = eng.submit(_prompt(6, 7), max_new_tokens=2)
        results = {}
        _drain(eng, results)
        assert rid in results
        assert eng.cancel(rid) is None  # already finished
        assert eng.stats()["n_cancelled"] == 0


def test_engine_token_indices_are_global_across_a_preemption():
    """``on_token``'s index is the completion position, stable across a
    resume: both engines fire 0..n-1 once each, the same tokens."""
    out = {}
    for name, eng in _engines(1, 64).items():
        seen = []
        eng.on_token = lambda rid, tok, idx: seen.append((rid, tok, idx))
        eng.submit(_prompt(7, 8), max_new_tokens=9)
        for _ in range(4):
            eng.step()
        eng.preempt(eng.decoding_slots[0])
        results = {}
        _drain(eng, results)
        assert [i for _, _, i in seen] == list(range(9))
        assert [t for _, t, _ in seen] == list(results[0].tokens)
        out[name] = seen
    assert out["port"] == out["ref"]


# ------------------------------------------------------------ pool
def _pools(monkeypatch, **kw):
    kw.setdefault("max_instances", 1)
    kw.setdefault("max_seq", 64)
    pools = {"ref": make_pool(TINY, **kw),
             "port": ModelInstancePool({"tiny": TTINY}, device="cpu", **kw)}
    for pool in pools.values():
        monkeypatch.setattr(pool, "now", lambda: 1.0)
        pool.scale_to("tiny", 1)
    pools["port"].load_jax_params("tiny", jax.tree.map(
        np.asarray, pools["ref"].running("tiny")[0].engine.params))
    return pools


def _pool_res(r):
    return (r.request_id, r.instance_id, list(map(int, r.tokens)),
            r.cancelled, r.rejected)


def test_pool_cancel_dequeues_immediately_no_head_starvation(monkeypatch):
    out = {}
    for name, pool in _pools(monkeypatch, max_slots=1, kv_layout="paged",
                             block_size=8).items():
        r0 = pool.submit("tiny", _prompt(6, 8), slo_ms=5000.0,
                         max_new_tokens=24, submit_s=1.0)
        pool.step()
        # r1 goes to the EDF queue head (tightest deadline), r2 behind it
        r1 = pool.submit("tiny", _prompt(6, 9), slo_ms=10.0,
                         max_new_tokens=4, submit_s=1.0)
        r2 = pool.submit("tiny", _prompt(6, 10), slo_ms=8000.0,
                         max_new_tokens=4, submit_s=1.0)
        assert len(pool.queues["tiny"]) == 2
        res = pool.cancel(r1)
        assert res is not None and res.cancelled
        # the cancelled head leaves the queue now, not as a tombstone
        assert len(pool.queues["tiny"]) == 1
        pool.run_until_drained()
        by_id = {r.request_id: r for r in pool.results("tiny")}
        assert not by_id[r0].cancelled and not by_id[r2].cancelled
        assert len(by_id[r2].tokens) == 4
        assert pool.stats()["n_cancelled"] == 1
        rep = pool.report()["tiny"]
        assert rep["cancelled"] == 1 and rep["served"] == 2
        out[name] = (sorted(_pool_res(r) for r in pool.results("tiny")),
                     {k: rep[k] for k in ("served", "rejected", "cancelled",
                                          "violations", "preempted")},
                     list(pool.admission_log))
    assert out["port"] == out["ref"]


def test_pool_cancel_running_and_unknown(monkeypatch):
    out = {}
    for name, pool in _pools(monkeypatch, max_slots=2).items():
        rid = pool.submit("tiny", _prompt(6, 11), slo_ms=5000.0,
                          max_new_tokens=24, submit_s=1.0)
        for _ in range(3):
            pool.step()
        res = pool.cancel(rid)
        assert res is not None and res.cancelled and len(res.tokens) < 24
        assert pool.cancel(rid) is None  # second cancel: no-op
        assert pool.cancel(12345) is None
        pool.run_until_drained()
        out[name] = (_pool_res(res), pool.stats()["n_cancelled"])
    assert out["port"] == out["ref"]


def test_pool_events_and_wallclock_stats(monkeypatch):
    """The same event sequence (kinds, token indices and tokens, the
    finished payload) from both pools, and TTFT/TPOT stats."""
    out = {}
    for name, pool in _pools(monkeypatch, max_slots=2).items():
        events = []
        rid = pool.submit("tiny", _prompt(6, 12), slo_ms=5000.0,
                          max_new_tokens=4, submit_s=1.0)
        pool.add_listener(rid, events.append)
        pool.run_until_drained()
        kinds = [e["event"] for e in events]
        assert kinds == ["prefill", "decode", "token", "token", "token",
                         "token", "finished"]
        assert [e["index"] for e in events if e["event"] == "token"] \
            == [0, 1, 2, 3]
        res = pool.results("tiny")[-1]
        assert res.first_token_s > 0 and res.ttft_ms >= 0
        assert res.tpot_ms >= 0
        assert events[-1]["request_id"] == rid
        out[name] = [(e["event"], e.get("token"), e.get("index"),
                      e.get("tokens"), e.get("truncated"),
                      e.get("n_preempted"), e.get("instance_id"))
                     for e in events]
    assert out["port"] == out["ref"]
    assert rid not in pool._listeners


def test_pool_admission_headroom_fields(monkeypatch):
    """The backpressure signal, its retry estimate priced with one pinned
    token-cost fit: the same fields from both pools."""
    out = {}
    for name, pool in _pools(monkeypatch, max_slots=1).items():
        monkeypatch.setattr(pool, "token_cost", lambda: (2.0, 0.5))
        heads = [pool.admission_headroom("tiny", 8, 4)]
        assert heads[0]["admissible_now"] and heads[0]["queue_depth"] == 0
        pool.submit("tiny", _prompt(6, 13), slo_ms=5000.0,
                    max_new_tokens=24, submit_s=1.0)
        pool.step()
        for s in range(4):
            pool.submit("tiny", _prompt(6, 20 + s), slo_ms=5000.0,
                        max_new_tokens=8, submit_s=1.0)
        heads.append(pool.admission_headroom("tiny", 8, 4))
        assert not heads[1]["admissible_now"]
        assert heads[1]["queue_depth"] == 4
        assert heads[1]["retry_after_s"] > 0
        pool.run_until_drained()
        out[name] = heads
    assert out["port"] == out["ref"]


def test_over_long_prompt_kills_the_loop_in_both_packages(monkeypatch):
    """The reference's defect, mirrored on purpose: the pool accepts a
    prompt whose bucket cannot fit ``cache_len``; routing it raises
    ``ValueError`` out of ``step()`` and it leaves no result. Behind a
    driver the loop stops on it and ``stop()`` re-raises it."""
    long_p = _prompt(33, 14)  # bucket 64 leaves no room in max_seq 64
    for name, pool in _pools(monkeypatch, max_slots=1).items():
        rid = pool.submit("tiny", long_p, slo_ms=5000.0, max_new_tokens=4)
        with pytest.raises(ValueError, match="does not fit cache_len"):
            pool.step()
        assert pool.results("tiny") == [] and pool.queue_len("tiny") == 0
        assert pool.cancel(rid) is None
        driver = (JaxDriver if name == "ref" else ServingDriver)(pool)
        driver.start()
        driver.submit("tiny", long_p, slo_ms=5000.0, max_new_tokens=4)
        t0 = time.perf_counter()
        while driver.running and time.perf_counter() - t0 < WAIT_S:
            time.sleep(0.005)
        assert not driver.running, f"{name}: the loop survived"
        with pytest.raises(ValueError, match="does not fit cache_len"):
            driver.stop()
        driver.stop()  # the error is raised once


# ------------------------------------------------------------ driver
class _Hold:
    """Holds a pool's progress from its first emitted token on: while
    set, ``_can_progress`` reads false, so a driver loop idles (and
    sleeps outside its lock) instead of stepping; ``release`` lets it go
    on. The engines call ``pool._on_engine_token`` through the instance,
    so wrapping it there sees every token."""

    def __init__(self, pool):
        self.held = threading.Event()
        self.armed = True
        on_token, can_progress = pool._on_engine_token, pool._can_progress

        def _on_token(*a):
            on_token(*a)
            if self.armed:
                self.held.set()

        pool._on_engine_token = _on_token
        pool._can_progress = lambda: can_progress() and \
            not self.held.is_set()

    def release(self):
        self.armed = False
        self.held.clear()


def _port_pool(max_slots=2, kv_layout="dense", **kw):
    """A port pool with the reference pool's weights (seed 0) and its
    reference twin."""
    ref = make_pool(TINY, max_instances=1, max_slots=max_slots, max_seq=64,
                    kv_layout=kv_layout, **kw)
    ref.scale_to("tiny", 1)
    pool = ModelInstancePool({"tiny": TTINY}, max_instances=1,
                             max_slots=max_slots, max_seq=64,
                             kv_layout=kv_layout, device="cpu", **kw)
    pool.scale_to("tiny", 1)
    pool.load_jax_params("tiny", jax.tree.map(
        np.asarray, ref.running("tiny")[0].engine.params))
    return ref, pool


def _ref_tokens(ref, prompts, max_new):
    ids = [ref.submit("tiny", p, slo_ms=1e6, max_new_tokens=max_new)
           for p in prompts]
    by_id = {r.request_id: r for r in ref.run_until_drained()}
    return [list(map(int, by_id[i].tokens)) for i in ids]


def test_driver_background_submit_and_events():
    ref, pool = _port_pool()
    pool.warmup(seed=0)
    done = threading.Event()
    events = []

    def listener(ev):
        events.append(ev)
        if ev["event"] in ("finished", "cancelled", "rejected"):
            done.set()

    prompt = _prompt(6, 14)
    with ServingDriver(pool, idle_sleep_s=0.001) as driver:
        assert driver.running and driver.stream is None  # a CPU pool
        rid = driver.submit("tiny", prompt, slo_ms=5000.0, max_new_tokens=4)
        driver.add_listener(rid, listener)
        assert done.wait(timeout=WAIT_S), "no terminal event from driver"
        driver.drain(timeout_s=WAIT_S)
    assert not driver.running
    assert [e["event"] for e in events][-1] == "finished"
    assert driver.n_loop_steps > 0
    assert events[-1]["tokens"] == _ref_tokens(ref, [prompt], 4)[0]


def test_driver_cancel_and_stop_idempotent():
    """A request cancelled mid-decode through the driver from the test
    thread: held after its first token, so it cannot finish first."""
    _, pool = _port_pool(max_slots=1)
    pool.warmup(seed=0)
    hold = _Hold(pool)
    driver = ServingDriver(pool).start()
    try:
        rid = driver.submit("tiny", _prompt(6, 15), slo_ms=5000.0,
                            max_new_tokens=48)
        assert hold.held.wait(timeout=WAIT_S), "no token from the driver"
        res = driver.cancel(rid)
        assert res is not None and res.cancelled and len(res.tokens) == 1
        assert driver.cancel(rid) is None
        hold.release()
        driver.drain(timeout_s=WAIT_S)
    finally:
        driver.stop()
        driver.stop()  # idempotent
    assert not driver.running
    assert pool.stats()["n_cancelled"] == 1
    eng = pool.live()[0].engine
    assert eng.kv_used_tokens == 0 and not eng.active_slots


# ---------------------------------------------------------------- http
def _http_stack(backpressure=True, max_queue_depth=2, max_slots=2):
    ref, pool = _port_pool(max_slots=max_slots, kv_layout="paged",
                           block_size=8)
    pool.warmup(seed=0)
    driver = ServingDriver(pool)
    fe = ServingFrontend(driver, port=0, backpressure=backpressure,
                         max_queue_depth=max_queue_depth)
    return ref, pool, driver, fe


async def _post(port, obj):
    """Open a raw client, POST ``obj``; returns (reader, writer, status
    line), the headers consumed."""
    body = (obj if isinstance(obj, str) else json.dumps(obj)).encode()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"POST /v1/generate HTTP/1.1\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    status = await reader.readline()
    while await reader.readline() not in (b"\r\n", b"\n", b""):
        pass
    return reader, writer, status.decode()


async def _stream(port, prompt, max_new):
    reader, writer, status = await _post(port, {
        "model": "tiny", "prompt": prompt.tolist(),
        "max_new_tokens": max_new, "slo_ms": 5000.0})
    assert "200" in status, status
    events = [ev async for ev in _read_chunked_events(reader)]
    writer.close()
    return events


def test_http_stream_end_to_end():
    """Four concurrent streams: each is accepted -> prefill -> decode ->
    token* -> finished, its tokens are the reference pool's offline
    ones, and http_generate's client-side TTFT/TPOT are set."""
    prompts = [_prompt(5 + 2 * i, 16 + i) for i in range(4)]

    async def run():
        ref, pool, driver, fe = _http_stack()
        driver.start()
        await fe.start()
        try:
            streams = await asyncio.wait_for(asyncio.gather(
                *(_stream(fe.port, p, 5) for p in prompts)), WAIT_S)
            out = await asyncio.wait_for(http_generate(
                "127.0.0.1", fe.port, "tiny", prompts[0], 5, 5000.0), WAIT_S)
        finally:
            await fe.stop()
            driver.stop()
        return ref, pool, streams, out

    ref, pool, streams, out = asyncio.run(run())
    want = _ref_tokens(ref, prompts, 5)
    for events, tokens in zip(streams, want):
        kinds = [e["event"] for e in events]
        assert kinds == ["accepted", "prefill", "decode"] + ["token"] * 5 \
            + ["finished"], kinds
        assert [e["token"] for e in events if e["event"] == "token"] \
            == events[-1]["tokens"] == tokens
    assert out.outcome == "finished" and out.n_tokens == 5
    assert out.ttft_s >= 0 and out.tpot_s >= 0
    assert pool.stats()["n_cancelled"] == 0


def test_http_disconnect_cancels_and_frees():
    async def run():
        _, pool, driver, fe = _http_stack()
        hold = _Hold(pool)
        driver.start()
        await fe.start()
        try:
            reader, writer, status = await _post(fe.port, {
                "model": "tiny", "prompt": _prompt(8, 17).tolist(),
                "max_new_tokens": 48, "slo_ms": 5000.0})
            assert "200" in status, status
            async for ev in _read_chunked_events(reader):
                if ev.get("event") == "token":
                    break
            writer.close()  # hang up mid-stream; the pool is held
            t0 = time.perf_counter()
            while pool.stats()["n_cancelled"] < 1 \
                    and time.perf_counter() - t0 < WAIT_S:
                await asyncio.sleep(0.005)
            hold.release()
            await asyncio.get_running_loop().run_in_executor(
                None, driver.drain, WAIT_S)
        finally:
            await fe.stop()
            driver.stop()
        return pool, fe

    pool, fe = asyncio.run(run())
    assert fe.n_disconnects == 1
    assert pool.stats()["n_cancelled"] == 1
    for inst in pool.live():
        assert inst.engine.allocator.n_live == 0
        assert inst.engine.allocator.n_reserved == 0
        assert inst.engine.kv_used_tokens == 0


def test_http_backpressure_429_with_retry_after():
    """The only slot pinned (held after its first token) and a queue
    depth of 1: of six concurrent requests one queues and five get 429
    with a positive Retry-After; once released, the queued one
    finishes."""
    async def run():
        _, pool, driver, fe = _http_stack(max_queue_depth=1, max_slots=1)
        hold = _Hold(pool)
        driver.start()
        await fe.start()
        try:
            driver.submit("tiny", _prompt(8, 29), slo_ms=5000.0,
                          max_new_tokens=48)
            await asyncio.get_running_loop().run_in_executor(
                None, hold.held.wait, WAIT_S)

            async def release_when_throttled():
                t0 = time.perf_counter()
                while fe.n_throttled < 5 and time.perf_counter() - t0 < WAIT_S:
                    await asyncio.sleep(0.005)
                hold.release()

            outs = await asyncio.wait_for(asyncio.gather(
                release_when_throttled(),
                *(http_generate("127.0.0.1", fe.port, "tiny",
                                _prompt(8, 30 + i), 32, 5000.0)
                  for i in range(6))), WAIT_S)
        finally:
            await fe.stop()
            driver.stop()
        return fe, outs[1:]

    fe, outs = asyncio.run(run())
    throttled = [o for o in outs if o.outcome == "throttled"]
    assert len(throttled) == 5
    assert all(o.retry_after_s > 0 for o in throttled)
    assert [o.outcome for o in outs].count("finished") == 1
    assert fe.n_throttled == 5


def test_http_bad_requests():
    async def run():
        _, pool, driver, fe = _http_stack()
        driver.start()
        await fe.start()
        results = []
        try:
            for body in (json.dumps({"model": "nope", "prompt": [1]}),
                         json.dumps({"model": "tiny", "prompt": []}),
                         json.dumps({"model": "tiny", "prompt": [[1, 2]]}),
                         "not json"):
                _, writer, status = await asyncio.wait_for(
                    _post(fe.port, body), WAIT_S)
                results.append(status)
                writer.close()
        finally:
            await fe.stop()
            driver.stop()
        return results

    for status in asyncio.run(run()):
        assert "400" in status, status


def test_serve_http_streams_and_stops_when_cancelled():
    """``serve_http`` on port 0 over a tiny config on the CPU: ready()
    gives the port, a request streams to ``finished``, /v1/stats answers,
    and cancelling the serving task stops the driver and the socket."""
    box = {}
    ready = threading.Event()

    def on_ready(port):
        box["port"] = port
        box["loop"] = asyncio.get_running_loop()
        box["task"] = asyncio.current_task()
        ready.set()

    t = threading.Thread(target=engine_serve.serve_http, kwargs=dict(
        port=0, max_instances=1, max_slots=2, kv_layout="paged",
        configs={"tiny": TTINY}, ready=on_ready, device="cpu"), daemon=True)
    t.start()
    assert ready.wait(timeout=WAIT_S), "serve_http never bound its port"

    async def client():
        out = await asyncio.wait_for(http_generate(
            "127.0.0.1", box["port"], "tiny", _prompt(6, 40), 4, 5000.0),
            WAIT_S)
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       box["port"])
        writer.write(b"GET /v1/stats HTTP/1.1\r\n\r\n")
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), WAIT_S)
        writer.close()
        return out, json.loads(raw.split(b"\r\n\r\n", 1)[1])

    try:
        out, stats = asyncio.run(client())
    finally:
        box["loop"].call_soon_threadsafe(box["task"].cancel)
        t.join(timeout=WAIT_S)
    assert not t.is_alive(), "serve_http did not stop"
    assert out.outcome == "finished" and out.n_tokens == 4
    assert stats["stats"]["ttft_ms_p50"] > 0
    assert stats["report"]["tiny"]["served"] >= 1
