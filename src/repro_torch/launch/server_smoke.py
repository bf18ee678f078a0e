"""End-to-end smoke of the HTTP serving front-end: the port of the
reference's ``tools/server_smoke.py``.

Boots the full push-mode stack (pool + background ``ServingDriver`` +
``PoolScheduler`` tick + asyncio ``ServingFrontend`` on an ephemeral
port) through the ``serve_http`` launcher (the same wiring
``python -m repro_torch.launch.serve --engine --serve-http`` uses, on a
tiny throwaway model so it runs in seconds) on ``--device``, then drives
it as a real HTTP client:

1. stream one request end-to-end and check the event protocol
   (``accepted`` -> ``token``* -> ``finished``, client-observed TTFT);
2. disconnect a second client mid-stream and confirm the server turned
   it into a pool-level cancellation (``/v1/stats``);
3. saturate admission with concurrent long requests and assert at least
   one ``429`` carrying a positive ``Retry-After``. Two of the twelve
   streams hold both slots (first token read) before the other ten are
   sent at once: the front-end bounces a request only when no slot is
   free and the queue is full, so a burst that lands whole before the
   driver's next step (the reference sends all twelve at once) would
   queue every request and see no ``429``.

Exits 0 on success, 1 with a traceback on any failed check. The server
runs on a daemon thread and ends with the process.

Run:  PYTHONPATH=src python -m repro_torch.launch.server_smoke
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import json
import threading
import time
from typing import List, Optional

import numpy as np

from repro_torch.config.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.engine_serve import serve_http
from repro_torch.serving.workload import _read_chunked_events, http_generate

TINY = ModelConfig(name="tiny-smoke", family="dense", n_layers=2,
                   d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                   vocab_size=97)


def _expect(ok: bool, msg) -> None:
    """A failed check (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise AssertionError(msg)


def _start_server(device) -> int:
    """serve_http on a daemon thread; returns the bound port."""
    bound: list = []
    ev = threading.Event()

    def ready(port: int) -> None:
        bound.append(port)
        ev.set()

    t = threading.Thread(
        target=serve_http,
        kwargs=dict(models=[TINY.name], port=0, slo_ms=2000.0,
                    max_instances=1, max_slots=2, kv_layout="paged",
                    max_queue_depth=2, ready=ready,
                    configs={TINY.name: TINY}, device=device),
        daemon=True)
    t.start()
    if not ev.wait(timeout=120.0):
        raise TimeoutError("server did not come up")
    return bound[0]


async def _get_stats(host: str, port: int) -> dict:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET /v1/stats HTTP/1.1\r\nHost: {host}\r\n\r\n".encode())
    await writer.drain()
    status = await reader.readline()
    _expect(b"200" in status, status)
    length = 0
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode().partition(":")
        if k.strip().lower() == "content-length":
            length = int(v.strip())
    body = await reader.readexactly(length)
    writer.close()
    return json.loads(body)


async def _open_stream(host: str, port: int):
    """Open a long generation and read up to its first token event; the
    request then holds a slot until it finishes or the client hangs up.
    Returns the connection's writer."""
    body = json.dumps({"model": TINY.name,
                       "prompt": list(range(1, 9)),
                       "max_new_tokens": 64,
                       "slo_ms": 5000.0}).encode()
    reader, writer = await asyncio.open_connection(host, port)
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    status = await reader.readline()
    _expect(b"200" in status, f"mid-stream client not admitted: {status}")
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
    async for ev in _read_chunked_events(reader):
        if ev.get("event") == "token":
            break
    return writer


async def _hang_up(writer) -> None:
    """Close a stream; mid-generation, the server must propagate a cancel
    into the pool."""
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionError, OSError):
        pass


async def _checks(host: str, port: int) -> None:
    # 1. one request end-to-end
    out = await http_generate(host, port, TINY.name,
                              np.arange(1, 9, dtype=np.int32),
                              max_new_tokens=6, slo_ms=5000.0)
    _expect(out.outcome == "finished", f"stream did not finish: {out}")
    _expect(out.n_tokens == 6, f"expected 6 tokens, got {out.n_tokens}")
    _expect(out.ttft_s >= 0, "no token event observed")
    print(f"PASS stream: 6 tokens, ttft={out.ttft_s*1000:.0f}ms")

    # 2. cancel mid-stream via disconnect
    before = await _get_stats(host, port)
    await _hang_up(await _open_stream(host, port))
    deadline = time.perf_counter() + 10.0
    while time.perf_counter() < deadline:
        stats = await _get_stats(host, port)
        if stats["frontend"]["n_disconnects"] \
                > before["frontend"]["n_disconnects"] \
                and stats["stats"]["n_cancelled"] \
                > before["stats"]["n_cancelled"]:
            break
        await asyncio.sleep(0.1)
    else:
        raise AssertionError(
            f"disconnect did not become a cancellation: {stats}")
    print(f"PASS cancel: disconnects="
          f"{stats['frontend']['n_disconnects']} "
          f"pool_cancelled={stats['stats']['n_cancelled']:.0f}")

    # 3. saturate admission -> 429 + Retry-After: both slots held, then
    #    ten more at once
    held = [await _open_stream(host, port) for _ in range(2)]
    rng = np.random.default_rng(0)
    outs = await asyncio.gather(*(
        http_generate(host, port, TINY.name,
                      rng.integers(1, TINY.vocab_size, 12).astype(np.int32),
                      max_new_tokens=48, slo_ms=5000.0,
                      abandon_after_s=20.0)
        for _ in range(10)))
    for writer in held:  # both ran to the end while the burst queued
        await _hang_up(writer)
    throttled = [o for o in outs if o.outcome == "throttled"]
    _expect(bool(throttled),
            f"no 429 under saturation: {[o.outcome for o in outs]}")
    _expect(all(o.retry_after_s > 0 for o in throttled),
            "429 without a positive Retry-After")
    _expect(any(o.outcome == "finished" for o in outs),
            "saturation starved every client")
    print(f"PASS backpressure: {len(throttled)}/10 throttled, "
          f"retry_after~{throttled[0].retry_after_s:.2f}s")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the pool runs (cuda, the default, raises "
                         "without a GPU)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    port = _start_server(args.device)
    asyncio.run(_checks("127.0.0.1", port))
    print("server smoke OK")


if __name__ == "__main__":
    main()
