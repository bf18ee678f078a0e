"""Asyncio HTTP front-end for the serving pool (docs/RUNTIME.md §11): the
port of ``repro.launch.server``, the same protocol over the port's
:class:`~repro_torch.serving.driver.ServingDriver`.

Stdlib-only (``asyncio.start_server`` + hand-rolled HTTP/1.1): the
container this repo targets ships no HTTP framework, and the protocol
surface is deliberately small —

* ``POST /v1/generate`` — JSON body
  ``{"model": str, "prompt": [int, ...], "max_new_tokens": int,
  "slo_ms": float}``; streams newline-delimited JSON events
  (``accepted``, ``prefill``, ``decode``, ``token``, ``preempted``,
  ``finished``, ``rejected``, ``cancelled``) with chunked transfer
  encoding, one chunk per event, flushed as the pool emits them.
* ``GET /v1/stats`` — pool ``stats()`` + ``report()`` as JSON.
* ``GET /healthz`` — liveness.

Two production behaviours the benchmark asserts on:

* **cancellation on disconnect** — while streaming, the handler watches
  the client socket for EOF; a client that goes away cancels its request
  through the driver, which evicts the slot and frees its blocks
  synchronously (mass disconnect frees capacity immediately).
* **backpressure** — when the pool's ``admission_headroom`` says the
  request cannot start now and the queue is past ``max_queue_depth``,
  the server answers ``429 Too Many Requests`` with a ``Retry-After``
  header derived from the calibrated per-token cost over the work queued
  ahead (``accept_all=True`` disables this — the accept-everything
  baseline the figure compares against).

Events cross from the driver thread into asyncio via
``loop.call_soon_threadsafe`` onto a per-request queue — pool listeners
stay cheap and never touch the socket.
"""
from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.serving.driver import ServingDriver

#: hard cap on request-body size (prompts are token-id lists, not text)
_MAX_BODY = 1 << 20


def _http_response(status: str, body: bytes,
                   headers: Optional[Dict[str, str]] = None) -> bytes:
    head = [f"HTTP/1.1 {status}",
            "Content-Type: application/json",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    for k, v in (headers or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _json_response(status: str, obj,
                   headers: Optional[Dict[str, str]] = None) -> bytes:
    return _http_response(status, json.dumps(obj).encode(), headers)


class ServingFrontend:
    """HTTP server over a running :class:`ServingDriver`.

    The frontend does not own the driver's lifecycle — callers start and
    stop driver and frontend separately (``launch.engine_serve.serve_http``
    shows the full wiring)::

        with ServingDriver(pool, on_tick=sched.tick) as driver:
            fe = ServingFrontend(driver, port=0)
            await fe.start()
            ...
            await fe.stop()
    """

    def __init__(self, driver: ServingDriver, host: str = "127.0.0.1",
                 port: int = 8808, backpressure: bool = True,
                 max_queue_depth: int = 8,
                 default_slo_ms: float = 1000.0,
                 default_max_new: int = 8):
        self.driver = driver
        self.host = host
        self.port = port          # 0 = ephemeral; real port set by start()
        #: False = accept-everything baseline: every request queues, no
        #: 429 is ever returned (the policy the figure shows collapsing)
        self.backpressure = backpressure
        #: queued requests tolerated per model before a non-admissible
        #: request is bounced with 429 + Retry-After
        self.max_queue_depth = max_queue_depth
        self.default_slo_ms = default_slo_ms
        self.default_max_new = default_max_new
        self.n_streamed = 0
        self.n_throttled = 0
        self.n_disconnects = 0
        self._server: Optional[asyncio.base_events.Server] = None

    # ---- lifecycle -------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        async with self._server:
            await self._server.serve_forever()

    # ---- request plumbing ------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            method, path, body = await self._read_request(reader)
            if method == "GET" and path == "/healthz":
                writer.write(_json_response("200 OK", {"ok": True}))
            elif method == "GET" and path == "/v1/stats":
                writer.write(_json_response("200 OK", {
                    "stats": self.driver.stats(),
                    "report": self.driver.report(),
                    "frontend": {"n_streamed": self.n_streamed,
                                 "n_throttled": self.n_throttled,
                                 "n_disconnects": self.n_disconnects}}))
            elif method == "POST" and path == "/v1/generate":
                await self._generate(reader, writer, body)
            else:
                writer.write(_json_response(
                    "404 Not Found", {"error": f"no route {path}"}))
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass  # client went away / malformed request line
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader
                            ) -> Tuple[str, str, bytes]:
        line = await reader.readline()
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            raise ValueError("malformed request line")
        method, path = parts[0].upper(), parts[1]
        length = 0
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, val = h.decode("latin-1").partition(":")
            if name.strip().lower() == "content-length":
                length = min(int(val.strip()), _MAX_BODY)
        body = await reader.readexactly(length) if length else b""
        return method, path, body

    def _parse_generate(self, body: bytes):
        req = json.loads(body.decode() or "{}")
        model = req.get("model")
        if model not in self.driver.pool.configs:
            raise KeyError(
                f"unknown model {model!r}; pool serves "
                f"{sorted(self.driver.pool.configs)}")
        prompt = np.asarray(req.get("prompt", []), np.int32)
        if prompt.ndim != 1 or len(prompt) == 0:
            raise ValueError("prompt must be a non-empty list of token ids")
        max_new = int(req.get("max_new_tokens", self.default_max_new))
        slo_ms = float(req.get("slo_ms", self.default_slo_ms))
        return model, prompt, max_new, slo_ms

    # ---- streaming generate ----------------------------------------------
    async def _generate(self, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter,
                        body: bytes) -> None:
        try:
            model, prompt, max_new, slo_ms = self._parse_generate(body)
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            writer.write(_json_response("400 Bad Request",
                                        {"error": str(e)}))
            return
        if self.backpressure:
            head = self.driver.admission_headroom(model, len(prompt),
                                                  max_new)
            if not head["admissible_now"] \
                    and head["queue_depth"] >= self.max_queue_depth:
                self.n_throttled += 1
                retry = head["retry_after_s"]
                writer.write(_json_response(
                    "429 Too Many Requests",
                    {"error": "admission backlog", "retry_after_s": retry,
                     "queue_depth": head["queue_depth"],
                     "backlog_tokens": head["backlog_tokens"]},
                    headers={"Retry-After": f"{retry:.3f}"}))
                return

        loop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()

        def listener(ev: dict) -> None:
            # driver thread -> asyncio loop; put_nowait is loop-internal
            loop.call_soon_threadsafe(events.put_nowait, ev)

        # submit + listener registration under one lock acquisition so
        # no event can fire before the listener is attached
        with self.driver.lock:
            try:
                rid = self.driver.pool.submit(
                    model, prompt, slo_ms=slo_ms, max_new_tokens=max_new)
            except ValueError as e:  # never-fitting shape
                writer.write(_json_response("400 Bad Request",
                                            {"error": str(e)}))
                return
            self.driver.pool.add_listener(rid, listener)

        writer.write((
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: application/x-ndjson\r\n"
            "Transfer-Encoding: chunked\r\n"
            "Connection: close\r\n\r\n").encode())
        self._write_chunk(writer, {"event": "accepted", "request_id": rid})
        await writer.drain()

        # the body was fully consumed, so any further read returns only
        # on EOF — the client hanging up mid-stream (an abrupt RST is
        # the same signal as a clean close)
        async def eof_watch() -> bytes:
            try:
                return await reader.read(1)
            except (ConnectionError, OSError):
                return b""

        eof_task = asyncio.ensure_future(eof_watch())
        get_task: Optional[asyncio.Task] = None
        try:
            while True:
                get_task = asyncio.ensure_future(events.get())
                done, _ = await asyncio.wait(
                    {get_task, eof_task},
                    return_when=asyncio.FIRST_COMPLETED)
                if eof_task in done and get_task not in done:
                    get_task.cancel()
                    self.n_disconnects += 1
                    self.driver.cancel(rid)
                    return
                ev = get_task.result()
                self._write_chunk(writer, ev)
                await writer.drain()
                if ev["event"] in ("finished", "cancelled", "rejected"):
                    self.n_streamed += 1
                    self._write_final_chunk(writer)
                    await writer.drain()
                    return
        except (ConnectionError, OSError):
            self.n_disconnects += 1
            self.driver.cancel(rid)
        finally:
            self.driver.remove_listener(rid)
            for t in (eof_task, get_task):
                if t is not None and not t.done():
                    t.cancel()

    @staticmethod
    def _write_chunk(writer: asyncio.StreamWriter, obj) -> None:
        data = (json.dumps(obj) + "\n").encode()
        writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    @staticmethod
    def _write_final_chunk(writer: asyncio.StreamWriter) -> None:
        writer.write(b"0\r\n\r\n")
