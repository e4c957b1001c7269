"""Asyncio HTTP/SSE serving frontend over the continuous batcher (port of
``repro.launch.server``; same routes, wire format and client helpers).

  * ``POST /v1/generate``: a JSON request (prompt token ids, ``max_new``,
    optional ``priority``, ``ttft_slo_ms``, ``tpot_slo_ms``) answered as a
    Server-Sent Events stream: one ``token`` event per decode segment, then
    a ``done`` event with the whole output, or an ``error`` event. With
    ``"stream": false`` one JSON response instead.
  * ``POST /v1/cancel/<rid>``, or closing the connection, aborts the
    request: the batcher retires its slot between segments and its pages
    return to the pool (prefix-cache refcounts respected).
  * slow-consumer backpressure: each request's tokens flow through a
    bounded bridge; a consumer ``queue_cap`` tokens behind pauses its slot
    (it keeps its pages) until the consumer drains.
  * admission control sheds with 429 and ``Retry-After``; ``drain()``
    answers new work with 503, completes what is in flight, then stops the
    engine thread.
  * a supervised engine thread: an exception escaping ``step()`` spills
    every active slot back to the queue and restarts the loop, up to
    ``max_restarts`` times; past that every stream ends with an ``error``.
    ``GET /v1/health`` reports the counters.

Threading: the batcher runs on ONE engine thread (``EngineRunner``). On the
card that thread sets the device and captures the batcher's two CUDA
graphs before ``start`` returns, and replays them on the stream it captured
on (``ContinuousBatcher.stream``); no torch call runs on the event loop's
thread, which reaches the engine only through host-side calls (``submit``,
``cancel``, ``pause``, ``resume``) and the per-request ``TokenStream``
bridges. The HTTP layer is stdlib only (HTTP/1.1, ``connection: close``);
``docs/api.md`` gives the wire format.

Run (the reduced stablelm-1.6b on the card; ``--full`` for its published
widths, ``--device cpu`` for the plain versions):

    python -m repro_torch.launch.server --port 8080
    python -m repro_torch.launch.server --full --prompt-len 512 \\
        --num-slots 8 --seg-len 16 --prefix-cache
    python -m repro_torch.launch.server --device cpu --ckpt-dir CKPT
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import json
import threading
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.serve import (PRIORITY_CLASSES, AdmissionError,
                                      ContinuousBatcher, Request, _not_ported,
                                      add_model_args, cli_device, load_model)
from repro_torch.nn import cache as KVC

DEFAULT_QUEUE_CAP = 256      # tokens a consumer may fall behind before pause


# ---------------------------------------------------------------------------
# Engine thread <-> event loop bridge
# ---------------------------------------------------------------------------

class TokenStream:
    """Bounded bridge carrying ONE request's tokens from the engine thread
    to an event-loop consumer.

    The engine pushes each decode segment's tokens under a lock and wakes
    the loop via ``call_soon_threadsafe``. When the consumer falls ``cap``
    tokens behind, ``on_pause(rid)`` fires (the batcher stops decoding the
    slot); the next drain fires ``on_resume(rid)``. ``finish`` marks the
    stream complete and carries the finished ``Request``.
    """

    def __init__(self, loop: asyncio.AbstractEventLoop, rid: int, cap: int,
                 on_pause=None, on_resume=None):
        self.loop, self.rid, self.cap = loop, rid, cap
        self.on_pause, self.on_resume = on_pause, on_resume
        self._buf: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._ready = asyncio.Event()
        self.req: Optional[Request] = None
        self.done = False
        self.paused = False
        self.pauses = 0              # times backpressure engaged

    # ---- engine-thread side ------------------------------------------
    def push(self, toks: List[int]) -> None:
        with self._lock:
            self._buf.extend(toks)
            engage = not self.paused and len(self._buf) >= self.cap
            if engage:
                self.paused = True
                self.pauses += 1
        if engage and self.on_pause is not None:
            self.on_pause(self.rid)
        self._wake()

    def finish(self, req: Request) -> None:
        with self._lock:
            self.req = req
            self.done = True
        self._wake()

    def _wake(self) -> None:
        try:
            self.loop.call_soon_threadsafe(self._ready.set)
        except RuntimeError:         # loop already closed (shutdown race)
            pass

    # ---- event-loop side ---------------------------------------------
    async def next_batch(self):
        """Wait for progress; returns ``(tokens, done)``, draining the whole
        buffer (and resuming a paused slot once drained)."""
        while True:
            with self._lock:
                toks = list(self._buf)
                self._buf.clear()
                done = self.done
                resume = self.paused and bool(toks)
                if resume:
                    self.paused = False
                self._ready.clear()
            if resume and self.on_resume is not None:
                self.on_resume(self.rid)
            if toks or done:
                return toks, done
            await self._ready.wait()


def _weak_method(method):
    """A callable that calls ``method`` while its object lives: the batcher
    holds its runner's token callback this way, so the two make no cycle
    and dropping the server frees the batcher's pool and graphs at once."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        fn = ref()
        if fn is not None:
            fn(*args)
    return call


class EngineRunner:
    """Owns the engine thread: a loop of ``batcher.step()`` calls that
    routes each request's tokens into its ``TokenStream`` and finishes
    streams as requests retire. Idles on an event when there is no work;
    ``stop()`` drains everything in flight before the thread exits.

    The segments' draws come from the batcher's own ``generator`` (the
    port's ``step()`` takes no key). On the card the thread sets the
    device and, when the batcher replays graphs, captures them before
    ``start`` returns (a failed capture raises from ``start``); the loop
    then replays them on the batcher's stream, from this thread only.

    Supervision: an exception escaping ``step()`` is caught; the runner
    spills every active slot back to the queue (``recover()``: partial
    output kept, no token repeated) and steps on, up to ``max_restarts``
    times. Past that it gives up: every queued and active request is
    errored and its stream finished (``abort_all``). An exception of
    ``fatal_types`` ends the thread at once with neither (a dead process
    cannot answer its clients; a router fails its work over)."""

    def __init__(self, batcher: ContinuousBatcher, max_restarts: int = 3,
                 fatal_types: tuple = (), name: str = "engine"):
        self.cb = batcher
        self.max_restarts = max_restarts
        self.fatal_types = fatal_types
        self._streams: Dict[int, TokenStream] = {}
        self._orphans: Dict[int, List[List[int]]] = {}
        self._slock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._main, name=name,
                                        daemon=True)
        self.served = 0
        self.crashes = 0             # engine-thread exceptions caught
        self.restarts = 0            # successful supervisor recoveries
        self.last_error: Optional[str] = None
        self.gave_up = False         # crash budget exhausted; engine dead
        self.died = False            # fatal exception: the worker is dead
        batcher.token_cb = _weak_method(self._on_tokens)

    def start(self) -> None:
        """Start the engine thread; returns once it is ready to step (its
        graphs captured on the card). Raises if that failed."""
        self._thread.start()
        self._ready.wait()
        if self._start_error is not None:
            self._thread.join()
            raise RuntimeError("the engine thread failed to start: "
                               f"{self._start_error!r}") from self._start_error

    def wake(self) -> None:
        self._work.set()

    def attach(self, rid: int, stream: TokenStream) -> None:
        """Register the stream for ``rid``. Tokens emitted between
        ``submit`` and this call were stashed and are replayed here in
        order: nothing is lost to the registration race."""
        with self._slock:
            for toks in self._orphans.pop(rid, []):
                stream.push(toks)
            self._streams[rid] = stream
        self.wake()

    def cancel(self, rid: int) -> bool:
        ok = self.cb.cancel(rid)
        self.wake()
        return ok

    def stop(self, timeout: Optional[float] = None) -> None:
        """Drain, then stop: the engine steps until queue and slots are
        empty, then the thread exits."""
        self._stop.set()
        self.wake()
        if self._thread.is_alive():
            self._thread.join(timeout)

    # ---- engine thread ------------------------------------------------
    def _on_tokens(self, req: Request, toks: List[int]) -> None:
        with self._slock:
            stream = self._streams.get(req.rid)
            if stream is None:
                self._orphans.setdefault(req.rid, []).append(list(toks))
                return
            stream.push(toks)

    def _finish(self, req: Request) -> None:
        with self._slock:
            stream = self._streams.pop(req.rid, None)
            self._orphans.pop(req.rid, None)
        self.served += 1
        if stream is not None:
            stream.finish(req)

    def _fail_inflight(self, msg: str) -> None:
        """Terminal failure: error and finish every request the engine will
        never serve, streams attached for requests the batcher no longer
        knows included (nothing may hang on a dead engine)."""
        self.gave_up = True
        for req in self.cb.abort_all(msg):
            self._finish(req)
        with self._slock:
            leftover = list(self._streams.items())
            self._streams.clear()
            self._orphans.clear()
        for rid, stream in leftover:
            req = Request(rid, np.zeros(0, np.int64), 0)
            req.error = msg
            stream.finish(req)

    def _prepare(self) -> None:
        """On this thread: the card's device, and the batcher's graphs."""
        if self.cb.device.type == "cuda":
            torch.cuda.set_device(self.cb.device)
        self.cb.capture()

    def _main(self) -> None:
        try:
            self._prepare()
        except BaseException as e:   # noqa: BLE001 -- raised from start()
            self._start_error = e
            return
        finally:
            self._ready.set()
        while True:
            if not self.cb.has_work():
                if self._stop.is_set():
                    break
                self._work.wait(0.05)
                self._work.clear()
                continue
            d0 = self.cb.eng.dispatches
            try:
                finished = self.cb.step(strict=False)
            except Exception as e:   # noqa: BLE001 -- supervisor boundary
                self.crashes += 1
                self.last_error = f"{type(e).__name__}: {e}"
                if isinstance(e, self.fatal_types):
                    self.died = True
                    return
                if self.crashes > self.max_restarts:
                    self._fail_inflight(
                        f"engine failed after {self.crashes} crashes "
                        f"(last: {self.last_error})")
                    break
                self.cb.recover()    # spill and requeue every active slot
                self.restarts += 1
                continue
            for req in finished:
                self._finish(req)
            if not finished and self.cb.eng.dispatches == d0:
                # every active slot paused (backpressure): wait for a
                # resume or a cancel instead of spinning on empty steps
                self._work.wait(0.005)
                self._work.clear()


# ---------------------------------------------------------------------------
# HTTP plumbing (stdlib asyncio streams; HTTP/1.1, connection: close)
# ---------------------------------------------------------------------------

async def _read_request(reader):
    """Parse one HTTP request: (method, path, headers, body) or None."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1").split()
    if len(parts) < 2:
        return None
    method, path = parts[0], parts[1]
    headers = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", 0) or 0)
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body


def _response(status: str, obj, extra=()) -> bytes:
    body = json.dumps(obj).encode()
    head = [f"HTTP/1.1 {status}", "content-type: application/json",
            f"content-length: {len(body)}", "connection: close"]
    head += [f"{k}: {v}" for k, v in extra]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _sse_head(rid: int) -> bytes:
    return (f"HTTP/1.1 200 OK\r\ncontent-type: text/event-stream\r\n"
            f"cache-control: no-cache\r\nconnection: close\r\n"
            f"x-request-id: {rid}\r\n\r\n").encode()


def _sse_event(event: str, obj) -> bytes:
    return f"event: {event}\ndata: {json.dumps(obj)}\n\n".encode()


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

class InferenceServer:
    """Asyncio HTTP/SSE frontend over one ``ContinuousBatcher``.

    Sampler settings are static per engine: a request may state
    ``temperature`` / ``top_k``, but values other than the engine's are
    rejected with 400. Requests may name an ``aux`` conditioning input as
    in JAX; the port registers none yet (ROADMAP A6), so any name is
    unknown and rejected."""

    def __init__(self, batcher: ContinuousBatcher, *, host: str = "127.0.0.1",
                 port: int = 0, queue_cap: int = DEFAULT_QUEUE_CAP,
                 max_restarts: int = 3):
        if getattr(batcher, "is_router", False):
            _not_ported("serving through the disaggregation router", "A7")
        self.cb = batcher
        self.runner = EngineRunner(batcher, max_restarts=max_restarts)
        self.host, self._want_port = host, port
        self.queue_cap = queue_cap
        self.backpressure_pauses = 0     # slow-consumer pause events
        self.draining = False
        self.port: Optional[int] = None
        self._srv = None
        self._loop = None

    # ---- lifecycle ----------------------------------------------------
    async def start(self) -> "InferenceServer":
        """Start the engine thread (on the card: its graphs captured before
        this returns), then listen."""
        self._loop = asyncio.get_running_loop()
        await self._loop.run_in_executor(None, self.runner.start)
        self._srv = await asyncio.start_server(self._handle, self.host,
                                               self._want_port)
        self.port = self._srv.sockets[0].getsockname()[1]
        return self

    async def drain(self) -> None:
        """Graceful shutdown: new ``/v1/generate`` requests get 503, every
        queued and active request runs to completion, then the engine
        thread stops."""
        self.draining = True
        await self._loop.run_in_executor(None, self.runner.stop)

    async def aclose(self) -> None:
        await self.drain()
        if self._srv is not None:
            self._srv.close()
            await self._srv.wait_closed()
            self._srv = None     # it holds our handler: no cycle left

    # ---- request handling ---------------------------------------------
    async def _handle(self, reader, writer):
        try:
            parsed = await _read_request(reader)
            if parsed is None:
                return
            method, path, _, body = parsed
            if method == "GET" and path == "/v1/health":
                writer.write(_response("200 OK", self.stats()))
                await writer.drain()
            elif method == "POST" and path.startswith("/v1/cancel/"):
                try:
                    rid = int(path.rsplit("/", 1)[1])
                except ValueError:
                    writer.write(_response("400 Bad Request",
                                           {"error": "bad request id"}))
                else:
                    ok = self.runner.cancel(rid)
                    writer.write(_response(
                        "200 OK", {"request_id": rid, "cancelled": ok}))
                await writer.drain()
            elif method == "POST" and path == "/v1/generate":
                await self._generate(reader, writer, body)
            else:
                writer.write(_response("404 Not Found",
                                       {"error": f"no route {path}"}))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def stats(self) -> dict:
        """``GET /v1/health``: queue depth, slot and page headroom, pool
        bytes, drain state and the robustness counters (preemptions, SLO
        cancels, sheds, supervisor crashes and restarts)."""
        cb = self.cb
        active = int(cb.active.sum())
        return {
            "active_slots": active,
            "free_slots": cb.num_slots - active,
            "num_slots": cb.num_slots,
            "queued": len(cb.queue),
            "free_pages": len(cb.free_pages),
            "total_pages": cb.total_pages,
            **cb.kv_stats(),
            "served": self.runner.served,
            "cancelled": cb.cancelled_count,
            "backpressure_pauses": self.backpressure_pauses,
            "draining": self.draining,
            "max_queue": cb.max_queue,
            "shed": cb.shed_count,
            "preemptions": cb.preemptions,
            "restores": cb.restores,
            "deadline_cancels": cb.deadline_cancels,
            "engine_crashes": self.runner.crashes,
            "engine_restarts": self.runner.restarts,
            "engine_alive": (self.runner._thread.is_alive()
                             and not self.runner.gave_up),
        }

    def _on_pause(self, rid: int) -> None:
        self.backpressure_pauses += 1
        self.cb.pause(rid)

    def _on_resume(self, rid: int) -> None:
        self.cb.resume(rid)
        self.runner.wake()

    def _validate(self, payload) -> Optional[str]:
        if not isinstance(payload, dict):
            return "body must be a JSON object"
        prompt = payload.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            return "prompt must be a non-empty list of token ids"
        vocab = self.cb.dbm.cfg.vocab_size
        if not all(0 <= t < vocab for t in prompt):
            return f"prompt token ids must be in [0, {vocab})"
        if len(prompt) > self.cb.max_prompt:
            return (f"prompt length {len(prompt)} exceeds max_prompt "
                    f"{self.cb.max_prompt}")
        max_new = payload.get("max_new", 16)
        if not isinstance(max_new, int) or max_new < 1:
            return "max_new must be a positive integer"
        if len(prompt) + max_new > self.cb.max_len:
            return (f"prompt + max_new = {len(prompt) + max_new} exceeds "
                    f"max_len {self.cb.max_len}")
        eng = self.cb.eng
        for k, have in (("temperature", eng.temperature),
                        ("top_k", eng.top_k)):
            want = payload.get(k)
            if want is not None and float(want) != float(have):
                return (f"{k}={want} does not match this server's engine "
                        f"({k}={have}); sampler settings are static per "
                        "compiled engine — restart the server to change "
                        "them")
        aux = payload.get("aux")
        if aux is not None:
            return f"unknown aux reference {aux!r} (registered: [])"
        prio = payload.get("priority")
        if prio is not None and not (
                isinstance(prio, int) and not isinstance(prio, bool)
                or prio in PRIORITY_CLASSES):
            return (f"priority must be an int or one of "
                    f"{sorted(PRIORITY_CLASSES)}, got {prio!r}")
        for k in ("ttft_slo_ms", "tpot_slo_ms"):
            v = payload.get(k)
            if v is not None and not (isinstance(v, (int, float))
                                      and not isinstance(v, bool) and v > 0):
                return f"{k} must be a positive number, got {v!r}"
        return None

    async def _generate(self, reader, writer, body):
        retry = f"{self.cb.retry_after_hint():.1f}"
        if self.draining or self.runner.gave_up:
            why = "server draining" if self.draining else "engine failed"
            writer.write(_response("503 Service Unavailable",
                                   {"error": why,
                                    "retry_after_s": float(retry)},
                                   extra=[("retry-after", retry)]))
            await writer.drain()
            return
        try:
            payload = json.loads(body or b"null")
        except json.JSONDecodeError:
            payload = None
        err = self._validate(payload)
        if err is not None:
            writer.write(_response("400 Bad Request", {"error": err}))
            await writer.drain()
            return
        ttft = payload.get("ttft_slo_ms")
        tpot = payload.get("tpot_slo_ms")
        try:
            rid = self.cb.submit(
                np.asarray(payload["prompt"], np.int64),
                payload.get("max_new", 16),
                priority=payload.get("priority", "standard"),
                ttft_slo_s=ttft / 1e3 if ttft is not None else None,
                tpot_slo_s=tpot / 1e3 if tpot is not None else None)
        except AdmissionError as e:
            retry = f"{e.retry_after:.1f}"
            writer.write(_response("429 Too Many Requests",
                                   {"error": str(e),
                                    "retry_after_s": float(retry)},
                                   extra=[("retry-after", retry)]))
            await writer.drain()
            return
        except ValueError as e:
            writer.write(_response("400 Bad Request", {"error": str(e)}))
            await writer.drain()
            return
        stream = TokenStream(self._loop, rid, self.queue_cap,
                             on_pause=self._on_pause,
                             on_resume=self._on_resume)
        self.runner.attach(rid, stream)
        if payload.get("stream", True):
            await self._stream_sse(reader, writer, rid, stream)
        else:
            await self._respond_once(writer, rid, stream)

    @staticmethod
    def _final_payload(rid: int, req: Request) -> dict:
        out = {"request_id": rid, "ids": list(req.out), "n": len(req.out),
               "cancelled": bool(req.cancelled)}
        if req.ttft is not None:
            out["ttft_ms"] = round(req.ttft * 1e3, 3)
        out["preempted"] = req.preempt_count
        if req.deadline_blown:
            out["deadline_blown"] = True
        return out

    async def _respond_once(self, writer, rid: int, stream: TokenStream):
        done = False
        while not done:
            _, done = await stream.next_batch()
        req = stream.req
        if req.error:
            # deadline-blown or failed requests deliver their partial
            # output beside the error
            payload = dict(self._final_payload(rid, req), error=req.error)
            writer.write(_response("503 Service Unavailable", payload))
        else:
            writer.write(_response("200 OK", self._final_payload(rid, req)))
        await writer.drain()

    async def _stream_sse(self, reader, writer, rid: int,
                          stream: TokenStream):
        writer.write(_sse_head(rid))
        await writer.drain()
        # reads nothing in normal operation: completes only when the client
        # closes or resets the connection mid-stream -> cancel the request
        monitor = asyncio.ensure_future(reader.read())
        offset, done, disconnected = 0, False, False
        try:
            while not done:
                getter = asyncio.ensure_future(stream.next_batch())
                await asyncio.wait({getter, monitor},
                                   return_when=asyncio.FIRST_COMPLETED)
                if monitor.done() and not disconnected:
                    disconnected = True
                    self.runner.cancel(rid)
                # woken by the monitor alone: the engine finishes the
                # stream once the cancel lands
                toks, done = await getter
                if toks and not disconnected:
                    try:
                        writer.write(_sse_event("token", {
                            "request_id": rid, "ids": toks,
                            "offset": offset}))
                        await writer.drain()
                    except (ConnectionResetError, BrokenPipeError):
                        disconnected = True
                        self.runner.cancel(rid)
                offset += len(toks)
            req = stream.req
            if not disconnected:
                if req.error:
                    writer.write(_sse_event("error", dict(
                        self._final_payload(rid, req), error=req.error)))
                else:
                    writer.write(_sse_event("done",
                                            self._final_payload(rid, req)))
                await writer.drain()
        finally:
            monitor.cancel()


# ---------------------------------------------------------------------------
# Minimal async client (tests, the load replay)
# ---------------------------------------------------------------------------

async def _read_status_headers(reader):
    status = (await reader.readline()).decode("latin-1").split()
    code = int(status[1]) if len(status) > 1 else 0
    headers = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return code, headers


async def _close(writer) -> None:
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionError, OSError):
        pass


async def request_json(host: str, port: int, method: str, path: str,
                       payload=None, *, return_headers: bool = False):
    """One JSON request/response roundtrip -> (status_code, object), plus
    the response-header dict when ``return_headers`` is set."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = b"" if payload is None else json.dumps(payload).encode()
        writer.write((f"{method} {path} HTTP/1.1\r\nhost: {host}\r\n"
                      f"content-type: application/json\r\n"
                      f"content-length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        code, headers = await _read_status_headers(reader)
        n = int(headers.get("content-length", 0) or 0)
        raw = await reader.readexactly(n) if n else await reader.read()
        obj = json.loads(raw) if raw else None
        return (code, obj, headers) if return_headers else (code, obj)
    finally:
        await _close(writer)


async def sse_events(reader):
    """Async generator over SSE ``(event, data)`` pairs until EOF."""
    event, data = None, []
    while True:
        line = await reader.readline()
        if not line:
            return
        line = line.decode().rstrip("\n").rstrip("\r")
        if line.startswith("event:"):
            event = line[6:].strip()
        elif line.startswith("data:"):
            data.append(line[5:].strip())
        elif not line and event is not None:
            yield event, json.loads("\n".join(data) or "null")
            event, data = None, []


async def stream_generate(host: str, port: int, prompt, max_new: int, *,
                          aux: Optional[str] = None,
                          cancel_after: Optional[int] = None,
                          slow_consumer_s: float = 0.0,
                          priority=None, ttft_slo_ms=None, tpot_slo_ms=None,
                          abort_after: Optional[int] = None) -> dict:
    """Stream one request; returns the reassembled output and its timing.

    ``cancel_after=N`` sends ``POST /v1/cancel/<rid>`` once N tokens have
    arrived; ``abort_after=N`` instead closes the connection with no cancel
    call (the server's disconnect monitor must notice). ``slow_consumer_s``
    sleeps between event reads. ``priority`` / ``ttft_slo_ms`` /
    ``tpot_slo_ms`` pass through to the scheduler. Returns a dict: ids,
    request_id, events (count), token_times (monotonic stamps per token
    event), token_counts, final (the done/error payload), status,
    submit_t, retry_after (seconds, on 429/503), aborted.
    """
    t0 = time.monotonic()
    payload = {"prompt": [int(t) for t in prompt], "max_new": int(max_new),
               "stream": True}
    for k, v in (("aux", aux), ("priority", priority),
                 ("ttft_slo_ms", ttft_slo_ms), ("tpot_slo_ms", tpot_slo_ms)):
        if v is not None:
            payload[k] = v
    body = json.dumps(payload).encode()
    reader, writer = await asyncio.open_connection(host, port)
    result = {"ids": [], "request_id": None, "events": 0, "final": None,
              "token_times": [], "token_counts": [], "status": None,
              "submit_t": t0, "retry_after": None, "aborted": False}
    try:
        writer.write((f"POST /v1/generate HTTP/1.1\r\nhost: {host}\r\n"
                      f"content-type: application/json\r\n"
                      f"content-length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        code, headers = await _read_status_headers(reader)
        result["status"] = code
        if code != 200:
            if "retry-after" in headers:
                result["retry_after"] = float(headers["retry-after"])
            n = int(headers.get("content-length", 0) or 0)
            raw = await reader.readexactly(n) if n else b""
            result["final"] = json.loads(raw) if raw else None
            return result
        result["request_id"] = int(headers.get("x-request-id", -1))
        cancelled_sent = False
        async for event, data in sse_events(reader):
            result["events"] += 1
            if event == "token":
                if data["offset"] != len(result["ids"]):
                    raise RuntimeError("SSE token events arrived out of "
                                       f"order: offset {data['offset']} "
                                       f"after {len(result['ids'])} tokens")
                result["ids"].extend(data["ids"])
                result["token_times"].append(time.monotonic())
                result["token_counts"].append(len(data["ids"]))
                if (abort_after is not None
                        and len(result["ids"]) >= abort_after):
                    result["aborted"] = True   # hard disconnect, no call
                    return result
                if (cancel_after is not None and not cancelled_sent
                        and len(result["ids"]) >= cancel_after):
                    cancelled_sent = True
                    await request_json(host, port, "POST",
                                       f"/v1/cancel/{result['request_id']}")
                if slow_consumer_s:
                    await asyncio.sleep(slow_consumer_s)
            elif event in ("done", "error"):
                result["final"] = data
                break
        return result
    finally:
        await _close(writer)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def build_batcher_from_args(args):
    """(dbm, params, batcher) from ``add_server_args``'s arguments: the
    model of ``serve.load_model`` (its blocks from ``--ckpt-dir`` where
    given) behind a ``ContinuousBatcher`` on ``args.device``."""
    if args.disagg:
        _not_ported("disaggregated serving (--disagg)", "A7")
    if args.conditioned:
        _not_ported("conditioned requests (--conditioned)", "A6")
    device = cli_device(args.device)
    _, dbm, params, gen = load_model(args, device)
    cb = ContinuousBatcher(
        dbm, params, num_slots=args.num_slots, page_size=args.page_size,
        max_prompt=args.prompt_len, max_len=args.prompt_len + args.max_new,
        seg_len=args.seg_len, temperature=args.temperature, top_k=args.top_k,
        precision=args.precision, kv_dtype=args.kv_dtype, impl=args.impl,
        prefill=args.prefill,
        chunk_size=min(args.chunk_size, max(args.prompt_len, 1)),
        prefix_cache=args.prefix_cache, max_queue=args.max_queue,
        shed_below_pages=args.shed_below_pages, generator=gen)
    return dbm, params, cb


def add_server_args(ap: argparse.ArgumentParser) -> None:
    add_model_args(ap)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--seg-len", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=64)
    ap.add_argument("--prefill", choices=("chunked", "per-token"),
                    default="chunked")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--kv-dtype", default=None,
                    choices=("int8", "bf16", "fp32", "auto"),
                    help="KV pool storage dtype (default: the precision "
                         "policy's)")
    ap.add_argument("--impl", default="kernels", choices=KVC.IMPLS,
                    help="kernels: the Hopper kernels; ref: their plain "
                         "PyTorch versions")
    ap.add_argument("--queue-cap", type=int, default=DEFAULT_QUEUE_CAP,
                    help="tokens a slow consumer may fall behind before "
                         "its slot is paused (backpressure)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission control: shed (429 + Retry-After) when "
                         "the backlog at >= the request's priority reaches "
                         "this depth (default: unbounded)")
    ap.add_argument("--shed-below-pages", type=int, default=0,
                    help="admission control: shed batch-class requests "
                         "while free pages are below this threshold")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serving (not ported: ROADMAP A7)")
    ap.add_argument("--conditioned", action="store_true",
                    help="named conditioning inputs (not ported: ROADMAP "
                         "A6)")


async def _serve_forever(args):
    _, _, cb = build_batcher_from_args(args)
    server = InferenceServer(cb, host=args.host, port=args.port,
                             queue_cap=args.queue_cap)
    await server.start()
    print(f"serving on http://{server.host}:{server.port}  "
          f"(slots={cb.num_slots}, pool={cb.total_pages} pages, "
          f"{cb.device}; POST /v1/generate, GET /v1/health)", flush=True)
    try:
        while True:
            await asyncio.sleep(3600)
    except asyncio.CancelledError:
        pass
    finally:
        print("draining ...", flush=True)
        await server.aclose()
        print("drained; bye", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    add_server_args(ap)
    args = ap.parse_args(argv)
    try:
        asyncio.run(_serve_forever(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
