"""HTTP ingress proxy (asyncio data plane).

Counterpart of python/ray/serve/_private/proxy.py (HTTPProxy :761): an
actor that serves HTTP on an asyncio event loop (the role uvicorn plays
in the reference — one loop holds ANY number of in-flight requests, no
thread-per-request), longest-prefix-matches the request path against
application route prefixes (kept fresh via the controller's long-poll
'routes' key), and forwards to the app's ingress deployment through a
DeploymentHandle.  JSON in / JSON out; a request carrying
``Accept: text/event-stream`` or ``X-Serve-Stream: 1`` gets a CHUNKED
response that flushes each item the deployment's generator yields — the
streaming-token path for LLM serving.  ``X-Serve-Stream: 1`` renders
one JSON document per line (application/jsonl); ``Accept:
text/event-stream`` renders Server-Sent Events (``data: <json>``
frames, terminated by ``data: [DONE]``).  A client disconnect
mid-stream propagates to the replica (Replica.cancel_stream) so the
engine aborts the generation instead of decoding for nobody.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import traceback
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import ray_tpu_torch
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter

LISTEN_TIMEOUT_S = 10.0
DATA_PLANE_TIMEOUT_S = 60.0

_STREAM_TOKENS = Counter(
    "ray_tpu_serve_stream_tokens_total",
    "Items streamed to clients through the serve proxies.",
    tag_keys=("proxy",))
_STREAM_DISCONNECTS = Counter(
    "ray_tpu_serve_stream_disconnects_total",
    "Client disconnects observed mid-stream (each also cancels the "
    "replica-side generator).",
    tag_keys=("proxy",))


def _hget(headers: Dict[str, str], name: str, default: str = "") -> str:
    """Case-insensitive header lookup over the original-cased dict."""
    for k, v in headers.items():
        if k.lower() == name:
            return v
    return default


def mint_request_trace(headers: Dict[str, str]):
    """Request-journey trace context for one ingress request: adopt the
    incoming ``X-Serve-Trace`` header (``<trace_id>[:<span_id>]``) or
    mint a fresh trace.  Returns (trace_id, parent_span_id,
    root_span_id) — the root span id is pre-allocated so every
    downstream span (replica, engine phases) can parent under it before
    the root itself is recorded at request end — or None when
    RAY_TPU_SERVE_TRACE is off.  Shared by the HTTP, gRPC and frame
    ingresses so all three speak the same header."""
    if not tracing.serve_trace_enabled():
        return None
    trace_id, parent = tracing.mint_serve_trace(
        _hget(headers, "x-serve-trace"))
    return (trace_id, parent, tracing.new_span_id())


def record_request_span(trace, start: float, *, proxy: str, route: str,
                        method: str, status: str = "ok",
                        items: int = 0) -> None:
    """Record the root ``serve.request`` span for one ingress request
    (forced: the proxy process need not have global tracing enabled —
    the serve gate already said yes).  The per-process clock offset
    rides along so offline reassembly can align monotonic-stamped
    engine data with these wall-clock spans."""
    if trace is None:
        return
    trace_id, parent, root_id = trace
    attrs = {"proxy": proxy, "route": route, "method": method,
             "status": status,
             "clock_off": round(tracing.clock_offset(), 6)}
    if items:
        attrs["items"] = items
    tracing.record_span("serve.request", start, time.time(),
                        attributes=attrs, parent_id=parent or None,
                        trace_id=trace_id, span_id=root_id, force=True)


class Request:
    """Minimal request object handed to ingress callables."""

    def __init__(self, method: str, path: str, query: Dict[str, list],
                 body: bytes, headers: Dict[str, str]):
        self.method = method
        self.path = path
        self.query = query
        self.body = body
        self.headers = headers

    def json(self):
        return json.loads(self.body) if self.body else None

    def text(self):
        return self.body.decode()

    def __reduce__(self):
        return (Request, (self.method, self.path, self.query, self.body,
                          self.headers))


class _RouteTable:
    """Shared proxy plumbing: a route table kept fresh via the
    controller's long-poll 'routes' key + longest-prefix matching.
    Extended by the HTTP and frame-protocol ingresses."""

    def _init_routes(self):
        self._routes: Dict[str, Tuple[str, str]] = {}
        self._routes_lock = threading.Lock()
        self._stop = threading.Event()
        threading.Thread(target=self._route_poll_loop,
                         name="proxy-routes", daemon=True).start()

    def _route_poll_loop(self):
        from ray_tpu_torch.serve.controller import (
            CONTROLLER_NAME,
            SERVE_NAMESPACE,
        )

        controller = None
        known = {"routes": 0}
        while not self._stop.is_set():
            try:
                if controller is None:
                    controller = ray_tpu_torch.get_actor(
                        CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
                    with self._routes_lock:
                        self._routes = ray_tpu_torch.get(
                            controller.get_routes.remote(), timeout=10)
                changed = ray_tpu_torch.get(
                    controller.listen_for_change.remote(
                        known, LISTEN_TIMEOUT_S),
                    timeout=LISTEN_TIMEOUT_S + 5)
                for key, (version, value) in (changed or {}).items():
                    if key == "routes":
                        known[key] = version
                        with self._routes_lock:
                            self._routes = value or {}
            except Exception:
                controller = None
                time.sleep(0.5)

    def _match_route(self, path: str
                     ) -> Optional[Tuple[str, str, str, bool]]:
        with self._routes_lock:
            routes = dict(self._routes)
        best = None
        for prefix, entry in routes.items():
            app, ingress = entry[0], entry[1]
            is_asgi = bool(entry[2]) if len(entry) > 2 else False
            norm = prefix.rstrip("/") or "/"
            if path == norm or path.startswith(
                    norm if norm != "/" else "/"):
                if norm != "/" and not (
                        path == norm or path[len(norm):][:1] in ("/", "?")):
                    continue
                if best is None or len(norm) > len(best[0]):
                    best = (norm, app, ingress, is_asgi)
        return best


class HTTPProxy(_RouteTable):
    """Actor: serves HTTP on (host, port) from one asyncio loop."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 max_body_bytes: int = 100 * 1024 * 1024):
        # Cap request bodies (the declared Content-Length is read fully
        # into memory): a single client must not be able to make the
        # proxy buffer an arbitrarily large body.
        self.max_body_bytes = max_body_bytes
        self._init_routes()
        self._loop = asyncio.new_event_loop()
        threading.Thread(target=self._loop.run_forever,
                         name="http-proxy-loop", daemon=True).start()
        fut = asyncio.run_coroutine_threadsafe(
            self._start(host, port), self._loop)
        self._addr = fut.result(timeout=30)

    async def _start(self, host: str, port: int) -> str:
        # port=0 lets the OS pick; retry upward if a fixed port is taken
        last_err = None
        for attempt in range(20):
            try:
                self._server = await asyncio.start_server(
                    self._serve_conn, host,
                    port + attempt if port else 0)
                break
            except OSError as e:
                last_err = e
        else:
            raise last_err
        sock = self._server.sockets[0].getsockname()
        return f"http://{sock[0]}:{sock[1]}"

    # -- control --------------------------------------------------------
    def address(self) -> str:
        return self._addr

    def ping(self) -> str:
        return "pong"

    # -- HTTP plumbing ---------------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter):
        try:
            while True:
                try:
                    # Idle keep-alive timeout: a parked client must not
                    # hold an fd/task forever; oversized request lines
                    # (StreamReader's 64 KiB limit) get a 400.
                    line = await asyncio.wait_for(reader.readline(),
                                                  timeout=75.0)
                except asyncio.TimeoutError:
                    return
                except (ValueError, asyncio.LimitOverrunError):
                    self._write_response(writer, 400, json.dumps(
                        {"error": "request line too long"}).encode())
                    await writer.drain()
                    return
                if not line:
                    return
                if line in (b"\r\n", b"\n"):
                    continue
                try:
                    method, raw_path, _ver = \
                        line.decode("latin1").split(" ", 2)
                except ValueError:
                    return
                # Original header casing is preserved: Request.headers is
                # a plain dict user code indexes with canonical names
                # ('Content-Type'); the proxy's own lookups go through
                # the case-insensitive _hget.
                headers: Dict[str, str] = {}
                while True:
                    try:
                        # Bounded like the request line: a client going
                        # silent mid-headers must not park the fd/task.
                        h = await asyncio.wait_for(reader.readline(),
                                                   timeout=30.0)
                    except asyncio.TimeoutError:
                        return
                    except (ValueError, asyncio.LimitOverrunError):
                        self._write_response(writer, 400, json.dumps(
                            {"error": "header too long"}).encode())
                        await writer.drain()
                        return
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode("latin1").partition(":")
                    headers[k.strip()] = v.strip()
                try:
                    length = int(_hget(headers, "content-length") or 0)
                except ValueError:
                    self._write_response(writer, 400, json.dumps(
                        {"error": "bad Content-Length"}).encode())
                    await writer.drain()
                    return
                if "chunked" in _hget(
                        headers, "transfer-encoding", "").lower():
                    # Chunked request bodies are not supported; say so
                    # (411: send a Content-Length) instead of silently
                    # treating the body as empty.
                    self._write_response(writer, 411, json.dumps(
                        {"error": "chunked request bodies unsupported; "
                                  "send Content-Length"}).encode())
                    await writer.drain()
                    return
                if length > self.max_body_bytes:
                    self._write_response(writer, 413, json.dumps(
                        {"error": f"body of {length} bytes exceeds the "
                                  f"{self.max_body_bytes} limit"}).encode())
                    await writer.drain()
                    return
                try:
                    body = await asyncio.wait_for(
                        reader.readexactly(length),
                        timeout=75.0) if length else b""
                except asyncio.TimeoutError:
                    return
                keep = _hget(headers, "connection", "").lower() != "close"
                try:
                    await self._dispatch(writer, method, raw_path, body,
                                         headers)
                except (ConnectionError, OSError):
                    raise
                except Exception:  # noqa: BLE001 — any bug → 500, not
                    # a silently closed socket (old handler's contract)
                    self._write_response(
                        writer, 500, traceback.format_exc().encode())
                    await writer.drain()
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    def _write_response(writer, status: int, payload: bytes,
                        content_type: str = "application/json"):
        reason = {200: "OK", 404: "Not Found",
                  500: "Internal Server Error",
                  503: "Service Unavailable"}.get(status, "OK")
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"Connection: keep-alive\r\n\r\n".encode() + payload)

    @staticmethod
    def _wants_stream(headers: Dict[str, str]) -> bool:
        return ("text/event-stream" in _hget(headers, "accept")
                or _hget(headers, "x-serve-stream") in ("1", "true"))

    async def _dispatch(self, writer, method: str, raw_path: str,
                        body: bytes, headers: Dict[str, str]):
        parsed = urlparse(raw_path)
        path = parsed.path
        if path == "/-/healthz":
            self._write_response(writer, 200, b'"ok"')
            return await writer.drain()
        if path == "/-/routes":
            with self._routes_lock:
                payload = json.dumps(
                    {k: list(v) for k, v in self._routes.items()}).encode()
            self._write_response(writer, 200, payload)
            return await writer.drain()
        match = self._match_route(path)
        if match is None:
            self._write_response(writer, 404, json.dumps(
                {"error": f"no application at {path}"}).encode())
            return await writer.drain()
        prefix, app, ingress, is_asgi = match
        from ray_tpu_torch.serve.handle import DeploymentHandle

        handle = DeploymentHandle(ingress, app)
        req = Request(method, path, parse_qs(parsed.query), body, headers)
        trace = mint_request_trace(headers)
        t0 = time.time()
        if trace is not None:
            handle = handle.options(trace_ctx=(trace[0], trace[2]))
        status = "ok"
        try:
            if is_asgi:
                # ASGI ingress: the replica streams response events
                # (serve/asgi.py); render them as real HTTP, chunked so
                # streaming responses flush as the app sends.
                return await self._dispatch_asgi(writer, handle, req)
            if self._wants_stream(headers):
                return await self._dispatch_streaming(
                    writer, handle, req, trace=trace)
            try:
                result = await self._call_async(handle, req)
            except Exception as e:  # noqa: BLE001
                status = "error"
                self._write_response(writer, 500, json.dumps(
                    {"error": str(e)}).encode())
                return await writer.drain()
            try:
                payload = json.dumps(result).encode()
            except (TypeError, ValueError):  # unserializable / circular
                payload = json.dumps(str(result)).encode()
            self._write_response(writer, 200, payload)
            await writer.drain()
        finally:
            record_request_span(trace, t0, proxy="http", route=path,
                                method=method, status=status)

    async def _call_async(self, handle, req,
                          timeout_s: float = DATA_PLANE_TIMEOUT_S):
        """Submit through the router without blocking the loop (replica
        backpressure becomes async sleep, not a parked thread) and await
        the result ref; retries once through another replica on actor
        death — the async twin of DeploymentResponse.result()."""
        from ray_tpu_torch.core.runtime import get_runtime

        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        attempts = 0
        while True:
            try:
                resp = await loop.run_in_executor(
                    None,
                    lambda: handle.options(
                        assign_timeout_s=0.0).remote(req))
            except TimeoutError:
                if loop.time() >= deadline:
                    raise TimeoutError(
                        "no replica available within the timeout")
                await asyncio.sleep(0.02)
                continue
            fut = get_runtime().as_future(resp._to_object_ref())
            try:
                return await asyncio.wait_for(
                    asyncio.wrap_future(fut),
                    max(0.1, deadline - loop.time()))
            except ray_tpu_torch.ActorError:
                resp._release()
                handle._router().drop_replica(resp._assigned_hex)
                attempts += 1
                if attempts >= 3:
                    raise

    async def _acquire_stream(self, writer, handle, req,
                              timeout_s: float = DATA_PLANE_TIMEOUT_S):
        """Obtain a streaming generator from a replica with async
        backpressure retries; writes the error response and returns
        None when no replica materializes in time."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while True:
            try:
                return await loop.run_in_executor(
                    None, lambda: handle.options(
                        stream=True, assign_timeout_s=0.0).remote(req))
            except TimeoutError:
                if loop.time() >= deadline:
                    self._write_response(writer, 503, json.dumps(
                        {"error": "no replica available"}).encode())
                    await writer.drain()
                    return None
                await asyncio.sleep(0.02)
            except Exception as e:  # noqa: BLE001
                self._write_response(writer, 500, json.dumps(
                    {"error": str(e)}).encode())
                await writer.drain()
                return None

    async def _dispatch_asgi(self, writer, handle, req,
                             timeout_s: float = DATA_PLANE_TIMEOUT_S):
        """Render an ASGI ingress's streamed response events
        (serve/asgi.py asgi_stream) as raw HTTP: the first item carries
        status + headers, subsequent raw-bytes items are body chunks
        (Transfer-Encoding: chunked, so app-driven streaming flushes)."""
        gen = await self._acquire_stream(writer, handle, req, timeout_s)
        if gen is None:
            return
        state = {"i": 0, "eos_consumed": False}
        started = False
        failed_mid_stream = False
        try:
            async for item in _astream_values(gen.task_id, state):
                if not started:
                    if not (isinstance(item, dict)
                            and "__asgi_start__" in item):
                        raise RuntimeError(
                            "ASGI ingress did not send a response start")
                    start = item["__asgi_start__"]
                    # Content-Length is replaced by chunked transfer;
                    # hop-by-hop headers stay ours.
                    hdrs = "".join(
                        f"{k}: {v}\r\n" for k, v in start["headers"]
                        if k.lower() not in ("content-length",
                                             "transfer-encoding",
                                             "connection"))
                    writer.write(
                        f"HTTP/1.1 {start['status']} \r\n{hdrs}"
                        f"Transfer-Encoding: chunked\r\n"
                        f"Connection: keep-alive\r\n\r\n".encode())
                    await writer.drain()
                    started = True
                    continue
                data = bytes(item)
                if data:
                    writer.write(f"{len(data):x}\r\n".encode() + data
                                 + b"\r\n")
                    await writer.drain()
        except (ConnectionError, OSError):
            # Client went away mid-response: stop the replica-side
            # generator too (frees engine slots / KV pages).
            _STREAM_DISCONNECTS.inc(tags={"proxy": "http"})
            gen.cancel()
            raise
        except Exception as e:  # noqa: BLE001
            if not started:
                self._write_response(writer, 500, json.dumps(
                    {"error": str(e)}).encode())
                return await writer.drain()
            # Mid-stream failure: abort the connection WITHOUT the
            # chunked terminator — a truncated chunked body is the
            # protocol-level failure signal; writing "0\r\n\r\n" would
            # present the partial body as a complete 200.
            failed_mid_stream = True
        finally:
            gen._release()
            try:
                from ray_tpu_torch.core.runtime import get_runtime

                get_runtime().core.client.send({
                    "op": "free_stream", "task": gen.task_id.hex(),
                    "from_index": state["i"],
                    "eos_consumed": state["eos_consumed"],
                    "count": state.get("count")})
                gen.disown_stream()
            except Exception:
                pass
        if failed_mid_stream:
            writer.close()
            return
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    async def _dispatch_streaming(self, writer, handle, req,
                                  timeout_s: float = DATA_PLANE_TIMEOUT_S,
                                  trace=None):
        """Chunked transfer, flushed per yielded item (the reference's
        streaming ASGI responses; token streaming for LLM chat):
        ``Accept: text/event-stream`` gets SSE ``data:`` frames ending
        with ``data: [DONE]``, anything else one JSON document per line.
        Replica backpressure is an async sleep/retry (assign_timeout_s=
        0), same as _call_async — a full cluster must not park an
        executor thread per waiting stream.  A client disconnect cancels
        the replica-side generator (engine abort) before cleanup."""
        sse = "text/event-stream" in _hget(req.headers, "accept")
        gen = await self._acquire_stream(writer, handle, req, timeout_s)
        if gen is None:
            return
        ctype = ("text/event-stream" if sse else "application/jsonl")
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: " + ctype.encode() + b"\r\n"
            b"Transfer-Encoding: chunked\r\n"
            b"Connection: keep-alive\r\n\r\n")
        await writer.drain()

        def _frame(doc: str) -> bytes:
            text = (f"data: {doc}\n\n" if sse else doc + "\n").encode()
            return f"{len(text):x}\r\n".encode() + text + b"\r\n"

        state = {"i": 0, "eos_consumed": False}
        completed = False
        t_deliver = time.time()
        try:
            async for item in _astream_values(gen.task_id, state):
                writer.write(_frame(json.dumps(item)))
                _STREAM_TOKENS.inc(tags={"proxy": "http"})
                await writer.drain()
            completed = True
        except (ConnectionError, OSError):
            # Client went away: stop the replica-side generator so the
            # engine frees the slot + KV pages; cleanup in finally.
            _STREAM_DISCONNECTS.inc(tags={"proxy": "http"})
            gen.cancel()
            raise
        except Exception as e:  # noqa: BLE001 — mid-stream: emit an
            # error line (headers already sent, status is fixed)
            writer.write(_frame(json.dumps({"error": str(e)})))
        finally:
            gen._release()
            if trace is not None:
                # Delivery phase of the request journey: first flushed
                # frame to stream end (parented under serve.request).
                tracing.record_span(
                    "serve.stream", t_deliver, time.time(),
                    attributes={"items": state["i"],
                                "completed": completed, "sse": sse},
                    parent_id=trace[2], trace_id=trace[0], force=True)
            # Free whatever this consumer will never read (finished
            # streams only — a cancelled generator winds down replica-
            # side and its tail items are reclaimed at teardown).
            try:
                from ray_tpu_torch.core.runtime import get_runtime

                get_runtime().core.client.send({
                    "op": "free_stream", "task": gen.task_id.hex(),
                    "from_index": state["i"],
                    "eos_consumed": state["eos_consumed"],
                    "count": state.get("count")})
                gen.disown_stream()
            except Exception:
                pass
        if completed and sse:
            writer.write(_frame("[DONE]"))
        writer.write(b"0\r\n\r\n")
        await writer.drain()


async def _astream_values(task_id, state: Optional[dict] = None):
    """Async mirror of core.streaming.ObjectRefGenerator: await each
    item's object future on the event loop (no parked thread per
    stream), resolve and decref as consumed.  `state` (if given) tracks
    {"i": consumed, "eos_consumed": bool} for the caller's cleanup."""
    from ray_tpu_torch.core.runtime import get_runtime
    from ray_tpu_torch.core.streaming import stream_eos_id, stream_item_id

    core = get_runtime().core
    loop = asyncio.get_running_loop()
    eos_hex = stream_eos_id(task_id).hex()
    eos_fut = asyncio.wrap_future(core.object_future(eos_hex))
    count = None
    i = 0
    while count is None or i < count:
        item_hex = stream_item_id(task_id, i).hex()
        item_fut = asyncio.wrap_future(core.object_future(item_hex))
        if count is None:
            while not item_fut.done():
                await asyncio.wait({item_fut, eos_fut},
                                   return_when=asyncio.FIRST_COMPLETED)
                if eos_fut.done() and not item_fut.done():
                    # Stream ended (or failed — _load_object raises).
                    # Loads run OFF the loop: a shm/cross-node read must
                    # not stall every other in-flight request.  The
                    # speculative item[i] probe is retired on BOTH the
                    # ended and the failed path.
                    try:
                        count = await loop.run_in_executor(
                            None, core._load_object, eos_hex,
                            eos_fut.result())  # raylint: allow-blocking(guarded by eos_fut.done() above; resolves immediately)
                    except BaseException:
                        core.forget_object(item_hex)
                        raise
                    if state is not None:
                        state["eos_consumed"] = True
                        # The decref below may DELETE the eos head-side;
                        # cleanup's free_stream then needs the count
                        # from us (gcs.py _op_free_stream).
                        state["count"] = count
                    try:
                        core.client.send({"op": "decref", "obj": eos_hex})
                    except Exception:
                        pass
                    if i >= count:
                        core.forget_object(item_hex)
                        return
                    break  # item i exists (items stored before eos)
        info = await item_fut
        value = await loop.run_in_executor(
            None, core._load_object, item_hex, info)
        try:
            core.client.send({"op": "decref", "obj": item_hex})
        except Exception:
            pass
        i += 1
        if state is not None:
            state["i"] = i
        yield value


class FrameProxy(_RouteTable):
    """Cross-language ingress over the framed RPC wire (counterpart of
    the reference's gRPCProxy, serve/_private/proxy.py:540).

    Clients send ONE JSON frame (core/rpc.py kind 3 — the same protocol
    the C++ frontend speaks):

        {"op": "serve_request", "route": "/app", "payload": <json>}

    and receive {"status": "ok", "result": <json>}. The ingress callable
    sees the same Request object an HTTP call would produce (method
    "FRAME", body = JSON-encoded payload), so one deployment serves both
    ingresses.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from ray_tpu_torch.core import rpc

        self._init_routes()
        self._server = rpc.Server(self._handle_msg, host=host, port=port)

    def address(self) -> str:
        return f"{self._server.host}:{self._server.port}"

    def ping(self) -> str:
        return "pong"

    def _handle_msg(self, conn, msg: dict):
        if msg.get("op") != "serve_request":
            raise ValueError(f"unknown op {msg.get('op')!r}")
        route = msg.get("route", "/")
        match = self._match_route(route)
        if match is None:
            raise ValueError(f"no application at {route}")
        _, app, ingress, _is_asgi = match
        from ray_tpu_torch.serve.handle import DeploymentHandle

        handle = DeploymentHandle(ingress, app)
        headers = dict(msg.get("headers") or {})
        req = Request("FRAME", route, {},
                      json.dumps(msg.get("payload")).encode(), headers)
        trace = mint_request_trace(headers)
        t0 = time.time()
        if trace is not None:
            handle = handle.options(trace_ctx=(trace[0], trace[2]))
        status = "ok"
        try:
            return handle.remote(req).result(
                timeout_s=float(msg.get("timeout_s", 60)))
        except BaseException:
            status = "error"
            raise
        finally:
            record_request_span(trace, t0, proxy="frame", route=route,
                                method="FRAME", status=status)
