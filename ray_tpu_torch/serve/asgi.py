"""ASGI ingress: deploy any ASGI-conformant app (FastAPI/starlette/
raw callable) unmodified.

Counterpart of python/ray/serve/_private/http_util.py (ASGIAppReplicaWrapper)
+ serve/api.py `@serve.ingress(app)`: the replica runs the user's ASGI
app against the spec's scope/receive/send contract; response events
stream back to the proxy as items ({"__asgi_start__": ...} then raw
body chunks), which the proxy renders as real HTTP — including
streaming responses, flushed chunk by chunk.

FastAPI/starlette are optional: anything implementing
`async def app(scope, receive, send)` deploys; the decorator only
touches the ASGI callable surface.
"""

from __future__ import annotations

import asyncio
import queue
import threading
from typing import Any, Dict, Iterator, List
from urllib.parse import quote

_loop_lock = threading.Lock()
_loop: asyncio.AbstractEventLoop | None = None


def _app_loop() -> asyncio.AbstractEventLoop:
    """One shared asyncio loop thread per replica process for ASGI app
    execution (the role uvicorn's loop plays in the reference)."""
    global _loop
    with _loop_lock:
        if _loop is None or _loop.is_closed():
            _loop = asyncio.new_event_loop()
            threading.Thread(target=_loop.run_forever,
                             name="asgi-app-loop", daemon=True).start()
        return _loop


def build_scope(request, root_path: str = "") -> Dict[str, Any]:
    """HTTP request (serve.proxy.Request) → ASGI HTTP scope."""
    query = "&".join(
        f"{quote(k)}={quote(str(v))}"
        for k, vs in (request.query or {}).items() for v in vs)
    headers: List[List[bytes]] = [
        [k.lower().encode("latin1"), v.encode("latin1")]
        for k, v in (request.headers or {}).items()]
    path = request.path
    if root_path and path.startswith(root_path):
        path = path[len(root_path):] or "/"
    return {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": request.method,
        "scheme": "http",
        "path": path,
        "raw_path": path.encode("latin1"),
        "root_path": root_path,
        "query_string": query.encode("latin1"),
        "headers": headers,
        "client": ("127.0.0.1", 0),
        "server": ("127.0.0.1", 0),
    }


def asgi_stream(app, request, root_path: str = "") -> Iterator[Any]:
    """Run `app` against the request; yield response events as stream
    items: first {"__asgi_start__": {"status", "headers"}}, then one
    raw `bytes` item per non-empty body chunk — a SYNC generator (the
    actor streaming transport's contract) bridging the app's asyncio
    execution via a queue, so chunks flush as the app sends them."""
    scope = build_scope(request, root_path)
    # Bounded: an abandoned stream (client gone, consumer stopped
    # draining) suspends the app coroutine on a full queue instead of
    # growing memory without limit.  The put rides the loop's executor
    # so a full queue never blocks the shared app event loop itself.
    q: "queue.Queue[Any]" = queue.Queue(maxsize=256)
    body_sent = {"done": False}

    async def receive():
        if body_sent["done"]:
            # Per spec: block until disconnect once the body is
            # delivered; returning disconnect immediately would make
            # long-poll apps think the client left.
            await asyncio.sleep(3600)
            return {"type": "http.disconnect"}
        body_sent["done"] = True
        return {"type": "http.request", "body": request.body or b"",
                "more_body": False}

    async def send(event):
        loop = asyncio.get_running_loop()
        t = event["type"]
        if t == "http.response.start":
            item = {"__asgi_start__": {
                "status": int(event["status"]),
                "headers": [
                    [k.decode("latin1"), v.decode("latin1")]
                    for k, v in event.get("headers", [])],
            }}
            await loop.run_in_executor(None, q.put, item)
        elif t == "http.response.body":
            body = event.get("body", b"")
            if body:
                await loop.run_in_executor(None, q.put, bytes(body))

    async def main():
        loop = asyncio.get_running_loop()
        try:
            await app(scope, receive, send)
            await loop.run_in_executor(None, q.put, None)  # clean end
        except BaseException as e:  # noqa: BLE001
            await loop.run_in_executor(None, q.put, e)

    asyncio.run_coroutine_threadsafe(main(), _app_loop())
    started = False
    while True:
        ev = q.get()
        if ev is None:
            if not started:
                raise RuntimeError(
                    "ASGI app finished without http.response.start")
            return
        if isinstance(ev, BaseException):
            if started:
                raise ev
            # App crashed before responding: surface a 500.
            yield {"__asgi_start__": {"status": 500, "headers": [
                ["content-type", "text/plain"]]}}
            yield f"ASGI app error: {ev}".encode()
            return
        if isinstance(ev, dict) and "__asgi_start__" in ev:
            started = True
        yield ev


def ingress(app):
    """Class decorator: route HTTP requests into an ASGI app
    (reference: serve.api.ingress).  Usage:

        fastapi_app = FastAPI()   # or any ASGI callable

        @serve.deployment
        @serve.ingress(fastapi_app)
        class MyService:
            ...

    The wrapped class keeps its own methods (reachable via handles);
    HTTP traffic goes through the app.  The app object is captured by
    value (cloudpickle) into the replica."""

    def decorator(cls):
        class ASGIIngressWrapper(cls):
            __serve_asgi__ = True
            _asgi_app = staticmethod(app)

            def __call__(self, request):  # sync generator: stream items
                yield from asgi_stream(type(self)._asgi_app, request)

        ASGIIngressWrapper.__name__ = cls.__name__
        ASGIIngressWrapper.__qualname__ = getattr(
            cls, "__qualname__", cls.__name__)
        return ASGIIngressWrapper

    return decorator


class _EmptyBase:
    pass


def asgi_app(app):
    """Deployment-ready wrapper for a bare ASGI app:
    `serve.run(serve.deployment(serve.asgi_app(app)).bind())`."""
    return ingress(app)(_EmptyBase)
