"""The port's async serve data plane on a cluster of its own runtime, on the CPU.

The nine cases of tests/test_serve_async.py: 100 in-flight HTTP
requests, streamed deployments over chunked HTTP and SSE, streamed LLM
generation through a handle and over HTTP, a mid-stream disconnect that
frees the engine's slot and pages, and the ASGI ingress.  One cluster
and one serve instance for the file (num_cpus=4, num_gpus=0); each test
deletes its applications; every blocking call has a timeout.  The LLM
replicas run the tiny config on the CPU (device="cpu").
"""

import http.client
import importlib
import json
import threading
import time
from urllib.parse import urlparse

import pytest

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
rt = importlib.import_module(PORT)
serve = importlib.import_module(f"{PORT}.serve")
deployment = importlib.import_module(f"{PORT}.serve.deployment").deployment
tllm = importlib.import_module(f"{PORT}.serve.llm")
Request = importlib.import_module(f"{PORT}.serve.proxy").Request

T = 120  # seconds: every blocking call in this file is bounded
LLM_KW = dict(config_kwargs={}, page_size=4, num_pages=64, max_batch=2,
              device="cpu")


@pytest.fixture(scope="module")
def serve_rt():
    drv = rt.init(num_cpus=4, num_gpus=0, log_to_driver=False)
    try:
        serve.start()
        yield drv
    finally:
        serve.shutdown()
        rt.shutdown()


@pytest.fixture(autouse=True)
def _cleanup_apps(serve_rt):
    yield
    for app in list(serve.status()):
        serve.delete(app)


def _http(base_url, method, path, body=None, headers=None, timeout=60):
    u = urlparse(base_url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    payload = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=payload, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_100_inflight_requests(serve_rt):
    @deployment(name="napper", num_replicas=2, max_ongoing_requests=32)
    class Napper:
        def __call__(self, request):
            time.sleep(0.5)
            return {"ok": True}

    serve.run(Napper.bind(), name="nap", route_prefix="/nap")
    base = serve.proxy_address()

    results = []
    errors = []

    def hit():
        try:
            status, data = _http(base, "GET", "/nap", timeout=120)
            results.append((status, json.loads(data)))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t0 = time.monotonic()
    threads = [threading.Thread(target=hit) for _ in range(100)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    dt = time.monotonic() - t0

    assert not errors, errors[:3]
    assert len(results) == 100
    assert all(s == 200 and d == {"ok": True} for s, d in results)
    assert dt < 25, f"100 in-flight requests took {dt:.1f}s"


def test_streaming_deployment_chunks_arrive_incrementally(serve_rt):
    @deployment(name="ticker")
    class Ticker:
        def __call__(self, request):
            for i in range(5):
                time.sleep(0.3)
                yield {"tick": i}

    serve.run(Ticker.bind(), name="tick", route_prefix="/tick")
    base = serve.proxy_address()
    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    conn.request("GET", "/tick", headers={"X-Serve-Stream": "1"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.headers.get("Transfer-Encoding") == "chunked"
    arrivals = []
    lines = []
    buf = b""
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            lines.append(json.loads(line))
            arrivals.append(time.monotonic())
    conn.close()
    assert lines == [{"tick": i} for i in range(5)]
    assert arrivals[-1] - arrivals[0] > 0.5


def test_handle_streaming_generator(serve_rt):
    @deployment(name="counter-stream")
    class Gen:
        def run(self, n):
            for i in range(n):
                yield i * i

    h = serve.run(Gen.bind(), name="sq", route_prefix="/sq")
    out = list(h.options(stream=True, method_name="run").remote(6))
    assert out == [i * i for i in range(6)]


def test_streamed_chat_completion(serve_rt):
    h = serve.run(tllm.LLMServer.bind(**LLM_KW), name="llm",
                  route_prefix="/llm")
    ref_tokens = h.generate.remote([1, 2, 3], 6).result(timeout_s=T)
    streamed = list(h.options(
        stream=True, method_name="generate_stream").remote([1, 2, 3], 6))
    assert streamed == ref_tokens
    assert len(streamed) == 6


def test_streamed_chat_completion_over_http(serve_rt):
    @deployment(name="chat")
    class Chat:
        def __init__(self, llm):
            self.llm = llm

        def __call__(self, request: Request):
            body = request.json() or {}
            prompt = body.get("prompt", [1, 2, 3])
            n = int(body.get("max_new_tokens", 5))
            for tok in self.llm.options(
                    stream=True,
                    method_name="generate_stream").remote(prompt, n):
                yield {"token": tok}

    llm = tllm.LLMServer.bind(**LLM_KW)
    serve.run(Chat.bind(llm), name="chat", route_prefix="/chat")
    base = serve.proxy_address()
    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    conn.request("POST", "/chat",
                 body=json.dumps({"prompt": [1, 2, 3],
                                  "max_new_tokens": 5}).encode(),
                 headers={"X-Serve-Stream": "1",
                          "Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    body = resp.read()
    conn.close()
    lines = [json.loads(x) for x in body.splitlines() if x]
    assert len(lines) == 5
    assert all("token" in d for d in lines)


def test_sse_streaming_first_event_before_completion(serve_rt):
    @deployment(name="sse-ticker")
    class Ticker:
        def __call__(self, request):
            for i in range(4):
                time.sleep(0.25)
                yield {"tok": i}

    serve.run(Ticker.bind(), name="sse", route_prefix="/sse")
    base = serve.proxy_address()
    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    conn.request("GET", "/sse", headers={"Accept": "text/event-stream"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.headers.get("Content-Type") == "text/event-stream"
    arrivals, events = [], []
    buf = b""
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            assert frame.startswith(b"data: "), frame
            events.append(frame[len(b"data: "):].decode())
            arrivals.append(time.monotonic())
    conn.close()
    assert events[-1] == "[DONE]"
    assert [json.loads(e) for e in events[:-1]] == \
        [{"tok": i} for i in range(4)]
    assert arrivals[-1] - arrivals[0] > 0.4


def test_midstream_disconnect_frees_engine_slot_and_pages(serve_rt):
    """Dropping a token stream mid-generation aborts the engine request:
    the decode slot and every KV page return to the pool, and the
    generation counts as aborted, not completed.  (The reference's copy
    of this test can fail on an idle CPU: its engine thread holds the
    server's lock across every step.)"""
    h = serve.run(
        tllm.LLMServer.bind(**{**LLM_KW, "enable_prefix_caching": False}),
        name="llm-cancel", route_prefix="/llmc")
    stats0 = h.stats.remote().result(timeout_s=T)
    gen = h.options(stream=True,
                    method_name="generate_stream").remote([1, 2, 3], 100)
    it = iter(gen)
    first = next(it)
    assert isinstance(first, int)
    it.close()
    st = {}
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = h.stats.remote().result(timeout_s=60)
        if (st["active"] == 0 and st["num_aborted"] >= 1
                and st["free_pages"] == stats0["free_pages"]):
            break
        time.sleep(0.2)
    assert st["active"] == 0
    assert st["num_aborted"] >= 1
    assert st["free_pages"] == stats0["free_pages"]
    assert st["num_completed"] == stats0["num_completed"]


def _make_asgi_app():
    """Spec-conformant ASGI app: JSON echo route, a streaming route that
    flushes chunks with pauses, and a 404 default."""

    async def app(scope, receive, send):
        assert scope["type"] == "http"
        path = scope["path"]
        if path == "/echo":
            body = b""
            while True:
                ev = await receive()
                body += ev.get("body", b"")
                if not ev.get("more_body"):
                    break
            payload = json.dumps({
                "method": scope["method"],
                "path": path,
                "query": scope["query_string"].decode(),
                "body": body.decode() if body else None,
            }).encode()
            await send({"type": "http.response.start", "status": 200,
                        "headers": [(b"content-type", b"application/json"),
                                    (b"x-app", b"asgi")]})
            await send({"type": "http.response.body", "body": payload})
        elif path == "/stream":
            import asyncio

            await send({"type": "http.response.start", "status": 200,
                        "headers": [(b"content-type", b"text/plain")]})
            for i in range(5):
                await send({"type": "http.response.body",
                            "body": f"chunk{i};".encode(),
                            "more_body": True})
                await asyncio.sleep(0.15)
            await send({"type": "http.response.body", "body": b"done"})
        else:
            await send({"type": "http.response.start", "status": 404,
                        "headers": [(b"content-type", b"text/plain")]})
            await send({"type": "http.response.body", "body": b"nope"})

    return app


def test_asgi_app_deploys_and_serves(serve_rt):
    app = _make_asgi_app()

    @deployment(name="asgi-echo")
    @serve.ingress(app)
    class EchoService:
        pass

    serve.run(EchoService.bind(), name="asgi", route_prefix="/")
    base = serve.proxy_address()

    status, data = _http(base, "POST", "/echo?x=1", body={"hi": 2})
    assert status == 200
    out = json.loads(data)
    assert out["method"] == "POST"
    assert out["path"] == "/echo"
    assert "x=1" in out["query"]
    assert json.loads(out["body"]) == {"hi": 2}

    status, data = _http(base, "GET", "/missing")
    assert status == 404 and data == b"nope"


def test_asgi_streaming_route_flushes_incrementally(serve_rt):
    app = _make_asgi_app()

    serve.run(deployment(name="asgi-stream")(
        serve.asgi_app(app)).bind(), name="asgi2", route_prefix="/")
    base = serve.proxy_address()

    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    conn.request("GET", "/stream")
    resp = conn.getresponse()
    assert resp.status == 200
    t0 = time.monotonic()
    arrivals = []
    body = b""
    while True:
        chunk = resp.read(8)
        if not chunk:
            break
        arrivals.append(time.monotonic() - t0)
        body += chunk
    conn.close()
    assert body == b"chunk0;chunk1;chunk2;chunk3;chunk4;done"
    assert arrivals[-1] - arrivals[0] > 0.25, arrivals
