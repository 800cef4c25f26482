"""The port's typed gRPC ingress, on a cluster of its own runtime, on the CPU.

The six cases of tests/test_serve_grpc.py.  The port keeps the
reference's service name (ray_tpu.serve.ServeAPI) and a copy of its
proto, so one generated client speaks to both packages.  One cluster for
the file (num_cpus=4, num_gpus=0); skipped where grpcio is missing.
"""

import importlib
import json
import time

import pytest

grpc = pytest.importorskip("grpc")

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
rt = importlib.import_module(PORT)
serve = importlib.import_module(f"{PORT}.serve")
serve_pb2 = importlib.import_module(f"{PORT}.serve.protos.serve_pb2")

_SVC = "/ray_tpu.serve.ServeAPI"


@pytest.fixture(scope="module")
def grpc_serve():
    rt.init(num_cpus=4, num_gpus=0, log_to_driver=False)
    channel = None
    try:
        @serve.deployment
        class Echo:
            def __call__(self, req):
                body = json.loads(req.body) if req.body else None
                return {"echo": body, "hdr": req.headers.get("x-tag", "")}

            def gen(self, req):
                n = json.loads(req.body)["n"]
                for i in range(n):
                    yield {"i": i}

            def slow_gen(self, req):
                n = json.loads(req.body)["n"]
                for i in range(n):
                    if i:
                        time.sleep(0.25)
                    yield {"i": i}

        serve.run(Echo.bind(), name="echo", route_prefix="/echo")
        addr = serve.start_grpc_ingress()
        assert addr == serve.start_grpc_ingress()  # idempotent
        channel = grpc.insecure_channel(addr)
        yield channel
    finally:
        if channel is not None:
            channel.close()
        serve.shutdown()
        rt.shutdown()


def _stub(channel, method, req_cls, reply_cls, stream=False):
    factory = channel.unary_stream if stream else channel.unary_unary
    return factory(f"{_SVC}/{method}",
                   request_serializer=req_cls.SerializeToString,
                   response_deserializer=reply_cls.FromString)


def test_grpc_healthz_and_routes(grpc_serve):
    hz = _stub(grpc_serve, "Healthz", serve_pb2.Empty, serve_pb2.Empty)
    hz(serve_pb2.Empty(), timeout=30)
    lr = _stub(grpc_serve, "ListRoutes", serve_pb2.Empty,
               serve_pb2.RouteListing)
    deadline = time.monotonic() + 20
    routes = {}
    while time.monotonic() < deadline:
        routes = dict(lr(serve_pb2.Empty(), timeout=30).routes)
        if "/echo" in routes:
            break
        time.sleep(0.2)
    assert "/echo" in routes and routes["/echo"].startswith("echo/")


def test_grpc_unary_call(grpc_serve):
    call = _stub(grpc_serve, "Call", serve_pb2.ServeRequest,
                 serve_pb2.ServeReply)
    reply = call(serve_pb2.ServeRequest(
        route="/echo", payload=json.dumps({"a": 1}).encode(),
        headers={"x-tag": "t1"}), timeout=60)
    assert reply.status == 200, reply.error
    assert json.loads(reply.payload) == {"echo": {"a": 1}, "hdr": "t1"}


def test_grpc_unknown_route_404(grpc_serve):
    call = _stub(grpc_serve, "Call", serve_pb2.ServeRequest,
                 serve_pb2.ServeReply)
    reply = call(serve_pb2.ServeRequest(route="/nope", payload=b"{}"),
                 timeout=60)
    assert reply.status == 404
    assert "no application" in reply.error


def test_grpc_stream_call(grpc_serve):
    stream = _stub(grpc_serve, "CallStream", serve_pb2.ServeRequest,
                   serve_pb2.ServeReply, stream=True)
    frames = list(stream(serve_pb2.ServeRequest(
        route="/echo", method="gen",
        payload=json.dumps({"n": 4}).encode()), timeout=60))
    assert frames[-1].is_final
    items = [json.loads(f.payload) for f in frames if f.payload]
    assert items == [{"i": i} for i in range(4)]
    assert all(f.status == 200 for f in frames)


def test_grpc_stream_first_frame_before_completion(grpc_serve):
    stream = _stub(grpc_serve, "CallStream", serve_pb2.ServeRequest,
                   serve_pb2.ServeReply, stream=True)
    call = stream(serve_pb2.ServeRequest(
        route="/echo", method="slow_gen",
        payload=json.dumps({"n": 4}).encode()), timeout=60)
    arrivals, items = [], []
    for f in call:
        if f.payload:
            items.append(json.loads(f.payload))
        arrivals.append(time.monotonic())
    assert items == [{"i": i} for i in range(4)]
    assert arrivals[-1] - arrivals[0] > 0.4


def test_grpc_stream_client_cancel(grpc_serve):
    stream = _stub(grpc_serve, "CallStream", serve_pb2.ServeRequest,
                   serve_pb2.ServeReply, stream=True)
    call = stream(serve_pb2.ServeRequest(
        route="/echo", method="slow_gen",
        payload=json.dumps({"n": 50}).encode()), timeout=120)
    it = iter(call)
    first = next(it)
    assert first.status == 200 and json.loads(first.payload) == {"i": 0}
    call.cancel()
    with pytest.raises(grpc.RpcError) as info:
        for _ in it:
            pass
    assert info.value.code() == grpc.StatusCode.CANCELLED
