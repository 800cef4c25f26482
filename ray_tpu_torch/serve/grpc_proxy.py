"""gRPC ingress for Serve: the typed-schema counterpart of the HTTP and
frame proxies.

Reference parity: python/ray/serve/_private/proxy.py:540 (gRPCProxy) +
src/ray/protobuf/serve.proto — a generated, language-neutral contract
(ray_tpu_torch/serve/protos/serve.proto) instead of the JSON side door.  The
server uses grpc generic method handlers, so only the protobuf messages
are generated code; the service dispatch is plain Python.

Runs as an actor started by the Serve controller
(controller.ensure_grpc_proxy); requests route through the same
_RouteTable / DeploymentHandle path as HTTP, so one deployment serves
all three ingresses.
"""

from __future__ import annotations

import json
import time
from typing import Iterator

from ray_tpu_torch.serve.proxy import (Request, _RouteTable, _STREAM_DISCONNECTS,
                                 _STREAM_TOKENS, mint_request_trace,
                                 record_request_span)
from ray_tpu_torch.util import tracing

# The reference's service name: one wire contract for both packages.
_SERVICE = "ray_tpu.serve.ServeAPI"


class GrpcProxy(_RouteTable):
    """Actor: serves the ServeAPI gRPC service on (host, port)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import grpc
        import os
        from concurrent import futures

        from ray_tpu_torch.serve.protos import serve_pb2

        try:
            workers = int(os.environ.get(
                "RAY_TPU_GRPC_WORKERS", "") or 16)
        except ValueError:
            workers = 16

        self._pb = serve_pb2
        self._init_routes()
        handlers = {
            "Call": grpc.unary_unary_rpc_method_handler(
                self._call,
                request_deserializer=serve_pb2.ServeRequest.FromString,
                response_serializer=serve_pb2.ServeReply.SerializeToString),
            "CallStream": grpc.unary_stream_rpc_method_handler(
                self._call_stream,
                request_deserializer=serve_pb2.ServeRequest.FromString,
                response_serializer=serve_pb2.ServeReply.SerializeToString),
            "ListRoutes": grpc.unary_unary_rpc_method_handler(
                self._list_routes,
                request_deserializer=serve_pb2.Empty.FromString,
                response_serializer=serve_pb2.RouteListing.SerializeToString),
            "Healthz": grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: serve_pb2.Empty(),
                request_deserializer=serve_pb2.Empty.FromString,
                response_serializer=serve_pb2.Empty.SerializeToString),
        }
        self._server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=max(1, workers),
                thread_name_prefix="grpc-proxy"))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),))
        self._port = self._server.add_insecure_port(f"{host}:{port}")
        self._host = host
        self._server.start()

    def address(self) -> str:
        return f"{self._host}:{self._port}"

    def ping(self) -> str:
        return "pong"

    # -- dispatch -------------------------------------------------------
    def _resolve(self, req):
        match = self._match_route(req.route or "/")
        if match is None:
            return None
        _, app, ingress, _is_asgi = match
        from ray_tpu_torch.serve.handle import DeploymentHandle

        return DeploymentHandle(ingress, app)

    def _request_of(self, req) -> Request:
        return Request("GRPC", req.route or "/", {},
                       bytes(req.payload) if req.payload else b"null",
                       dict(req.headers))

    def _call(self, req, context):
        pb = self._pb
        handle = self._resolve(req)
        if handle is None:
            return pb.ServeReply(status=404,
                                 error=f"no application at {req.route!r}")
        if req.method:
            handle = handle.options(method_name=req.method)
        trace = mint_request_trace(dict(req.headers))
        t0 = time.time()
        if trace is not None:
            handle = handle.options(trace_ctx=(trace[0], trace[2]))
        try:
            result = handle.remote(self._request_of(req)).result(
                timeout_s=req.timeout_s or 60.0)
            record_request_span(trace, t0, proxy="grpc",
                                route=req.route or "/", method="GRPC")
            return pb.ServeReply(status=200, is_final=True,
                                 payload=json.dumps(result).encode())
        except Exception as e:  # noqa: BLE001 -> typed error frame
            record_request_span(trace, t0, proxy="grpc",
                                route=req.route or "/", method="GRPC",
                                status="error")
            return pb.ServeReply(status=500,
                                 error=f"{type(e).__name__}: {e}")

    def _call_stream(self, req, context) -> Iterator:
        """Unary-stream: each yielded item of a streaming deployment
        method becomes one ServeReply frame (token streams for the LLM
        replicas ride this).  A client cancel surfaces here as
        GeneratorExit at the yield; it propagates to the replica
        (cancel_stream) so the engine aborts the generation."""
        pb = self._pb
        handle = self._resolve(req)
        if handle is None:
            yield pb.ServeReply(status=404, is_final=True,
                                error=f"no application at {req.route!r}")
            return
        handle = handle.options(stream=True,
                                method_name=req.method or None)
        trace = mint_request_trace(dict(req.headers))
        t0 = time.time()
        if trace is not None:
            handle = handle.options(trace_ctx=(trace[0], trace[2]))
        it = None
        items = 0
        status = "ok"
        try:
            gen = handle.remote(self._request_of(req))
            it = iter(gen)
            t_deliver = time.time()
            for item in it:
                yield pb.ServeReply(status=200,
                                    payload=json.dumps(item).encode())
                _STREAM_TOKENS.inc(tags={"proxy": "grpc"})
                items += 1
        except GeneratorExit:
            # Client cancelled the RPC mid-stream.
            _STREAM_DISCONNECTS.inc(tags={"proxy": "grpc"})
            status = "cancelled"
            gen.cancel()
            if it is not None:
                it.close()
            raise
        except Exception as e:  # noqa: BLE001
            status = "error"
            yield pb.ServeReply(status=500, is_final=True,
                                error=f"{type(e).__name__}: {e}")
            return
        finally:
            if trace is not None:
                tracing.record_span(
                    "serve.stream", t_deliver if it is not None else t0,
                    time.time(),
                    attributes={"items": items,
                                "completed": status == "ok"},
                    parent_id=trace[2], trace_id=trace[0], force=True)
            record_request_span(trace, t0, proxy="grpc",
                                route=req.route or "/", method="GRPC",
                                status=status, items=items)
        yield pb.ServeReply(status=200, is_final=True)

    def _list_routes(self, req, context):
        with self._routes_lock:
            routes = dict(self._routes)
        return self._pb.RouteListing(routes={
            prefix: f"{entry[0]}/{entry[1]}"
            for prefix, entry in routes.items()})
