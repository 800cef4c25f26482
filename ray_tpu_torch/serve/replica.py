"""Replica actor: hosts one copy of a deployment's user callable.

Counterpart of python/ray/serve/_private/replica.py — wraps the user
callable, counts ongoing requests (the router's pow-2 signal), exposes
health checks and user_config reconfiguration, and drains gracefully.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.serve.deployment import HandleMarker, make_callable
from ray_tpu_torch.util import tracing

_replica_context = threading.local()


class ReplicaContext:
    def __init__(self, app_name: str, deployment: str, replica_id: str):
        self.app_name = app_name
        self.deployment = deployment
        self.replica_id = replica_id


def get_replica_context() -> Optional[ReplicaContext]:
    return getattr(_replica_context, "ctx", None)


class RequestContext:
    """Per-request metadata (thread-local inside the replica)."""

    def __init__(self, multiplexed_model_id: str = "",
                 route: str = "", stream_id: str = "",
                 trace_ctx=None):
        self.multiplexed_model_id = multiplexed_model_id
        self.route = route
        # Streaming cancellation: proxies mint a stream_id per streaming
        # call; Replica.cancel_stream(stream_id) sets cancel_event, and
        # cooperative generators (LLMServer.generate_stream) poll it to
        # abort mid-generation when the client disconnects.
        self.stream_id = stream_id
        self.cancel_event: Optional[threading.Event] = None
        # Multiplex pins held by this request ((cache, model_id) pairs,
        # appended by @serve.multiplexed getters); released when the
        # request finishes so the LRU never evicts an in-use model.
        self.model_pins: list = []
        # Request-journey trace context (trace_id, parent_span_id) from
        # the ingress proxy (handle meta); span_id is this replica
        # call's own pre-allocated span so user code (LLMServer) can
        # parent engine phase spans under it before it is recorded.
        self.trace_ctx: Optional[tuple] = (
            tuple(trace_ctx) if trace_ctx else None)
        self.span_id: str = ""


def get_request_context() -> RequestContext:
    ctx = getattr(_replica_context, "request", None)
    return ctx if ctx is not None else RequestContext()


def _live_request_context() -> Optional[RequestContext]:
    """The REAL per-request context, or None outside a replica request
    (get_request_context fabricates an unbound default in that case —
    unusable for anything that must survive until request end, like
    multiplex pins or cancel events)."""
    return getattr(_replica_context, "request", None)


class Replica:
    """The actor class the controller instantiates per replica.

    max_concurrency on the actor is set to max_ongoing_requests, so up to
    that many handle_request calls execute concurrently in threads.
    """

    def __init__(self, blob: bytes, app_name: str, deployment_name: str,
                 replica_id: str, user_config: Any = None,
                 role: str = "mixed"):
        func_or_class, init_args, init_kwargs = cloudpickle.loads(blob)
        init_args = tuple(self._resolve_marker(a) for a in init_args)
        init_kwargs = {k: self._resolve_marker(v)
                       for k, v in init_kwargs.items()}
        _replica_context.ctx = ReplicaContext(
            app_name, deployment_name, replica_id)
        self._app_name = app_name
        self._deployment_name = deployment_name
        self._replica_id = replica_id
        # Disaggregated-serving role (prefill|decode|mixed): advertised
        # in load_report so the router's phase-aware pools stay correct
        # even if the published entry lags a config change.
        self._role = role
        self._callable = make_callable(func_or_class, init_args, init_kwargs)
        self._ongoing = 0
        self._lock = threading.Lock()
        self._draining = False
        # stream_id -> cancel Event.  setdefault semantics on both the
        # register (streaming _prepare_call) and cancel sides, so a
        # cancel racing ahead of registration still lands; bounded so
        # cancels for already-finished streams can't grow it forever.
        self._streams: Dict[str, threading.Event] = {}
        if user_config is not None:
            self.reconfigure(user_config)

    @staticmethod
    def _resolve_marker(a: Any):
        if isinstance(a, HandleMarker):
            from ray_tpu_torch.serve.handle import DeploymentHandle

            return DeploymentHandle(a.deployment_name, a.app_name)
        return a

    # -- data plane -----------------------------------------------------
    def _prepare_call(self, method: str, args: tuple, kwargs: dict,
                      request_meta: Optional[dict]):
        """Shared data-plane prologue: resolve composition ObjectRefs
        (upstream DeploymentResponses arrive as refs, handle.py
        __reduce__), set the request context, bump the ongoing count,
        and resolve the target callable."""
        import ray_tpu_torch
        from ray_tpu_torch.core.object_ref import ObjectRef

        args = tuple(ray_tpu_torch.get(a) if isinstance(a, ObjectRef) else a
                     for a in args)
        kwargs = {k: ray_tpu_torch.get(v) if isinstance(v, ObjectRef) else v
                  for k, v in kwargs.items()}
        _replica_context.ctx = ReplicaContext(
            self._app_name, self._deployment_name, self._replica_id)
        ctx = RequestContext(**(request_meta or {}))
        if ctx.stream_id:
            ctx.cancel_event = self._stream_event(ctx.stream_id)
        if ctx.trace_ctx is not None:
            ctx.span_id = tracing.new_span_id()
            ctx._span_start = time.time()
            ctx._span_method = method
        _replica_context.request = ctx
        # Resolve the target BEFORE counting the request: a bad method
        # name must not inflate _ongoing with no matching decrement
        # (that would eventually read as a saturated replica).
        target = (self._callable if method == "__call__"
                  else getattr(self._callable, method))
        with self._lock:
            self._ongoing += 1
        return target, args, kwargs, ctx

    def _finish_call(self, ctx: Optional[RequestContext] = None):
        with self._lock:
            self._ongoing -= 1
            if ctx is not None and ctx.stream_id:
                self._streams.pop(ctx.stream_id, None)
        if ctx is not None:
            for cache, model_id in ctx.model_pins:
                cache.unpin(model_id)
            ctx.model_pins = []
            if ctx.trace_ctx is not None and ctx.span_id:
                # The replica leg of the request journey: recorded into
                # this process's span ring (forced — the cluster harvest
                # carries it off regardless of the local tracing flag).
                tracing.record_span(
                    "serve.replica", ctx._span_start, time.time(),
                    attributes={
                        "deployment": self._deployment_name,
                        "replica": self._replica_id,
                        "method": ctx._span_method,
                        "clock_off": round(tracing.clock_offset(), 6)},
                    parent_id=ctx.trace_ctx[1] or None,
                    trace_id=ctx.trace_ctx[0],
                    span_id=ctx.span_id, force=True)

    def _stream_event(self, stream_id: str) -> threading.Event:
        with self._lock:
            ev = self._streams.get(stream_id)
            if ev is None:
                if len(self._streams) >= 4096:
                    # Oldest-first bound: stale entries are cancels for
                    # streams that already finished.
                    self._streams.pop(next(iter(self._streams)))
                ev = self._streams[stream_id] = threading.Event()
            return ev

    def cancel_stream(self, stream_id: str) -> bool:
        """Flag a streaming request cancelled (client went away).  The
        request's generator observes cancel_event on its next yield and
        stops — freeing engine slots / KV pages instead of decoding for
        nobody.  Safe to call before the stream registers (the event is
        created set-ready) or after it finished (no-op)."""
        from ray_tpu_torch.util import flight_recorder

        self._stream_event(stream_id).set()
        flight_recorder.record("serve", "stream_cancel",
                               stream_id=stream_id,
                               replica_id=self._replica_id)
        return True

    def handle_request(self, method: str, args: tuple, kwargs: dict,
                       request_meta: Optional[dict] = None) -> Any:
        target, args, kwargs, ctx = self._prepare_call(
            method, args, kwargs, request_meta)
        try:
            return target(*args, **kwargs)
        finally:
            self._finish_call(ctx)

    def handle_request_streaming(self, method: str, args: tuple,
                                 kwargs: dict,
                                 request_meta: Optional[dict] = None):
        """Generator variant: the user callable's iterable result is
        yielded item by item; called with num_returns='streaming' so
        each item flows to the proxy/handle as its own object (the
        reference's streaming ASGI responses, proxy.py:761)."""
        target, args, kwargs, ctx = self._prepare_call(
            method, args, kwargs, request_meta)
        try:
            yield from target(*args, **kwargs)
        finally:
            self._finish_call(ctx)

    # -- control plane --------------------------------------------------
    def num_ongoing(self) -> int:
        return self._ongoing

    def load_report(self) -> Dict[str, Any]:
        """Load feedback for the router's P2C scoring: ongoing count,
        loaded multiplex model ids, and — when the user callable exposes
        stats()/load_report() (LLMServer does) — engine queue depth,
        active slots, and free KV pages.  The controller probes this on
        its reconcile cadence and publishes it on the replicas long-poll
        key, so reports piggyback existing control-plane traffic (the
        coalescing flusher batches them with health checks)."""
        from ray_tpu_torch.serve import multiplex

        report: Dict[str, Any] = {
            "replica_id": self._replica_id,
            "ts": time.time(),
            "ongoing": self._ongoing,
            "models": multiplex.loaded_model_ids(),
            "role": self._role,
        }
        user = getattr(self._callable, "load_report", None)
        if not callable(user):
            user = getattr(self._callable, "stats", None)
        if callable(user):
            try:
                extra = user()
            except Exception as e:  # noqa: BLE001
                import logging

                from ray_tpu_torch.core.log_once import warn_once

                warn_once(logging.getLogger(__name__),
                          "replica-load-report", e,
                          "user stats() failed in load_report: %r", e)
                extra = None
            if isinstance(extra, dict):
                if "waiting" in extra:
                    report["queue_depth"] = int(extra["waiting"])
                if "queue_depth" in extra:
                    report["queue_depth"] = int(extra["queue_depth"])
                if "active" in extra:
                    report["active_slots"] = int(extra["active"])
                if "free_pages" in extra:
                    report["free_kv_pages"] = int(extra["free_pages"])
                if "free_kv_pages" in extra:
                    report["free_kv_pages"] = int(extra["free_kv_pages"])
                if "prefix_digest" in extra:
                    # Hot-prefix digest (serve_prefix_digest message):
                    # the router prefix-matches request hints against
                    # it for prefill locality.
                    report["prefix_digest"] = extra["prefix_digest"]
                if extra.get("slo_samples"):
                    # Per-request SLO samples (TTFT/TPOT/queue-wait),
                    # drained from the engine's ring: the controller
                    # folds them into per-deployment sliding windows
                    # (serve_slo / /api/serve_slo).  Piggybacks the
                    # existing probe — zero new transport.
                    report["slo_samples"] = extra["slo_samples"]
                if "engine_sample" in extra:
                    # Latest per-step engine sampler aggregate (batch
                    # occupancy, prefill/decode token split, free KV
                    # pages).
                    report["engine_sample"] = extra["engine_sample"]
        return report

    def health_check(self) -> str:
        user_check = getattr(self._callable, "check_health", None)
        if callable(user_check):
            user_check()
        return "ok"

    def reconfigure(self, user_config: Any) -> None:
        fn = getattr(self._callable, "reconfigure", None)
        if callable(fn):
            fn(user_config)

    def metadata(self) -> Dict[str, Any]:
        return {
            "app": self._app_name,
            "deployment": self._deployment_name,
            "replica_id": self._replica_id,
        }

    def drain(self, timeout_s: float) -> bool:
        """Stop accepting work (router already removed us) and wait for
        in-flight requests; returns True when drained."""
        self._draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._ongoing == 0:
                    return True
            time.sleep(0.02)
        return self._ongoing == 0
