"""DeploymentHandle / DeploymentResponse: the composition-and-calling API.

Counterpart of python/ray/serve/handle.py (DeploymentHandle :714): a
picklable handle that routes calls through the per-process Router and
returns DeploymentResponse futures.  Responses can be passed as arguments
to other handle calls (model composition) — the underlying ObjectRef is
forwarded so the downstream replica awaits the value, not the caller.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.serve.router import Router

MAX_DATA_PLANE_RETRIES = 3


class DeploymentResponse:
    def __init__(self, handle: "DeploymentHandle", method: str,
                 args: tuple, kwargs: dict):
        self._handle = handle
        self._method = method
        self._args = args
        self._kwargs = kwargs
        self._lock = threading.Lock()
        self._ref: Optional[ObjectRef] = None
        self._assigned_hex: Optional[str] = None
        self._released = False
        self._submit()

    def _submit(self):
        h = self._handle
        hex_id, actor = h._router().assign_replica(
            timeout_s=h._assign_timeout_s,
            model_id=h._multiplexed_model_id,
            phase=h._phase, prefix_keys=h._prefix_hint,
            trace_id=h._trace_ctx[0] if h._trace_ctx else "")
        meta = {"multiplexed_model_id": h._multiplexed_model_id}
        if h._trace_ctx:
            # Request-journey context (trace_id, parent_span_id): rides
            # the request meta so replica-side spans parent under the
            # proxy's root span with zero extra wire traffic.
            meta["trace_ctx"] = list(h._trace_ctx)
        ref = getattr(actor, "handle_request").remote(
            self._method, self._args, self._kwargs, meta)
        with self._lock:
            self._assigned_hex = hex_id
            self._ref = ref
            self._released = False
        # release the in-flight slot when the result lands
        from ray_tpu_torch.core.runtime import get_runtime

        fut = get_runtime().as_future(ref)
        fut.add_done_callback(lambda _f: self._release())

    def _release(self):
        with self._lock:
            if self._released or self._assigned_hex is None:
                return
            self._released = True
            hex_id = self._assigned_hex
        self._handle._router().release(hex_id)

    def result(self, timeout_s: Optional[float] = 60.0) -> Any:
        """Resolve; retries through another replica if the assigned one
        died before/while executing (reference router retry semantics)."""
        attempts = 0
        while True:
            with self._lock:
                ref = self._ref
            try:
                return ray_tpu_torch.get(ref, timeout=timeout_s)
            except ray_tpu_torch.ActorError:
                self._release()
                self._handle._router().drop_replica(self._assigned_hex)
                attempts += 1
                if attempts >= MAX_DATA_PLANE_RETRIES:
                    raise
                self._submit()

    def _to_object_ref(self) -> ObjectRef:
        with self._lock:
            return self._ref

    def __reduce__(self):
        # Composition: ship the underlying ref; downstream resolves it.
        return (_identity, (self._to_object_ref(),))


def _identity(x):
    return x


class DeploymentResponseGenerator:
    """Streaming response: iterates the replica generator's yielded
    values as they arrive (reference DeploymentResponseGenerator;
    handle.options(stream=True))."""

    def __init__(self, handle: "DeploymentHandle", method: str,
                 args: tuple, kwargs: dict):
        import uuid

        h = handle
        self._handle = h
        hex_id, actor = h._router().assign_replica(
            timeout_s=h._assign_timeout_s,
            model_id=h._multiplexed_model_id,
            phase=h._phase, prefix_keys=h._prefix_hint,
            trace_id=h._trace_ctx[0] if h._trace_ctx else "")
        self._assigned_hex = hex_id
        self._actor = actor
        self._released = False
        self._cancelled = False
        # Per-stream cancellation token: Replica.cancel_stream(stream_id)
        # (via cancel() here, or a proxy that detected the client
        # disconnect) flags the in-replica generator to stop.
        self.stream_id = uuid.uuid4().hex
        meta = {"multiplexed_model_id": h._multiplexed_model_id,
                "stream_id": self.stream_id}
        if h._trace_ctx:
            meta["trace_ctx"] = list(h._trace_ctx)
        self._gen = actor.handle_request_streaming.options(
            num_returns="streaming").remote(method, args, kwargs, meta)

    @property
    def task_id(self):
        return self._gen.task_id

    def cancel(self):
        """Ask the replica to stop this stream (client went away).
        Cooperative: the in-replica generator observes its cancel event
        at the next yield and frees engine slots / KV pages.  Safe to
        call more than once."""
        if self._cancelled:
            return
        self._cancelled = True
        try:
            self._actor.cancel_stream.remote(self.stream_id)
        except Exception:  # raylint: allow-swallow(replica already dead; nothing left to cancel)
            pass

    def __iter__(self):
        try:
            for ref in self._gen:
                yield ray_tpu_torch.get(ref)
        except GeneratorExit:
            # Consumer dropped the stream mid-iteration: propagate the
            # cancellation to the replica before releasing the slot.
            self.cancel()
            raise
        finally:
            self._release()

    def _release(self):
        if not self._released:
            self._released = True
            self._handle._router().release(self._assigned_hex)

    def disown_stream(self):
        """Caller consumes by task id and owns cleanup (proxy paths):
        suppress the inner generator's own free-on-GC, whose position
        state never advanced and would park a stale free head-side."""
        self._gen.disown()

    def __del__(self):
        try:
            self._release()
        except Exception:
            pass


class DeploymentHandle:
    def __init__(self, deployment_name: str, app_name: str = "default",
                 method_name: str = "__call__"):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._method_name = method_name
        self._multiplexed_model_id = ""
        self._assign_timeout_s = 30.0
        self._stream = False
        # Disaggregated routing: phase ("prefill"|"decode") selects the
        # role pool; prefix_hint (truncated-hex page-chain keys) steers
        # prefill by prefix locality.  Empty = today's routing.
        self._phase = ""
        self._prefix_hint: Optional[list] = None
        # Request-journey trace context (trace_id, parent_span_id) set
        # by the ingress proxies (or user code continuing a trace);
        # None = untraced call, nothing extra rides the meta.
        self._trace_ctx: Optional[tuple] = None

    def _router(self) -> Router:
        from ray_tpu_torch.serve.api import _get_controller

        return Router.get_or_create(
            self.app_name, self.deployment_name, _get_controller())

    def options(self, *, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                assign_timeout_s: Optional[float] = None,
                stream: Optional[bool] = None,
                phase: Optional[str] = None,
                prefix_hint: Optional[list] = None,
                trace_ctx: Optional[tuple] = None
                ) -> "DeploymentHandle":
        h = DeploymentHandle(self.deployment_name, self.app_name,
                             method_name or self._method_name)
        h._multiplexed_model_id = (
            multiplexed_model_id if multiplexed_model_id is not None
            else self._multiplexed_model_id)
        h._assign_timeout_s = (self._assign_timeout_s
                               if assign_timeout_s is None
                               else assign_timeout_s)
        h._stream = self._stream if stream is None else stream
        h._phase = self._phase if phase is None else phase
        h._prefix_hint = (self._prefix_hint if prefix_hint is None
                          else list(prefix_hint))
        h._trace_ctx = (self._trace_ctx if trace_ctx is None
                        else tuple(trace_ctx))
        return h

    def remote(self, *args, **kwargs):
        if self._stream:
            return DeploymentResponseGenerator(
                self, self._method_name, args, kwargs)
        return DeploymentResponse(self, self._method_name, args, kwargs)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def __reduce__(self):
        return (_rebuild_handle,
                (self.deployment_name, self.app_name, self._method_name))

    def __repr__(self):
        return (f"DeploymentHandle(app={self.app_name!r}, "
                f"deployment={self.deployment_name!r})")


def _rebuild_handle(deployment_name, app_name, method_name):
    return DeploymentHandle(deployment_name, app_name, method_name)
