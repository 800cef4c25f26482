"""Public serve API: run / delete / status / handles.

Counterpart of python/ray/serve/api.py (serve.run :535, serve.start,
serve.status, serve.get_app_handle / get_deployment_handle).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve.config import HTTPOptions
from ray_tpu_torch.serve.controller import (
    CONTROLLER_NAME,
    SERVE_NAMESPACE,
    get_or_create_controller,
)
from ray_tpu_torch.serve.deployment import Application, BoundDeployment, HandleMarker
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.router import Router

_state_lock = threading.Lock()
_controller = None


def _get_controller():
    global _controller
    with _state_lock:
        if _controller is None:
            _controller = get_or_create_controller()
        return _controller


def start(http_options: Optional[HTTPOptions] = None,
          proxy: bool = True):
    """Start (or connect to) the serve control plane; optionally bring up
    the HTTP proxy."""
    global _controller
    opts = http_options or HTTPOptions()
    with _state_lock:
        if _controller is None:
            _controller = get_or_create_controller(opts.host, opts.port)
        controller = _controller
    if proxy:
        ray_tpu_torch.get(controller.ensure_proxy.remote(), timeout=30)
    return controller


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/",
        blocking_timeout_s: float = 60.0,
        _blocking: bool = True) -> DeploymentHandle:
    """Deploy an application graph; returns a handle to its ingress."""
    controller = _get_controller()
    nodes = app._collect()  # noqa: SLF001
    ingress = nodes[-1]
    payload = []
    for node in nodes:
        payload.append({
            "name": node.deployment.name,
            "blob": _bind_blob(node, name),
            "config": node.deployment.config.to_dict(),
            "autoscaling": (
                node.deployment.config.autoscaling_config.to_dict()
                if node.deployment.config.autoscaling_config else None),
        })
    is_asgi = bool(getattr(ingress.deployment.func_or_class,
                           "__serve_asgi__", False))
    ray_tpu_torch.get(controller.deploy_application.remote(
        name, route_prefix, ingress.deployment.name, payload,
        is_asgi=is_asgi), timeout=30)
    if _blocking:
        _wait_for_app(controller, name, blocking_timeout_s)
    return DeploymentHandle(ingress.deployment.name, name)


def _bind_blob(node: BoundDeployment, app_name: str) -> bytes:
    def swap(a):
        if isinstance(a, BoundDeployment):
            return HandleMarker(a.deployment.name, app_name)
        if isinstance(a, Application):
            return HandleMarker(
                a._root.deployment.name, app_name)  # noqa: SLF001
        return a

    args = tuple(swap(a) for a in node.init_args)
    kwargs = {k: swap(v) for k, v in node.init_kwargs.items()}
    return cloudpickle.dumps(
        (node.deployment.func_or_class, args, kwargs))


def _wait_for_app(controller, name: str, timeout_s: float):
    deadline = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < deadline:
        statuses = ray_tpu_torch.get(controller.status.remote(), timeout=30)
        st = statuses.get(name)
        last = st
        if st is not None:
            if st.status == "RUNNING":
                return
            if st.status == "DEPLOY_FAILED":
                msgs = "; ".join(
                    d.message for d in st.deployments.values() if d.message)
                raise RuntimeError(
                    f"application {name!r} failed to deploy: {msgs}")
        time.sleep(0.1)
    raise TimeoutError(
        f"application {name!r} not RUNNING after {timeout_s}s "
        f"(last status: {last.status if last else 'unknown'})")


def delete(name: str, *, wait_s: float = 30.0):
    controller = _get_controller()
    ray_tpu_torch.get(controller.delete_application.remote(name), timeout=30)
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        statuses = ray_tpu_torch.get(controller.status.remote(), timeout=30)
        if name not in statuses:
            return
        time.sleep(0.1)


def status() -> Dict[str, Any]:
    return ray_tpu_torch.get(_get_controller().status.remote(), timeout=30)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = _get_controller()
    ingress = ray_tpu_torch.get(controller.get_ingress.remote(name), timeout=30)
    if ingress is None:
        raise ValueError(f"no application named {name!r}")
    return DeploymentHandle(ingress, name)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    controller = _get_controller()
    ok = ray_tpu_torch.get(controller.has_deployment.remote(
        app_name, deployment_name), timeout=30)
    if not ok:
        raise ValueError(
            f"no deployment {deployment_name!r} in app {app_name!r}")
    return DeploymentHandle(deployment_name, app_name)


def proxy_address() -> Optional[str]:
    """http://host:port of the ingress proxy (None if not started)."""
    return ray_tpu_torch.get(
        _get_controller().proxy_address.remote(), timeout=30)


def start_frame_ingress() -> str:
    """Start (idempotently) the frame-protocol ingress and return its
    host:port. Counterpart of enabling the reference's gRPC proxy
    (grpc_options on serve.start): non-HTTP clients send one JSON frame
    {"op": "serve_request", "route": ..., "payload": ...} over the
    framed RPC wire (core/rpc.py kind 3) — the same protocol the C++
    frontend speaks."""
    controller = _get_controller()
    ray_tpu_torch.get(controller.ensure_frame_proxy.remote(), timeout=30)
    return ray_tpu_torch.get(controller.frame_proxy_address.remote(), timeout=30)


def start_grpc_ingress() -> str:
    """Start (idempotently) the typed gRPC ingress and return its
    host:port.  The wire contract is ray_tpu_torch/serve/protos/serve.proto
    (service ray_tpu.serve.ServeAPI, the reference's name: Call /
    CallStream / ListRoutes / Healthz) — the counterpart of the reference's gRPC proxy + serve
    proto schema (serve/_private/proxy.py:540, protobuf/serve.proto)."""
    controller = _get_controller()
    ray_tpu_torch.get(controller.ensure_grpc_proxy.remote(), timeout=30)
    return ray_tpu_torch.get(controller.grpc_proxy_address.remote(), timeout=30)


def shutdown():
    """Tear down all applications and the serve control plane."""
    global _controller
    with _state_lock:
        controller = _controller
        _controller = None
    Router.reset_all()
    if controller is None:
        try:
            controller = ray_tpu_torch.get_actor(
                CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
        except (ValueError, Exception):
            return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if not ray_tpu_torch.get(controller.status.remote(), timeout=30):
                break
            time.sleep(0.1)
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
