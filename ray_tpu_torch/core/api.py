"""Public API: init / shutdown / remote / get / put / wait / actors.

Counterpart of python/ray/_private/worker.py's public functions
(ray.init :1225, ray.get :2576, ray.put :2691, ray.wait :2756,
ray.remote :3149, ray.get_actor :2902).
"""

from __future__ import annotations

import inspect
from typing import Any, List, Optional, Sequence, Union

from ray_tpu_torch.core import runtime as _runtime_mod
from ray_tpu_torch.core.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.actor import method as method  # noqa: PLC0414 re-export
from ray_tpu_torch.core.driver import DriverRuntime
from ray_tpu_torch.core.exceptions import RayTpuError
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction


def init(num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[dict] = None,
         namespace: str = "",
         address: Optional[str] = None,
         ignore_reinit_error: bool = True,
         log_to_driver: bool = True,
         logging_config=None,
         _system_config: Optional[dict] = None) -> DriverRuntime:
    """Start the single-host runtime (control plane + worker pool), or —
    with ``address=`` — connect this driver to a running cluster
    ("auto" resolves ``RAY_TPU_ADDRESS`` or the port's own address file,
    ``<tmpdir>/ray_tpu_torch/cluster_address``; a head of the JAX package
    is refused at registration, core/runtime.py).

    logging_config: a LoggingConfig applied to this driver and inherited
    by workers this process spawns (core/logging_config.py).  In connect
    mode (address=...) remote workers are spawned by the cluster's own
    daemons and keep the config the cluster was started with."""
    from ray_tpu_torch.core import knobs as _knobs

    _knobs.apply_interpreter_tuning()
    rt = _runtime_mod._global_runtime
    if rt is not None and getattr(rt, "is_initialized", False):
        if ignore_reinit_error:
            if logging_config is not None:
                import logging as _logging

                _logging.getLogger(__name__).warning(
                    "init(logging_config=...) ignored: runtime already "
                    "initialized (call shutdown() first)")
            return rt
        raise RayTpuError("ray_tpu_torch.init() called twice")
    if address == "auto":
        address = _resolve_cluster_address()
    if logging_config is not None:
        from ray_tpu_torch.core import logging_config as _lc

        if address:
            import logging as _logging

            _logging.getLogger(__name__).warning(
                "logging_config applies to this driver only: cluster "
                "daemons at %s spawn workers with their own environment",
                address)
        _lc.apply(logging_config)
        _lc.export_to_env(logging_config)
        global _logging_config_exported
        _logging_config_exported = True
    return DriverRuntime(
        num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
        namespace=namespace, address=address,
        log_to_driver=log_to_driver,
        _system_config=_system_config)


def _resolve_cluster_address() -> str:
    import os

    from ray_tpu_torch.core.config import address_file

    env = os.environ.get("RAY_TPU_ADDRESS")
    if env and env != "auto":
        return env
    path = address_file()
    try:
        with open(path) as f:
            return f.read().strip()
    except FileNotFoundError:
        raise RayTpuError(
            "address='auto' but no running cluster found (no "
            f"RAY_TPU_ADDRESS env var and no {path})") from None


def is_initialized() -> bool:
    rt = _runtime_mod._global_runtime
    return rt is not None and getattr(rt, "is_initialized", False)


_logging_config_exported = False


def shutdown():
    rt = _runtime_mod._global_runtime
    if rt is not None and hasattr(rt, "shutdown"):
        rt.shutdown()
    # Session config must not leak into the next init — but only pop what
    # init() itself exported (a user-exported variable is theirs to keep).
    global _logging_config_exported
    if _logging_config_exported:
        from ray_tpu_torch.core import logging_config as _lc

        _lc.export_to_env(None)
        _logging_config_exported = False


def remote(*args, **kwargs):
    """Decorator: @remote or @remote(num_cpus=..., num_gpus=..., ...)."""

    def make(obj):
        if inspect.isclass(obj):
            valid = {"num_cpus", "num_gpus", "resources", "max_restarts",
                     "max_task_retries",
                     "max_concurrency", "concurrency_groups", "name",
                     "namespace", "lifetime", "runtime_env",
                     "scheduling_strategy"}
            opts = {k: v for k, v in kwargs.items() if k in valid}
            return ActorClass(obj, **opts)
        valid = {"num_returns", "num_cpus", "num_gpus", "resources",
                 "max_retries", "runtime_env", "scheduling_strategy"}
        opts = {k: v for k, v in kwargs.items() if k in valid}
        return RemoteFunction(obj, **opts)

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return make(args[0])
    if args:
        raise TypeError("@remote takes only keyword arguments")
    return make


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        timeout: Optional[float] = None):
    rt = _runtime_mod.get_runtime()
    if isinstance(refs, ObjectRef):
        return rt.get([refs], timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects ObjectRef or list, got {type(refs)}")
    return rt.get(list(refs), timeout)


def put(value: Any) -> ObjectRef:
    return _runtime_mod.get_runtime().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    return _runtime_mod.get_runtime().wait(
        list(refs), num_returns=num_returns, timeout=timeout)


def get_runtime_context():
    """Identity/context of the current process (reference:
    ray.get_runtime_context(), python/ray/runtime_context.py)."""
    from ray_tpu_torch.core.runtime_context import get_runtime_context as _grc

    return _grc()


def register_named_function(name: str, fn) -> str:
    """Register a Python function for cross-language invocation (the
    reference's FunctionDescriptor story): C++ clients submit it by name
    via submit_named_task (see cpp/). Returns the function id."""
    import cloudpickle

    from ray_tpu_torch.core.runtime import func_content_id

    rt = _runtime_mod.get_runtime()
    blob = cloudpickle.dumps(fn)
    func_id = func_content_id(blob)
    rt.core.ensure_func(func_id, blob)
    rt.kv().call({"op": "kv_put", "key": f"__named_fn__/{name}",
                  "value": func_id.encode(), "overwrite": True})
    return func_id


def cancel(ref: ObjectRef, *, force: bool = False) -> bool:
    """Cancel the task producing ``ref``.  Pending tasks are always
    cancellable; running tasks only with force=True (worker is killed)."""
    rt = _runtime_mod.get_runtime()
    core = getattr(rt, "core", None)
    if core is not None:
        # Owner-side first: lease-path tasks never reached the head
        # (reference: cancellation is owner-initiated, CancelTask
        # core_worker.proto:441).
        return core.cancel_ref(ref.hex(), force=force)
    return bool(rt.kv().call(
        {"op": "cancel_object", "obj": ref.hex(), "force": force}))


def kill(actor: ActorHandle, *, no_restart: bool = True):
    _runtime_mod.get_runtime().kill_actor(
        actor._actor_hex, no_restart=no_restart)


def get_actor(name: str, namespace: str = "") -> ActorHandle:
    info = _runtime_mod.get_runtime().get_named_actor(name, namespace)
    if info is None:
        raise ValueError(f"Failed to look up actor {name!r}")
    return ActorHandle(info["actor"], info["class_id"].split(":")[0])


def cluster_resources() -> dict:
    return _runtime_mod.get_runtime().cluster_resources()


def available_resources() -> dict:
    return _runtime_mod.get_runtime().available_resources()


def nodes() -> list:
    """Cluster membership with resources and liveness (counterpart of
    ray.nodes(), python/ray/_private/worker.py; served from the state
    API's node table — on workers, from the locally synced view)."""
    return _runtime_mod.get_runtime().state_list("nodes")


def timeline(filename=None):
    """Chrome-trace dump of task state transitions (counterpart of
    ray.timeline(), python/ray/_private/state.py:434).  Returns the
    event list; with ``filename`` also writes chrome://tracing JSON."""
    from ray_tpu_torch.util.timeline import timeline as _timeline

    return _timeline(filename)


def get_accelerator_ids() -> dict:
    """Accelerator ids visible to this process, keyed by resource name
    (counterpart of ray.get_runtime_context().get_accelerator_ids())."""
    return {"GPU": get_gpu_ids()}


def get_gpu_ids() -> list:
    """The GPU ids this process sees (ray.get_gpu_ids()): the entries of
    CUDA_VISIBLE_DEVICES, or every usable card when it is unset; a
    CPU-class worker, spawned with CUDA_VISIBLE_DEVICES="", gets [].
    Never initializes CUDA (core/resources.py)."""
    from ray_tpu_torch.core.resources import visible_gpu_ids

    return visible_gpu_ids()


def client(address: str = "auto"):
    """Thin-client connection (ray.client()): not ported yet."""
    raise NotImplementedError(
        "client() (util/client.py) is not ported yet: ROADMAP Queue A "
        "item 10")
