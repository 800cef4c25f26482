"""Actor API: ActorClass / ActorHandle / ActorMethod.

Counterpart of python/ray/actor.py: @remote on a class yields an ActorClass
whose .remote() registers the actor with the control plane and returns a
handle; handle.method.remote() submits ordered tasks directly to the actor's
worker process (peer-to-peer, reference direct_actor_task_submitter.cc).
Handles are picklable and can be passed into tasks/other actors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.core.runtime import func_content_id, get_runtime


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core.streaming import STREAMING
        from ray_tpu_torch.core.task_spec import KwargsMarker

        call_args = list(args)
        if kwargs:
            call_args.append(KwargsMarker(kwargs))
        refs = get_runtime().submit_actor_task(
            self._handle._actor_hex, self._method_name, call_args,
            num_returns=self._num_returns)
        if self._num_returns == STREAMING:
            return refs  # an ObjectRefGenerator
        if self._num_returns == 1:
            return refs[0]
        return refs

    def options(self, num_returns=1):
        return ActorMethod(self._handle, self._method_name, num_returns)

    def bind(self, *args, **kwargs):
        """Author a DAG node (reference dag/): not ported yet."""
        raise NotImplementedError(
            ".bind() (dag/) is not ported yet: ROADMAP Queue A item 7")


class ActorHandle:
    def __init__(self, actor_hex: str, class_name: str = ""):
        self._actor_hex = actor_hex
        self._class_name = class_name
        get_runtime().subscribe_actor(actor_hex)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_hex[:8]})"

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_hex, self._class_name))

    @property
    def actor_id(self):
        from ray_tpu_torch.core.ids import ActorID

        return ActorID.from_hex(self._actor_hex)

    def _wait_until_ready(self, timeout: Optional[float] = None):
        st = get_runtime().wait_actor_alive(self._actor_hex, timeout)
        if st["state"] == "DEAD":
            from ray_tpu_torch.core.exceptions import ActorDiedError

            raise ActorDiedError(self._actor_hex, st.get("reason", ""))
        return self


def _rebuild_handle(actor_hex: str, class_name: str):
    return ActorHandle(actor_hex, class_name)


def method(*, concurrency_group: Optional[str] = None):
    """Method decorator (reference ray.method): annotate an actor method
    with its concurrency group.

        @ray_tpu_torch.remote(concurrency_groups={"io": 2, "compute": 1})
        class A:
            @ray_tpu_torch.method(concurrency_group="io")
            def fetch(self): ...

    (Per-method num_returns rides ActorMethod.options(num_returns=...)
    at the call site instead.)"""

    def decorator(fn):
        if concurrency_group is not None:
            fn.__concurrency_group__ = concurrency_group
        return fn

    return decorator


class ActorClass:
    def __init__(self, cls, *, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 max_restarts: int = 0,
                 max_task_retries: int = 0,
                 max_concurrency: int = 1,
                 concurrency_groups: Optional[Dict[str, int]] = None,
                 name: str = "",
                 namespace: str = "",
                 lifetime: str = "",
                 runtime_env: Optional[dict] = None,
                 scheduling_strategy=None):
        self._cls = cls
        self._num_cpus = 1.0 if num_cpus is None else num_cpus
        self._num_gpus = num_gpus or 0.0
        self._resources = dict(resources or {})
        self._max_restarts = max_restarts
        self._max_task_retries = max_task_retries
        # max_concurrency is the SYNC-method thread count. Async methods
        # always overlap: the worker schedules coroutines on the actor's
        # event loop without parking a thread per call (worker.py
        # _execute_async_actor_task), so async actors need no bump here.
        self._max_concurrency = max_concurrency
        # Named concurrency groups: each group gets its own executor
        # pool in the hosting worker (reference
        # concurrency_group_manager.cc); methods pick a group via
        # @ray_tpu_torch.method(concurrency_group=...).
        self._concurrency_groups = dict(concurrency_groups or {})
        self._name = name
        self._namespace = namespace
        self._runtime_env = runtime_env
        self._scheduling_strategy = scheduling_strategy
        self._blob: Optional[bytes] = None
        self._class_id: Optional[str] = None

    def _resource_demand(self) -> Dict[str, float]:
        demand = dict(self._resources)
        if self._num_cpus:
            demand["CPU"] = self._num_cpus
        if self._num_gpus:
            demand["GPU"] = self._num_gpus
        return demand

    def _ensure_blob(self):
        if self._blob is None:
            self._blob = cloudpickle.dumps(self._cls)
            self._class_id = (
                f"{self._cls.__name__}:{func_content_id(self._blob)}")
        return self._class_id, self._blob

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote(...)")

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core.task_spec import KwargsMarker

        class_id, blob = self._ensure_blob()
        call_args = list(args)
        if kwargs:
            call_args.append(KwargsMarker(kwargs))
        actor_id = get_runtime().create_actor(
            class_id, blob, call_args,
            resources=self._resource_demand(),
            max_restarts=self._max_restarts,
            max_task_retries=self._max_task_retries,
            name=self._name,
            namespace=self._namespace,
            max_concurrency=self._max_concurrency,
            concurrency_groups=self._concurrency_groups,
            runtime_env=self._runtime_env,
            scheduling_strategy=self._scheduling_strategy,
        )
        return ActorHandle(actor_id.hex(), self._cls.__name__)

    def options(self, **overrides):
        opts = {
            "num_cpus": self._num_cpus,
            "num_gpus": self._num_gpus,
            "resources": self._resources,
            "max_restarts": self._max_restarts,
            "max_task_retries": self._max_task_retries,
            "max_concurrency": self._max_concurrency,
            "concurrency_groups": self._concurrency_groups,
            "name": self._name,
            "namespace": self._namespace,
            "runtime_env": self._runtime_env,
            "scheduling_strategy": self._scheduling_strategy,
        }
        opts.update(overrides)
        opts.pop("lifetime", None)
        clone = ActorClass(self._cls, **opts)
        clone._blob = self._blob
        clone._class_id = self._class_id
        return clone
