"""@remote task API (counterpart of python/ray/remote_function.py)."""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.core.runtime import func_content_id, get_runtime


class RemoteFunction:
    def __init__(self, fn, *, num_returns: int = 1,
                 num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 max_retries: int = 3,
                 runtime_env: Optional[dict] = None,
                 scheduling_strategy=None,
                 name: str = ""):
        if not (num_returns == "streaming"
                or (isinstance(num_returns, int) and num_returns >= 1)):
            raise ValueError(
                f"num_returns must be a positive int or 'streaming', "
                f"got {num_returns!r}")
        self._fn = fn
        self._num_returns = num_returns
        self._num_cpus = 1.0 if num_cpus is None else num_cpus
        self._num_gpus = num_gpus or 0.0
        self._resources = dict(resources or {})
        self._max_retries = max_retries
        self._runtime_env = runtime_env
        self._scheduling_strategy = scheduling_strategy
        self._name = name or getattr(fn, "__qualname__", "anonymous_task")
        self._blob: Optional[bytes] = None
        self._func_id: Optional[str] = None
        functools.update_wrapper(self, fn)

    def _resource_demand(self) -> Dict[str, float]:
        demand = dict(self._resources)
        if self._num_cpus:
            demand["CPU"] = self._num_cpus
        if self._num_gpus:
            demand["GPU"] = self._num_gpus
        return demand

    def _ensure_blob(self):
        if self._blob is None:
            self._blob = cloudpickle.dumps(self._fn)
            self._func_id = func_content_id(self._blob)
        return self._func_id, self._blob

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._name!r} cannot be called directly; "
            f"use {self._name}.remote(...)")

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core.task_spec import KwargsMarker

        func_id, blob = self._ensure_blob()
        call_args = list(args)
        if kwargs:
            call_args.append(KwargsMarker(kwargs))
        # Opt-in tracing (util/tracing.py — reference tracing_helper wraps
        # _remote the same way): the submission span stays OPEN across
        # submit_task so the spec's trace_ctx names it as parent — the
        # worker-side execution span links to it, stitching the
        # driver→worker hop without extra wire traffic.
        from ray_tpu_torch.util import tracing
        if tracing.is_tracing_enabled():
            attrs: Dict[str, Any] = {}
            with tracing.trace_span(f"submit:{self._name}", attrs):
                refs = self._submit(func_id, blob, call_args)
            attrs["object_ref"] = (refs.task_id.hex()
                                   if self._num_returns == "streaming"
                                   else refs[0].hex())
        else:
            refs = self._submit(func_id, blob, call_args)
        if self._num_returns == 1:
            return refs[0]
        return refs

    def _submit(self, func_id, blob, call_args):
        return get_runtime().submit_task(
            func_id, blob, call_args,
            num_returns=self._num_returns,
            resources=self._resource_demand(),
            max_retries=self._max_retries,
            name=self._name,
            runtime_env=self._runtime_env,
            scheduling_strategy=self._scheduling_strategy,
        )

    def bind(self, *args, **kwargs):
        """Author a DAG node (reference dag/): not ported yet."""
        raise NotImplementedError(
            ".bind() (dag/) is not ported yet: ROADMAP Queue A item 7")

    def options(self, **overrides):
        """Return a copy with overridden submit options."""
        opts = {
            "num_returns": self._num_returns,
            "num_cpus": self._num_cpus,
            "num_gpus": self._num_gpus,
            "resources": self._resources,
            "max_retries": self._max_retries,
            "runtime_env": self._runtime_env,
            "scheduling_strategy": self._scheduling_strategy,
            "name": self._name,
        }
        opts.update(overrides)
        clone = RemoteFunction(self._fn, **opts)
        clone._blob = self._blob
        clone._func_id = self._func_id
        return clone
