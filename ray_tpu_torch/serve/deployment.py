"""@serve.deployment decorator, Deployment objects, and application graphs.

Counterpart of python/ray/serve/deployment.py and the DAG-building side of
serve's model composition: `Deployment.bind(*args)` returns an Application
node; nested bound nodes become DeploymentHandles at replica init time
(reference: serve/_private/build_app.py).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


@dataclass
class HandleMarker:
    """Placeholder for a child deployment inside bound init args; replaced
    with a live DeploymentHandle when the replica constructs the user
    callable."""

    deployment_name: str
    app_name: str = ""  # filled at deploy time


class Application:
    """A bound deployment graph rooted at an ingress node."""

    def __init__(self, root: "BoundDeployment"):
        self._root = root

    def _collect(self) -> List["BoundDeployment"]:
        """All bound nodes reachable from the root, de-duplicated by
        deployment name, root last (children deploy first)."""
        seen: Dict[str, BoundDeployment] = {}

        def visit(node: BoundDeployment):
            for a in list(node.init_args) + list(node.init_kwargs.values()):
                if isinstance(a, Application):
                    a = a._root
                if isinstance(a, BoundDeployment):
                    visit(a)
            prev = seen.get(node.deployment.name)
            if prev is not None and prev is not node:
                raise ValueError(
                    f"two different deployments named "
                    f"{node.deployment.name!r} in one application")
            seen[node.deployment.name] = node

        visit(self._root)
        return list(seen.values())


@dataclass
class BoundDeployment:
    deployment: "Deployment"
    init_args: Tuple[Any, ...] = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)


class Deployment:
    def __init__(self, func_or_class: Any, name: str,
                 config: DeploymentConfig,
                 route_prefix: Optional[str] = None,
                 version: str = ""):
        self._func_or_class = func_or_class
        self.name = name
        self.config = config
        self.route_prefix = route_prefix
        self.version = version

    @property
    def func_or_class(self):
        return self._func_or_class

    def bind(self, *args, **kwargs) -> Application:
        return Application(BoundDeployment(self, args, kwargs))

    def options(self, *, num_replicas: Optional[Any] = None,
                max_ongoing_requests: Optional[int] = None,
                user_config: Optional[Any] = None,
                autoscaling_config: Optional[AutoscalingConfig] = None,
                ray_actor_options: Optional[Dict[str, Any]] = None,
                health_check_period_s: Optional[float] = None,
                health_check_timeout_s: Optional[float] = None,
                graceful_shutdown_timeout_s: Optional[float] = None,
                role: Optional[str] = None,
                name: Optional[str] = None,
                version: Optional[str] = None,
                route_prefix: Optional[str] = "__unset__") -> "Deployment":
        cfg = DeploymentConfig(**{**self.config.to_dict()})
        if isinstance(cfg.autoscaling_config, dict):
            cfg.autoscaling_config = AutoscalingConfig(
                **cfg.autoscaling_config)
        if num_replicas is not None:
            if num_replicas == "auto":
                cfg.autoscaling_config = (autoscaling_config
                                          or AutoscalingConfig())
            else:
                cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if user_config is not None:
            cfg.user_config = user_config
        if autoscaling_config is not None:
            cfg.autoscaling_config = autoscaling_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if health_check_timeout_s is not None:
            cfg.health_check_timeout_s = health_check_timeout_s
        if graceful_shutdown_timeout_s is not None:
            cfg.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        if role is not None:
            cfg.role = role
        return Deployment(
            self._func_or_class,
            name if name is not None else self.name,
            cfg,
            route_prefix=(self.route_prefix if route_prefix == "__unset__"
                          else route_prefix),
            version=version if version is not None else self.version,
        )


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: Any = None,
               max_ongoing_requests: int = 8,
               user_config: Optional[Any] = None,
               autoscaling_config: Optional[AutoscalingConfig] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               health_check_period_s: float = 2.0,
               health_check_timeout_s: float = 10.0,
               graceful_shutdown_timeout_s: float = 5.0,
               role: str = "mixed",
               version: str = ""):
    """Decorator: turn a class or function into a servable Deployment."""

    def wrap(obj):
        cfg = DeploymentConfig(
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config,
            autoscaling_config=autoscaling_config,
            ray_actor_options=dict(ray_actor_options or {}),
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            role=role,
        )
        if num_replicas == "auto":
            cfg.autoscaling_config = (autoscaling_config
                                      or AutoscalingConfig())
        elif num_replicas is not None:
            cfg.num_replicas = int(num_replicas)
        return Deployment(
            obj,
            name or getattr(obj, "__name__", "deployment"),
            cfg,
            version=version,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


def make_callable(func_or_class: Any, args: tuple, kwargs: dict) -> Any:
    """Instantiate the user callable inside a replica."""
    if inspect.isclass(func_or_class):
        return func_or_class(*args, **kwargs)
    if args or kwargs:
        raise ValueError("function deployments take no init args")
    return _FunctionWrapper(func_or_class)


class _FunctionWrapper:
    def __init__(self, fn: Callable):
        self._fn = fn

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)
