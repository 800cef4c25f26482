"""Serve configuration dataclasses.

Counterpart of the reference's serve config surface
(python/ray/serve/config.py, python/ray/serve/_private/config.py):
DeploymentConfig (replica counts, per-replica concurrency), the
queue-length-driven AutoscalingConfig (serve/_private/autoscaling_policy.py),
and the HTTP ingress options.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """Queue-based replica autoscaling (reference autoscaling_policy.py:
    desired = ceil(total_ongoing_requests / target_ongoing_requests)).

    Timing knobs are in seconds and deliberately small-able for tests.
    """

    min_replicas: int = 1
    max_replicas: int = 10
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 30.0
    # exponential smoothing factor applied to the ongoing-request signal
    smoothing_factor: float = 1.0

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    user_config: Optional[Any] = None
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 10.0
    graceful_shutdown_timeout_s: float = 5.0
    autoscaling_config: Optional[AutoscalingConfig] = None
    # resources for each replica actor
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    # Disaggregated serving role: "prefill" and "decode" pools split the
    # two LLM phases across replica sets (KV pages handed off over the
    # object plane); "mixed" — the default — is today's
    # everything-everywhere behavior and changes nothing.
    role: str = "mixed"

    def __post_init__(self):
        if self.role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"role must be 'mixed', 'prefill' or 'decode', "
                f"got {self.role!r}")

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        if self.autoscaling_config is not None:
            d["autoscaling_config"] = self.autoscaling_config.to_dict()
        return d


@dataclass
class HTTPOptions:
    host: str = "127.0.0.1"
    port: int = 8000


def config_hash(*parts: Any) -> str:
    """Stable hash of config material; drives replica replacement decisions
    (lightweight version of the reference's deployment version,
    serve/_private/deployment_state.py DeploymentVersion)."""

    def default(o):
        if hasattr(o, "to_dict"):
            return o.to_dict()
        return repr(o)

    blob = json.dumps(parts, sort_keys=True, default=default).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


# -- status schema (reference serve/schema.py) ------------------------------

@dataclass
class ReplicaStatus:
    replica_id: str
    state: str  # STARTING | RUNNING | UNHEALTHY | STOPPING
    actor_hex: str = ""


@dataclass
class DeploymentStatus:
    name: str
    status: str  # UPDATING | HEALTHY | UNHEALTHY | UPSCALING | DOWNSCALING
    replicas: list = field(default_factory=list)
    message: str = ""


@dataclass
class ApplicationStatus:
    name: str
    status: str  # DEPLOYING | RUNNING | DEPLOY_FAILED | DELETING
    deployments: Dict[str, DeploymentStatus] = field(default_factory=dict)
    message: str = ""
