"""ray_tpu_torch.serve: model serving on the ray_tpu_torch actor runtime.

Port of ray_tpu/serve/, imports renamed.  Two departures: llm.py's engine
loop (see LLMServer), and the controller skips autoscaling for an
application that is being deleted.

Counterpart of Ray Serve (python/ray/serve/): deployments + applications,
a controller actor reconciling replica actors, pow-2 routing, an HTTP
ingress proxy, dynamic batching, model multiplexing, and queue-based
replica autoscaling.  GPU-first: replicas are the unit that owns a card
(or a share of one, `ray_actor_options={"num_gpus": 0.5}`), and
@serve.batch keeps device batches full.
"""

from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    proxy_address,
    run,
    shutdown,
    start,
    start_frame_ingress,
    start_grpc_ingress,
    status,
)
from ray_tpu_torch.serve.asgi import asgi_app, ingress
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import (
    ApplicationStatus,
    AutoscalingConfig,
    DeploymentConfig,
    DeploymentStatus,
    HTTPOptions,
)
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.proxy import Request
from ray_tpu_torch.serve.replica import get_replica_context

__all__ = [
    "deployment",
    "Deployment",
    "Application",
    "run",
    "start",
    "shutdown",
    "delete",
    "status",
    "get_app_handle",
    "get_deployment_handle",
    "proxy_address",
    "start_frame_ingress",
    "start_grpc_ingress",
    "DeploymentHandle",
    "DeploymentResponse",
    "AutoscalingConfig",
    "DeploymentConfig",
    "HTTPOptions",
    "ApplicationStatus",
    "DeploymentStatus",
    "batch",
    "multiplexed",
    "get_multiplexed_model_id",
    "get_replica_context",
    "Request",
    "ingress",
    "asgi_app",
]

# Feature-usage tag (util/usage_stats.py; local-only, no egress).
from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu
_rlu("serve")
del _rlu
