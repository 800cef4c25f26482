"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

The JAX package `ray_tpu` is the reference; this package mirrors its
layout (`core/`, `native/`, `accelerators/`, `models/`, `ops/`, `serve/`,
`train/`, `util/`) and never imports it or JAX.  The runtime (`core/`:
init / remote / get / put / wait / actors over the control plane and the
shared-memory object store) is the reference's, with GPUs in place of TPU
chips (`num_gpus`, the `GPU` resource) and torch tensors through the
object store.  Plain
tensor code is PyTorch; every Pallas TPU kernel on the ported path is a
CUDA kernel written by hand for Hopper (`csrc/`), built with nvcc at
first use (`ops/_build.py`) and held against a plain PyTorch version of
the same function in the same module.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; with no CUDA device present, any other request raises.
"""

from __future__ import annotations

from typing import Union

import torch

from ray_tpu_torch._version import __version__
from ray_tpu_torch.core.api import (
    available_resources,
    cancel,
    client,
    register_named_function,
    get_accelerator_ids,
    get_gpu_ids,
    get_runtime_context,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    method,
    remote,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    ActorError,
    GetTimeoutError,
    ObjectLostError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    TaskUnschedulableError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.logging_config import LoggingConfig
from ray_tpu_torch.core.object_ref import ObjectRef

DeviceLike = Union[str, torch.device, None]

# The JAX package's public surface, but its cross-language door
# (`cross_lang`, ROADMAP Queue A item 10).
__all__ = [
    "__version__",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "method",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "register_named_function",
    "get_runtime_context",
    "get_actor",
    "cluster_resources",
    "available_resources",
    "nodes",
    "timeline",
    "client",
    "get_accelerator_ids",
    "get_gpu_ids",
    "LoggingConfig",
    "ObjectRef",
    "RayTpuError",
    "TaskError",
    "ActorError",
    "ActorDiedError",
    "ObjectLostError",
    "GetTimeoutError",
    "TaskCancelledError",
    "TaskUnschedulableError",
    "WorkerCrashedError",
    "DeviceLike",
    "resolve_device",
]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default)
    and no CUDA device is present: the port never carries on silently on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev

