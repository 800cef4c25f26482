"""Runtime context: who/where am I, from inside a task or actor.

Counterpart of python/ray/runtime_context.py (ray.get_runtime_context():
job/node/worker/actor ids, resource view). Answers come from the local
runtime object — the worker already knows its identity; nothing round-
trips to the control plane except the node listing.
"""

from __future__ import annotations

from typing import Dict, Optional


class RuntimeContext:
    def __init__(self, runtime):
        self._rt = runtime

    @property
    def worker_id(self) -> str:
        return self._rt.core.worker_hex

    @property
    def session_id(self) -> str:
        return self._rt.core.session_id

    @property
    def node_id(self) -> str:
        import os

        return os.environ.get("RAY_TPU_NODE_ID", "head")

    @property
    def job_id(self) -> str:
        import os

        return os.environ.get("RAY_TPU_JOB_ID", "")

    @property
    def namespace(self) -> str:
        return getattr(self._rt, "namespace", "")

    def get_actor_id(self) -> Optional[str]:
        """Hex id of the current actor, or None outside an actor."""
        hex_id = getattr(self._rt, "_actor_hex", "")
        return hex_id or None

    def get_task_id(self) -> Optional[str]:
        """Hex id of the currently executing task (worker-side), or None
        on the driver."""
        spec = getattr(self._rt, "_current_task_spec", None)
        if spec is not None and spec.task_id is not None:
            return spec.task_id.hex()
        return None

    @property
    def was_current_actor_reconstructed(self) -> bool:
        import os

        return os.environ.get("RAY_TPU_ACTOR_RESTARTED", "0") == "1"

    def get_assigned_resources(self) -> Dict[str, float]:
        spec = getattr(self._rt, "_current_task_spec", None)
        if spec is not None:
            return dict(spec.resources)
        return {}

    def get_node_ids(self):
        return [n["node_id"] for n in self._rt.state_list("nodes")]


def get_runtime_context() -> RuntimeContext:
    from ray_tpu_torch.core.runtime import get_runtime

    return RuntimeContext(get_runtime())
