"""Exception hierarchy (counterpart of python/ray/exceptions.py)."""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception during execution.

    Stored in place of the task's return object; re-raised (wrapped) on get(),
    mirroring the reference's RayTaskError semantics
    (python/ray/exceptions.py).
    """

    def __init__(self, function_name: str, cause: BaseException | None = None, tb: str = ""):
        self.function_name = function_name
        self.cause = cause
        self.traceback_str = tb or (
            "".join(traceback.format_exception(cause)) if cause is not None else ""
        )
        super().__init__(
            f"Task {function_name!r} failed:\n{self.traceback_str}"
        )


class ActorError(RayTpuError):
    """Actor died before/while executing a submitted method."""


class ActorDiedError(ActorError):
    def __init__(self, actor_id, reason: str = ""):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"Actor {actor_id} died: {reason}")


class ObjectLostError(RayTpuError):
    """Object value is unrecoverable (all copies lost, lineage exhausted)."""


class ObjectFreedError(RayTpuError):
    """Object was explicitly freed."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """get() timed out."""


class WorkerCrashedError(RayTpuError):
    """Worker process died while executing a task."""


class TaskCancelledError(RayTpuError):
    """Task was cancelled before or during execution."""


class TaskUnschedulableError(RayTpuError):
    """Task can never be scheduled (e.g. its placement group was removed)."""


class RuntimeEnvSetupError(RayTpuError):
    """Failed to set up the runtime environment for a worker."""


class PendingCallsLimitExceeded(RayTpuError):
    """Actor max_pending_calls exceeded."""
