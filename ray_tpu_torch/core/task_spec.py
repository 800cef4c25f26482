"""Task / actor specifications shipped over the control plane.

Counterpart of the reference's TaskSpecification (src/ray/common/task/) and
the proto TaskSpec (src/ray/protobuf/common.proto): a compact picklable
record carrying identity, payload (function blob or cached function id),
arguments, resource demand and retry policy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID


@dataclass
class TaskArg:
    """One task argument: either an inline serialized value or an ObjectRef."""

    is_ref: bool
    # for refs:
    object_hex: str = ""
    # for inline values: raw serialized bytes (serialization.py layout)
    data: bytes = b""

    # Compact wire form: the control plane ships thousands of these per
    # second; tuple-reduce is ~5x faster than dataclass state pickling.
    def __reduce__(self):
        return (_mk_arg, (self.is_ref, self.object_hex, self.data))


def _mk_arg(is_ref, object_hex, data):
    a = TaskArg.__new__(TaskArg)
    a.is_ref = is_ref
    a.object_hex = object_hex
    a.data = data
    return a


@dataclass
class TaskSpec:
    task_id: TaskID
    func_id: str  # content hash of the function blob, for worker-side caching
    func_blob: Optional[bytes]  # cloudpickled callable; None if cached
    args: List[TaskArg]
    num_returns: int
    return_ids: List[ObjectID]
    resources: Dict[str, float]
    max_retries: int = 0
    retry_count: int = 0
    name: str = ""
    owner: str = ""  # worker hex that submitted
    # actor fields
    actor_id: Optional[ActorID] = None
    method_name: str = ""
    seq_no: int = -1
    # streaming-generator task (core/streaming.py): item objects are
    # derived from the task id instead of pre-registered return_ids
    is_streaming: bool = False
    # owner-direct actor task (runtime.py submit_actor_task): the result
    # is pushed straight back to the submitter over the direct actor
    # connection — the control server never sees the call (reference:
    # the direct actor transport + in-process store for small returns,
    # transport/direct_actor_task_submitter.cc)
    direct: bool = False
    # placement
    placement_group_hex: str = ""
    bundle_index: int = -1
    scheduling_strategy: Optional[Any] = None
    runtime_env: Optional[Dict[str, Any]] = None
    # object hexes this task holds a reference on until it completes
    # (top-level ref args + refs captured inside inline args); the executor
    # decrefs them after the task finishes.
    borrows: List[str] = field(default_factory=list)
    # Compact trace propagation context (util/tracing.py make_trace_ctx):
    # (trace_id, parent span_id), or None when the submitter traces
    # nothing — the reference's _DictPropagator context riding TaskSpec
    # metadata, costing two short strings on the wire only when set.
    trace_ctx: Optional[Tuple[str, str]] = None

    # Hot-path wire form (submit/actor_task ride this thousands of times
    # per second): IDs travel as raw bytes, fields as a flat tuple.
    # ~5x faster than the default dataclass pickling on both ends.
    def __reduce__(self):
        return (_mk_spec, (
            self.task_id.binary() if self.task_id is not None else None,
            self.func_id, self.func_blob, self.args, self.num_returns,
            [o.binary() for o in self.return_ids], self.resources,
            self.max_retries, self.retry_count, self.name, self.owner,
            self.actor_id.binary() if self.actor_id is not None else None,
            self.method_name, self.seq_no, self.is_streaming,
            self.placement_group_hex, self.bundle_index,
            self.scheduling_strategy, self.runtime_env, self.borrows,
            self.direct, self.trace_ctx))


def _mk_spec(task_id, func_id, func_blob, args, num_returns, return_ids,
             resources, max_retries, retry_count, name, owner, actor_id,
             method_name, seq_no, is_streaming, placement_group_hex,
             bundle_index, scheduling_strategy, runtime_env, borrows,
             direct, trace_ctx=None):
    s = TaskSpec.__new__(TaskSpec)
    s.task_id = TaskID(task_id) if task_id is not None else None
    s.func_id = func_id
    s.func_blob = func_blob
    s.args = args
    s.num_returns = num_returns
    s.return_ids = [ObjectID(b) for b in return_ids]
    s.resources = resources
    s.max_retries = max_retries
    s.retry_count = retry_count
    s.name = name
    s.owner = owner
    s.actor_id = ActorID(actor_id) if actor_id is not None else None
    s.method_name = method_name
    s.seq_no = seq_no
    s.is_streaming = is_streaming
    s.placement_group_hex = placement_group_hex
    s.bundle_index = bundle_index
    s.scheduling_strategy = scheduling_strategy
    s.runtime_env = runtime_env
    s.borrows = borrows
    s.direct = direct
    s.trace_ctx = trace_ctx
    return s


class KwargsMarker:
    """Sentinel wrapper: kwargs dict shipped as the final positional arg.

    Lives here (not worker.py) because worker.py runs as ``__main__`` in
    worker processes — defining it there would create two distinct classes
    and break isinstance checks on deserialized markers.
    """

    __slots__ = ("kwargs",)

    def __init__(self, kwargs: dict):
        self.kwargs = kwargs


@dataclass
class ActorCreationSpec:
    actor_id: ActorID
    class_id: str
    class_blob: Optional[bytes]
    args: List[TaskArg]
    resources: Dict[str, float]
    max_restarts: int = 0
    # Per-method retry budget on actor RESTART (reference
    # max_task_retries): delivered-but-unfinished direct calls are
    # resubmitted by their owner when the actor comes back ALIVE.
    max_task_retries: int = 0
    name: str = ""
    namespace: str = ""
    max_concurrency: int = 1
    # Named concurrency groups {name: pool size}; methods route via
    # @ray_tpu_torch.method(concurrency_group=...) (reference
    # concurrency_group_manager.cc per-group executor pools).
    concurrency_groups: Optional[Dict[str, int]] = None
    owner: str = ""
    placement_group_hex: str = ""
    bundle_index: int = -1
    scheduling_strategy: Optional[Any] = None
    runtime_env: Optional[Dict[str, Any]] = None
    restart_count: int = 0
