"""Per-process core runtime: the counterpart of the reference's CoreWorker.

Every participating process (driver or worker) holds a CoreClient that talks
to the control server (gcs.py): object subscription/resolution, task and
actor submission, reference counting, and the shared-memory store attachment.
Reference call-stack parity: CoreWorker::SubmitTask / Put / Get
(src/ray/core_worker/core_worker.cc:2166/:1241/:1552) and the direct actor
transport (transport/direct_actor_task_submitter.cc — per-handle ordered
submission over a dedicated connection).
"""

from __future__ import annotations

import collections
import hashlib
import os
import re
import threading
import time
from concurrent import futures
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeoutError
from typing import Any, Dict, List, Optional, Sequence

import cloudpickle

from ray_tpu_torch.core import object_plane, rpc, serialization
from ray_tpu_torch.core.config import HEAD_RUNTIME, Config, get_config
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    RayTpuError,
    TaskError,
)
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import ShmObjectStore
from ray_tpu_torch.core.task_spec import ActorCreationSpec, TaskArg, TaskSpec

_global_runtime = None
_runtime_lock = threading.Lock()

# Cached lazy import: util.tracing pulls in util/__init__ → placement
# groups → this module, so a top-level import here would cycle.
_tracing = None


def _get_tracing():
    global _tracing
    if _tracing is None:
        from ray_tpu_torch.util import tracing

        _tracing = tracing
    return _tracing


def _make_trace_ctx():
    """Current (trace_id, parent span_id) to ride the outgoing TaskSpec,
    or None when nothing is being traced (nothing on the wire)."""
    try:
        return _get_tracing().make_trace_ctx()
    except Exception:
        return None


def _is_missing_segment_error(e: Exception) -> bool:
    """True for attach failures meaning "no longer at that location"
    (deleted arena slot / unlinked file) as opposed to real IO faults."""
    if isinstance(e, FileNotFoundError):
        return True
    try:
        from ray_tpu_torch.native.store import ArenaError

        return isinstance(e, ArenaError)
    except ImportError:
        return False


def check_runtime_env(runtime_env: dict) -> None:
    """Raise for a runtime_env the port cannot apply yet: it takes
    `env_vars` (a dict, applied to the worker's os.environ, worker.py);
    working_dir, py_modules, pip, conda and container come with
    runtime_env/ (ROADMAP Queue A item 10)."""
    extra = sorted(set(runtime_env) - {"env_vars"})
    if extra:
        raise NotImplementedError(
            f"runtime_env keys {extra} are not ported yet (runtime_env/, "
            "ROADMAP Queue A item 10); the port takes env_vars only")
    if not isinstance(runtime_env.get("env_vars", {}), dict):
        raise ValueError("runtime_env['env_vars'] must be a dict")


# Runs a callable on the thread that issues this process's device work
# and returns its result (set_profile_runner); None: no such thread.
_profile_runner = None


def set_profile_runner(run) -> None:
    """Name the thread that issues this process's device work: `run(fn)`
    runs fn on that thread (between its work items) and returns fn's
    result or raises its exception; None forgets it.  torch_trace then
    enters and leaves its profiler session on that thread, where a
    session taken from another thread while that one replays CUDA graphs
    can hang or record nothing (an H100, torch 2.11+cu128; PERF.md, the
    trace probe).  serve/llm.py's LLMServer names its engine thread; a
    GPU-class worker that runs its tasks on one thread names that thread
    (default_profile_runner, core/worker.py)."""
    global _profile_runner
    _profile_runner = run


def default_profile_runner(run) -> bool:
    """Name `run` unless a runner is named already (an actor's __init__
    may have named a thread of its own); whether it did."""
    if _profile_runner is not None:
        return False
    set_profile_runner(run)
    return True


class ThreadRunner:
    """A profile runner for a thread that takes work items one at a time:
    `runner(fn)` queues fn and waits for it; the thread calls
    `run_pending()` between two items."""

    def __init__(self):
        self._calls: collections.deque = collections.deque()
        self._queued = threading.Event()

    def __call__(self, fn):
        fut: Future = Future()
        self._calls.append((fn, fut))
        self._queued.set()
        return fut.result()

    def run_pending(self, wait_s: float = 0.0) -> bool:
        """Run the queued calls, once one is queued or `wait_s` has
        passed; whether any was left queued before."""
        self._queued.wait(wait_s)
        self._queued.clear()
        ran = bool(self._calls)
        while self._calls:
            fn, fut = self._calls.popleft()
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 (to the caller)
                fut.set_exception(e)
        return ran


# How long a profiler session's start, and then its stop, may take on
# the runner, the wait for its thread included (torch_trace).  A
# process's first start spends 7-11 s setting up Kineto and CUPTI (an
# H100, torch 2.11+cu128).
PROFILE_BOUND_S = 20.0

# Set from a session's start until its stop has returned on the runner
# (or its start was withdrawn): one session at a time.
_session_lock = threading.Lock()
_session_open = False


def _close_session() -> None:
    global _session_open
    with _session_lock:
        _session_open = False


def _on_runner(fn, run) -> Future:
    """fn handed to the profile runner `run` from a thread of its own, so
    that the request can stop waiting for it: its Future, which cancel()
    withdraws (fn then never runs) until fn has begun."""
    fut: Future = Future()

    def body():
        if fut.set_running_or_notify_cancel():
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 (read by the request)
                fut.set_exception(e)

    def hand():
        try:
            run(body)
        except BaseException:  # noqa: BLE001
            # The runner refused: its thread has left its loop (an
            # LLMServer whose engine died), so no device work runs there
            # any more and fn may run here.
            if not (fut.running() or fut.done()):
                body()

    threading.Thread(target=hand, daemon=True, name="profile-step").start()
    return fut


def _session_thread() -> ThreadRunner:
    """A profile runner on a daemon thread of the session's own (a session
    starts and stops on one thread: PyTorch's CPU build crashes
    otherwise); the thread ends once no session is open and it is idle."""
    runner = ThreadRunner()

    def loop():
        while runner.run_pending(0.5) or _session_open:
            pass

    threading.Thread(target=loop, daemon=True,
                     name="profile-session").start()
    return runner


def _torch_trace(out_dir: str, duration_s: float) -> str:
    """torch.profiler over a window of this process (the reference's
    jax_trace kind): returns the path of the Chrome trace it writes, or a
    "profile failed: ..." string, within duration_s plus twice
    PROFILE_BOUND_S plus the export.

    CUDA activity (CUPTI, process-wide: kernels of every thread, graph
    replays included) is recorded only when this process has already
    initialized CUDA itself; a profile must not be what opens a context
    on the card.  The session starts and stops on the thread named by
    set_profile_runner, when one is (else on a thread of its own); the
    window passes on this thread.  A departure from the reference, whose
    jax_trace traces from any thread: a session started or stopped on
    another thread while the runner replays CUDA graphs could hang for
    good (an H100, torch 2.11+cu128), so a start and a stop each have the
    bound to begin and return on the runner, and this thread never waits
    longer.  So a one-thread GPU worker (core/worker.py) cannot be traced
    during a task longer than the bound: the start is withdrawn and never
    runs.  A start that began late stops its session as soon as it
    returns.  A stop stays queued until it has run (withdrawn, it would
    leave the session recording for good): where a task began in the
    window, the session records until that task ends.  Until a session's
    stop has returned, every other torch_trace answers "profile failed:
    ..." at once.  GPU-class workers also run with TEARDOWN_CUPTI=0
    (node_manager.gpu_worker_env), so that CUPTI stays set up between
    sessions.  A session that asked for CUDA activity and holds no device
    event (an idle card) is not handed back as a trace: it returns a
    "profile failed: ..." string that names the file it wrote."""
    global _session_open
    import torch
    from torch.profiler import ProfilerActivity, profile

    bound = PROFILE_BOUND_S
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=activities)
    with _session_lock:
        if _session_open:
            return ("profile failed: a profiler session of this process is "
                    "still open (its start or stop has not returned on the "
                    "device thread)")
        _session_open = True
    try:
        run = _profile_runner or _session_thread()
        start = _on_runner(prof.start, run)
    except BaseException:
        _close_session()
        raise

    def stop_and_close():
        try:
            prof.stop()
        finally:
            _close_session()

    def after_late_start(fut):
        if fut.exception() is None:
            _on_runner(stop_and_close, run)
        else:
            _close_session()

    futures.wait([start], bound)
    if start.cancel():
        _close_session()
        return (f"profile failed: the device thread did not come free "
                f"within {bound:g} s")
    if not start.done():
        start.add_done_callback(after_late_start)
        return (f"profile failed: the profiler's start did not return "
                f"within {bound:g} s (the session stops when it does)")
    e = start.exception()
    if e is not None:
        _close_session()
        return f"profile failed: {type(e).__name__}: {e}"
    time.sleep(duration_s)
    stop = _on_runner(stop_and_close, run)
    futures.wait([stop], bound)
    if not stop.done():
        return (f"profile failed: the profiler's stop did not return within "
                f"{bound:g} s (it stays queued on the device thread)")
    e = stop.exception()
    if e is not None:
        return f"profile failed: {type(e).__name__}: {e}"
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    # A scan of the file, not prof.events(): parsing a decoding engine's
    # events takes seconds.
    if ProfilerActivity.CUDA in activities and not _has_device_event(path):
        return (f"profile failed: no CUDA event in {path} (the card ran "
                "nothing in the window)")
    return path


_DEVICE_EVENT = re.compile(rb'"cat"\s*:\s*"(kernel|gpu_memcpy|gpu_memset)"')


def _has_device_event(trace_path: str) -> bool:
    """Whether a Chrome trace holds a kernel, copy or memset on the card."""
    with open(trace_path, "rb") as f:
        return _DEVICE_EVENT.search(f.read()) is not None


def dump_all_stacks() -> str:
    """Format every thread's current Python stack (the in-process
    counterpart of the reference's py-spy `ray stack` dumps — no
    external profiler binary needed for cooperative processes)."""
    import sys
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        out.append(f"--- Thread {tid} ({names.get(tid, '?')}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


def get_runtime():
    if _global_runtime is None:
        raise RuntimeError(
            "ray_tpu not initialized; call ray_tpu_torch.init() first")
    return _global_runtime


def set_runtime(rt):
    global _global_runtime
    with _runtime_lock:
        _global_runtime = rt


class _LeasePool:
    """Owner-side lease state for one task shape (resources +
    runtime_env): the granted workers, their in-flight specs, and the
    not-yet-assigned queue.  Counterpart of the per-SchedulingKey entry
    in the reference's CoreWorkerDirectTaskSubmitter
    (direct_task_transport.h:75)."""

    __slots__ = ("resources", "runtime_env", "workers", "inflight",
                 "queue", "requested", "requested_at", "idle_since",
                 "worker_idle", "backoff_until")

    def __init__(self, resources: Dict[str, float],
                 runtime_env: Optional[dict]):
        self.resources = dict(resources)
        self.runtime_env = runtime_env
        import collections

        self.workers: Dict[str, str] = {}  # worker_hex -> address
        self.inflight: Dict[str, Dict[str, TaskSpec]] = {}
        # deque: a big burst drains via popleft; list.pop(0) would be
        # O(n^2) under the lease lock.
        self.queue = collections.deque()
        self.requested = 0  # workers asked for but not yet granted
        # When the outstanding ask was last refreshed (request sent or
        # grant received).  Pending demand the head queued indefinitely
        # (cluster saturated) must not clamp pipeline depth forever.
        self.requested_at = 0.0
        self.idle_since: Optional[float] = None
        # worker_hex -> when it last went idle while others of the pool
        # stayed busy (_sweep_idle_leases returns it on its own).
        self.worker_idle: Dict[str, float] = {}
        # Set on denial (cluster saturated): no re-request until then —
        # pipeline onto what we have and retry for freed capacity.
        self.backoff_until = 0.0

    def busy(self) -> bool:
        return bool(self.queue) or any(self.inflight.values())


class CoreClient:
    """Client-side core: object futures, submission, refcounting."""

    def __init__(self, control_addr: str, worker_hex: str, kind: str,
                 address: str = "", env_key: str = "",
                 config: Optional[Config] = None, thin: bool = False):
        self.worker_hex = worker_hex
        self.kind = kind
        self.config = config or get_config()
        # Set BEFORE any rpc.Client exists: its reader thread can fire
        # _on_control_disconnect mid-__init__ (head dying in the
        # registration window), which dereferences these.
        self._closed = False
        self._reconnecting = threading.Lock()
        # Thin mode (reference Ray Client, util/client/): no shared-memory
        # attachment — every payload rides the TCP connection, so the
        # client can live on any machine that reaches the control address.
        self.thin = thin
        # Hooks must exist before the rpc recv thread can deliver pushes.
        self.on_execute_task = None
        self.on_create_actor = None
        self.on_exit = None
        # Fired after a successful control-plane reconnect (head restart
        # tolerance): workers re-announce themselves here.
        self.on_reconnect = None
        self.control_addr = control_addr
        # Must exist before the client's first call() fires _pre_call.
        self._pending_count = 0
        self._register_msg = {
            "op": "register",
            "worker_hex": worker_hex,
            "pid": os.getpid(),
            "kind": kind,
            "address": address,
            "env_key": env_key,
            "node_id": os.environ.get("RAY_TPU_NODE_ID", ""),
        }
        self.client = rpc.Client(control_addr, on_push=self._on_push,
                                 on_disconnect=self._on_control_disconnect)
        self.client._pre_call = self._flush_if_pending
        reply = self.client.call(self._register_msg)
        if reply.get("runtime") != HEAD_RUNTIME:
            self.client.close()
            raise RayTpuError(
                f"{control_addr} is not a head of this package's runtime "
                "(a cluster of the JAX package?); start or name a head of "
                "the port")
        self.session_id = reply["session_id"]
        self.session_dir = reply["session_dir"]
        # The arena this process attaches is its NODE's (multi-host:
        # each node manager owns one; head + logical nodes share the
        # head's — gcs.py _op_register decides).
        self.store_node = reply.get("store_node", "head")
        self.store = None if thin else ShmObjectStore(
            reply.get("store_key") or self.session_id, reply["shm_dir"])
        # Single-flight table for remote-object pulls: N concurrent
        # consumers of one object in this process share ONE wire pull
        # (reference pull_manager.h request coalescing).
        self._pull_manager = object_plane.PullManager()

        # RLock: on_ref_deleted (GC __del__) takes it and can fire while
        # this same thread already holds it in a get()/put() section.
        self._lock = threading.RLock()
        # Thread-local put buffering: a worker executing a task batches
        # its result put_object messages into the task_done message (one
        # control round instead of N+1) — see worker.py _execute.
        self._tls = threading.local()
        self._object_futures: Dict[str, Future] = {}
        self._subscribed: set[str] = set()
        # Worker resource-sampler config, shared with the sampler thread
        # (worker.py _profile_sampler_loop) and retunable at runtime by
        # a head "profile_config" push (set_profile_config op).  The
        # event wakes the sampler out of its interval sleep so a toggle
        # takes effect immediately (bench A/B windows).
        self.profile_config: Dict[str, Any] = {}
        self.profile_config_ev = threading.Event()
        # Hexes whose future has resolved — maintained by done-callbacks
        # so wait() is a set-membership check + condition wait instead
        # of an O(n) future-lock scan per call.
        self._resolved: set = set()
        self._resolved_cond = threading.Condition()
        # Owner-direct actor results (the control plane is OFF the actor
        # hot path — reference direct_actor_task_submitter.cc): futures
        # resolved by pushes on the direct actor connection, never
        # registered with the head unless the ref escapes this process.
        self._direct_futures: Dict[str, Future] = {}
        self._direct_inflight: Dict[str, set] = {}  # actor_hex -> obj hexes
        # Delivered direct specs kept for resubmission across an actor
        # RESTART (only when the actor was created with
        # max_task_retries > 0); obj_hex -> TaskSpec.
        self._direct_inflight_specs: Dict[str, TaskSpec] = {}
        self._direct_actor_of: Dict[str, str] = {}  # obj hex -> actor_hex
        # Direct refs that escaped (were serialized into another task /
        # put) before or after resolving: the head got a registration and
        # must receive the value once it lands (ownership promotion).
        self._direct_promoted: set[str] = set()
        # Submit-side coalescing: actor-task sends queue per address and
        # flush as ONE actor_task_batch frame at the next get()/wait()
        # (or a 2 ms timer / 64-spec cap for fire-and-forget callers).
        # On a contended host this amortizes the per-call syscall +
        # wakeup cost across the burst — the reference gets the same
        # effect from gRPC stream batching.
        # RLocks, deliberately: ObjectRef.__del__ fires from GC at
        # ARBITRARY points — including while this same thread is inside
        # a section holding these locks (observed: a Thread.__init__
        # allocation inside _queue_for_flush triggered GC -> __del__ ->
        # on_ref_deleted -> flush -> self-deadlock on a plain Lock).
        # The __del__ path only appends to the queues, which is safe to
        # re-enter.
        self._send_lock = threading.RLock()
        # Serializes whole flushes (swap + send): two flushers racing
        # (inline at get() vs the 2 ms background thread) must not
        # reorder an incref frame ahead of the submit that registers
        # its object.
        self._flush_mutex = threading.RLock()
        self._pending_direct: Dict[str, List[TaskSpec]] = {}
        self._pending_pool: Dict[str, List[TaskSpec]] = {}
        self._pending_submits: List[TaskSpec] = []
        # Owner-direct task leases (reference: the lease protocol of
        # CoreWorkerDirectTaskSubmitter, direct_task_transport.h:75 —
        # RequestNewWorkerIfNeeded :353 leases workers from the
        # scheduler; the owner then pushes specs peer-to-peer and
        # reuses the lease while same-shaped work remains, OnWorkerIdle
        # :197).  One pool per task shape.
        self._lease_lock = threading.RLock()
        self._leases: Dict[tuple, "_LeasePool"] = {}
        # Shapes with backlogged submissions awaiting a flusher-thread
        # pump (split submit path, _submit_via_lease).
        self._pump_shapes: set = set()
        self._lease_tokens: Dict[int, tuple] = {}  # token -> shape key
        self._lease_token_seq = 0
        self._lease_of_obj: Dict[str, tuple] = {}  # obj -> (shape, whex, task_hex)
        self._lease_addr_workers: Dict[str, set] = {}  # addr -> worker hexes
        self._lease_request_pending = False
        # Objects this process itself stored (put / stored returns):
        # their refs are resolvable without waiting, so tasks using them
        # as args stay lease-eligible.
        self._local_known: set = set()
        # Small put payloads kept for arg hydration: a resolved ref arg
        # whose bytes we hold ships INLINE in the spec instead of making
        # the executor fetch it (reference: the DependencyResolver
        # inlines small resolved deps, transport/dependency_resolver.cc).
        self._inline_cache: Dict[str, bytes] = {}
        self._inline_cache_bytes = 0
        self._flush_ev = threading.Event()
        self._flusher_started = False
        # actor state tracking
        self._actor_state: Dict[str, dict] = {}
        self._actor_cv = threading.Condition()
        self._actor_conns: Dict[str, rpc.Client] = {}
        # Connections to other nodes' object servers (cross-node pulls).
        self._node_conns: Dict[str, rpc.Client] = {}
        self._actor_queues: Dict[str, List[TaskSpec]] = {}
        self._sent_funcs: set[str] = set()

    # ------------------------------------------------------------------
    # Control-plane reconnection (reference: raylet/worker redial after
    # GCS restart, NotifyGCSRestart node_manager.proto:383).
    def _on_control_disconnect(self):
        if self._closed:
            return
        if self.config.gcs_reconnect_timeout_s <= 0:
            if self.on_exit is not None:
                self.on_exit()
            return
        # One loop at a time: a flapping head must not stack concurrent
        # reconnectors racing writes to self.client.
        if not self._reconnecting.acquire(blocking=False):
            return
        threading.Thread(target=self._reconnect_loop,
                         name="control-reconnect", daemon=True).start()

    def _reconnect_loop(self):
        try:
            self._reconnect_loop_inner()
        finally:
            self._reconnecting.release()
        # A drop during the adoption/resync window fires the callback
        # while _reconnecting is still held (swallowed by the
        # non-blocking acquire) — recheck now that it's released.
        client = self.client
        if not self._closed and getattr(client, "_closed", False):
            self._on_control_disconnect()

    def _reconnect_loop_inner(self):
        deadline = time.monotonic() + self.config.gcs_reconnect_timeout_s
        delay = 0.2
        while not self._closed and time.monotonic() < deadline:
            client = None
            try:
                # No on_disconnect on the probe: a flap during resync
                # must not spawn a second loop; the callback is attached
                # only once this client is adopted.
                client = rpc.Client(
                    self.control_addr, on_push=self._on_push,
                    connect_timeout=1.0)
                client.call(self._register_msg, timeout=10.0)
                # Re-subscribe everything unresolved.  grace=True: the
                # restarted head fails objects nobody re-produces within
                # its grace window instead of leaving gets hanging.
                with self._lock:
                    pending = [
                        h for h in self._subscribed
                        if (f := self._object_futures.get(h)) is not None
                        and not f.done()]
                with self._actor_cv:
                    actors = set(self._actor_state) | \
                        set(self._actor_queues)
                if pending:
                    client.send({"op": "subscribe_objects",
                                 "objs": pending, "grace": True})
                for actor_hex in actors:
                    client.send({"op": "subscribe_actor",
                                 "actor": actor_hex})
            except Exception:
                if client is not None:
                    client.close()
                time.sleep(delay)
                delay = min(delay * 1.7, 2.0)
                continue
            client._on_disconnect = self._on_control_disconnect
            client._pre_call = self._flush_if_pending
            if client._closed:
                # Dropped between resync and adoption: the callback we
                # just attached never fires for that earlier loss.
                client.close()
                time.sleep(delay)
                continue
            self.client = client
            # The restarted head rebuilt worker states from re-announces
            # and knows nothing of our leases: drop granted workers
            # (in-flight results still arrive on their live direct
            # conns) and let the pump re-request against the new head.
            with self._lease_lock:
                self._lease_tokens.clear()
                # _lease_addr_workers is deliberately KEPT: in-flight
                # specs survive the restart, and a later death of their
                # worker must still map the dropped connection back to
                # the worker hex to fail them over.
                for shape, pool in self._leases.items():
                    pool.workers.clear()
                    pool.requested = 0
                    if pool.queue:
                        self._pump_lease_locked(shape, pool)
            # Anything stranded by a mid-outage flush failure goes out
            # now that a live connection exists.
            if self._pending_count:
                self._flush_ev.set()
            cb = self.on_reconnect
            if cb is not None:
                try:
                    cb()
                except Exception:
                    pass
            return
        # Could not reach a head within the window: give up the same way
        # a worker death would.
        if self.on_exit is not None:
            self.on_exit()

    def _on_push(self, msg: dict):
        op = msg.get("op")
        if op == "object_ready":
            with self._lock:
                fut = self._object_futures.get(msg["obj"])
            if fut is not None and not fut.done():
                fut.set_result(msg)
        elif op == "actor_update":
            self._handle_actor_update(msg)
        elif op == "execute_task" and self.on_execute_task is not None:
            self.on_execute_task(msg["spec"])
        elif op == "create_actor_instance" and self.on_create_actor is not None:
            self.on_create_actor(msg["spec"])
        elif op == "lease_granted":
            self._on_lease_granted(msg)
        elif op == "lease_revoked":
            self._on_lease_worker_lost(msg["worker"],
                                       msg.get("reason", "worker died"))
        elif op == "profile":
            # On-demand profiling (gcs.py _op_profile_worker): run off
            # the push thread; the worker keeps executing its task.
            threading.Thread(target=self._run_profile, args=(msg,),
                             name="profile", daemon=True).start()
        elif op == "collect_spans":
            # Cluster span harvest (gcs._op_harvest_spans): serve off
            # the push thread — serializing a 2048-span chunk inline
            # would stall task dispatch/result traffic behind it on a
            # busy process.  The reply is one-way; the head matches it
            # to its waiter by token (profile_result pattern), and it
            # never issues the next chunk request until this reply
            # lands, so off-thread serving can't reorder chunks.
            threading.Thread(target=self._serve_collect_spans,
                             args=(msg,), name="collect-spans",
                             daemon=True).start()
        elif op == "profile_config":
            # Head retuning every worker's resource sampler at runtime
            # (set_profile_config): just update shared state — the
            # sampler thread (worker.py) re-reads it each wakeup.
            cfg = self.profile_config
            if msg.get("enabled") is not None:
                cfg["enabled"] = bool(msg["enabled"])
            if msg.get("interval_s") is not None:
                try:
                    cfg["interval_s"] = max(0.05, float(msg["interval_s"]))
                except (TypeError, ValueError):
                    pass
            self.profile_config_ev.set()
        elif op == "exit" and self.on_exit is not None:
            self.on_exit()

    def _serve_collect_spans(self, msg: dict):
        try:
            out = _get_tracing().collect_spans_since(
                int(msg.get("cursor", 0) or 0),
                max_spans=int(msg.get("limit", 2048) or 2048))
        except Exception:
            out = {"rows": [], "cursor": 0, "missed": 0}
        try:
            self.client.send({
                "op": "collect_spans_result", "token": msg.get("token"),
                "cursor": out["cursor"], "rows": out["rows"],
                "missed": out["missed"], "pid": os.getpid(),
                "worker": self.worker_hex})
        except Exception:
            pass

    def _run_profile(self, msg: dict):
        kind = msg.get("kind", "stack")
        try:
            if kind == "stack":
                data = dump_all_stacks()
            elif kind == "torch_trace":
                data = _torch_trace(
                    os.path.join(self.session_dir, "profiles",
                                 f"{self.worker_hex[:8]}-{int(time.time())}"),
                    float(msg.get("duration_s", 2.0)))
            else:
                data = f"unknown profile kind {kind!r}"
        except Exception as e:  # noqa: BLE001
            data = f"profile failed: {type(e).__name__}: {e}"
        if "_local_result" in msg:  # self-profile (state/api.py)
            msg["_local_result"]["data"] = data
            return
        try:
            self.client.send({"op": "profile_result",
                              "token": msg.get("token"), "data": data})
        except Exception:
            pass

    def _handle_actor_update(self, msg: dict):
        actor_hex = msg["actor"]
        with self._actor_cv:
            self._actor_state[actor_hex] = msg
            self._actor_cv.notify_all()
        if msg["state"] == "ALIVE":
            self._flush_actor_queue(actor_hex, msg["address"])
        elif msg["state"] == "DEAD":
            self._fail_actor_queue(actor_hex, msg.get("reason", ""))
            self._fail_direct_inflight(actor_hex, msg.get("reason", ""))
        elif msg["state"] == "RESTARTING":
            # Tasks already DELIVERED to the dead instance are lost (the
            # restarted instance never sees them); queued ones re-flush
            # on ALIVE.  With max_task_retries they resubmit to the
            # restarted instance; otherwise this mirrors the head's
            # _fail_actor_inflight for the registered (non-direct) path.
            self._fail_direct_inflight(
                actor_hex, msg.get("reason", "actor restarting"),
                retryable=True)

    # ------------------------------------------------------------------
    # Owner-direct actor results: the result of a plain (1-return,
    # non-streaming) actor call is pushed straight back on the direct
    # actor connection; the head is not involved unless the ref escapes
    # this process (promotion) or the result is too large for the wire.
    def _mark_resolved(self, obj_hex: str):
        with self._resolved_cond:
            self._resolved.add(obj_hex)
            self._resolved_cond.notify_all()

    def _track_resolution(self, obj_hex: str, fut: Future):
        fut.add_done_callback(lambda f, h=obj_hex: self._mark_resolved(h))

    def _register_direct(self, obj_hex: str, actor_hex: str) -> Future:
        fut = Future()
        with self._lock:
            self._direct_futures[obj_hex] = fut
            self._direct_actor_of[obj_hex] = actor_hex
        self._track_resolution(obj_hex, fut)
        return fut

    def _mark_direct_delivered(self, spec):
        """The spec was actually sent to a live instance: its results are
        now at risk of that instance's death.  Actors created with
        max_task_retries keep the spec around so a RESTART resubmits it
        instead of failing the caller."""
        if not getattr(spec, "direct", False):
            return
        actor_hex = spec.actor_id.hex()
        with self._actor_cv:
            st = self._actor_state.get(actor_hex) or {}
            retryable = st.get("max_task_retries", 0) > 0
        with self._lock:
            for oid in spec.return_ids:
                if oid.hex() in self._direct_futures:
                    self._direct_inflight.setdefault(
                        actor_hex, set()).add(oid.hex())
                    if retryable:
                        self._direct_inflight_specs[oid.hex()] = spec

    def _on_direct_push(self, msg: dict):
        op = msg.get("op")
        if op == "direct_result":
            self._resolve_direct(
                msg["obj"], {"direct": True, "data": msg["data"],
                             "is_error": msg.get("is_error", False)})
        elif op == "direct_result_batch":
            results = msg["results"]
            promoted = []
            with self._lock:
                resolved = []
                for obj_hex, data, is_error in results:
                    fut = self._direct_futures.get(obj_hex)
                    actor_hex = self._direct_actor_of.get(obj_hex, "")
                    self._direct_inflight.get(
                        actor_hex, set()).discard(obj_hex)
                    if obj_hex in self._direct_promoted:
                        promoted.append((obj_hex, data, is_error))
                    resolved.append((fut, data, is_error))
            for obj_hex, data, is_error in promoted:
                try:
                    self.client.send({
                        "op": "put_object", "obj": obj_hex,
                        "size": len(data), "inline": bytes(data),
                        "is_error": is_error})
                except Exception:
                    pass
            for obj_hex, _, _ in results:
                self._lease_task_completed(obj_hex)
            for fut, data, is_error in resolved:
                if fut is not None and not fut.done():
                    fut.set_result({"direct": True, "data": data,
                                    "is_error": is_error})
        elif op == "direct_result_remote":
            # Result was too large for the wire: the worker stored it via
            # the head (shm path); chain the head subscription into the
            # local direct future.
            obj_hex = msg["obj"]
            # The worker is done with the task either way: free its
            # lease pipeline slot now, not when the owner resolves.
            self._lease_task_completed(obj_hex)
            with self._lock:
                # The head now holds an entry (refcount 1 from the
                # worker's put): mark it head-known so this ref's
                # deletion sends the decref — otherwise every oversized
                # direct result would pin head memory forever.
                self._direct_promoted.add(obj_hex)
                fut = self._direct_futures.get(obj_hex)
                head_fut = self._object_futures.get(obj_hex)
                if head_fut is None:
                    head_fut = Future()
                    self._object_futures[obj_hex] = head_fut
                    self._track_resolution(obj_hex, head_fut)
                if obj_hex not in self._subscribed:
                    self._subscribed.add(obj_hex)
                    self.client.send({"op": "subscribe_objects",
                                      "objs": [obj_hex]})
            if fut is None:
                return

            def _chain(hf, fut=fut, obj_hex=obj_hex):
                self._lease_task_completed(obj_hex)
                with self._lock:
                    self._direct_inflight.get(
                        self._direct_actor_of.get(obj_hex, ""),
                        set()).discard(obj_hex)
                if fut.done():
                    return
                try:
                    fut.set_result(hf.result(timeout=0))
                except BaseException as e:  # noqa: BLE001
                    fut.set_exception(e)

            head_fut.add_done_callback(_chain)

    def _resolve_direct(self, obj_hex: str, info: dict):
        self._lease_task_completed(obj_hex)
        with self._lock:
            fut = self._direct_futures.get(obj_hex)
            actor_hex = self._direct_actor_of.get(obj_hex, "")
            self._direct_inflight.get(actor_hex, set()).discard(obj_hex)
            self._direct_inflight_specs.pop(obj_hex, None)
            promoted = obj_hex in self._direct_promoted
        if promoted:
            # The ref escaped before the value landed: forward the bytes
            # to the head so remote holders resolve.
            try:
                self.client.send({
                    "op": "put_object", "obj": obj_hex,
                    "size": len(info["data"]), "inline": bytes(info["data"]),
                    "is_error": info.get("is_error", False)})
            except Exception:
                pass
        if fut is not None and not fut.done():
            fut.set_result(info)

    def _fail_direct(self, obj_hex: str, err: Exception):
        from ray_tpu_torch.core import serialization

        self._lease_task_completed(obj_hex)
        with self._lock:
            fut = self._direct_futures.get(obj_hex)
            actor_hex = self._direct_actor_of.get(obj_hex, "")
            self._direct_inflight.get(actor_hex, set()).discard(obj_hex)
            promoted = obj_hex in self._direct_promoted
        if fut is not None and fut.done():
            # Already resolved (result raced the failure notification):
            # a stale inflight entry must NOT overwrite the delivered —
            # possibly promoted — value with an actor-died error.
            return
        data = serialization.serialize(err).to_bytes()
        if promoted:
            try:
                self.client.send({
                    "op": "put_object", "obj": obj_hex, "size": len(data),
                    "inline": data, "is_error": True})
            except Exception:
                pass
        if fut is not None and not fut.done():
            fut.set_result({"direct": True, "data": data,
                            "is_error": True})

    def _fail_direct_inflight(self, actor_hex: str, reason: str,
                              retryable: bool = False):
        """Tasks delivered to a dead actor instance.  retryable=True
        (the actor is RESTARTING): specs with max_task_retries budget
        left re-queue for the restarted instance — the owner is the
        only party holding the spec on the direct path, so the retry
        happens here, not at the head (reference
        direct_actor_task_submitter retry-on-restart).  Everything else
        fails with ActorDiedError."""
        with self._lock:
            pending = list(self._direct_inflight.pop(actor_hex, ()))
            specs = {h: self._direct_inflight_specs.pop(h, None)
                     for h in pending}
        if not pending:
            return
        with self._actor_cv:
            mtr = (self._actor_state.get(actor_hex)
                   or {}).get("max_task_retries", 0)
        err = ActorDiedError(actor_hex, reason or "actor died")
        retried = []
        for obj_hex in pending:
            spec = specs.get(obj_hex)
            if retryable and spec is not None and spec.retry_count < mtr:
                spec.retry_count += 1
                retried.append(spec)
            else:
                self._fail_direct(obj_hex, err)
        for spec in retried:
            # Actor state is RESTARTING: this queues the spec and it
            # flushes when the ALIVE update lands.
            self._route_actor_task(actor_hex, spec)

    def _maybe_promote_direct(self, obj_hex: str):
        """The ref is escaping this process (serialized into a task arg /
        put): make it resolvable via the head.  Resolved → forward the
        bytes now; pending → register (tied to its actor so actor death
        fails remote waiters too) and forward on arrival."""
        with self._lock:
            fut = self._direct_futures.get(obj_hex)
            if fut is None or obj_hex in self._direct_promoted:
                return
            self._direct_promoted.add(obj_hex)
            actor_hex = self._direct_actor_of.get(obj_hex, "")
        self.client.send({"op": "register_objects", "objs": [obj_hex],
                          "actor": actor_hex})
        if fut.done():
            info = fut.result(timeout=0)
            if info.get("direct"):
                try:
                    self.client.send({
                        "op": "put_object", "obj": obj_hex,
                        "size": len(info["data"]),
                        "inline": bytes(info["data"]),
                        "is_error": info.get("is_error", False)})
                except Exception:
                    pass
        # pending: _resolve_direct / _fail_direct forwards on arrival

    # ------------------------------------------------------------------
    # Owner-direct task leases.  The reference's normal-task hot path
    # (CoreWorkerDirectTaskSubmitter, direct_task_transport.h:75): the
    # owner leases workers from the scheduler once per task shape
    # (RequestNewWorkerIfNeeded :353), pushes specs peer-to-peer
    # (PushNormalTask :601), reuses idle leases (OnWorkerIdle :197) and
    # returns them when the shape's queue drains.  Results ride the
    # same direct connection back; the head is only involved in the
    # lease grant/return and never sees individual tasks.
    def _lease_eligible(self, spec: TaskSpec) -> bool:
        # Thin clients lease too: the direct worker connections are
        # plain TCP (cross-host safe); only shm attachment is off.
        if not self.config.direct_task_leases:
            return False
        if spec.is_streaming or spec.num_returns != 1:
            return False
        if spec.placement_group_hex or spec.scheduling_strategy is not None:
            return False
        # Every arg must be resolvable without waiting: a leased worker
        # blocking on an unproduced upstream object would hold the
        # lease's resources and can deadlock the pool; the head path
        # queues dep-pending tasks instead (reference: the owner-side
        # DependencyResolver waits before pushing,
        # transport/dependency_resolver.cc).
        for a in spec.args:
            if a.is_ref and not self._ref_resolved(a.object_hex):
                return False
        return True

    def _ref_resolved(self, obj_hex: str) -> bool:
        with self._lock:
            if obj_hex in self._local_known:
                return True
            fut = self._direct_futures.get(obj_hex)
            if fut is None:
                fut = self._object_futures.get(obj_hex)
            return fut is not None and fut.done()

    @staticmethod
    def _shape_of(spec: TaskSpec) -> tuple:
        env_part = ""
        if spec.runtime_env:
            import json

            env_part = hashlib.sha1(json.dumps(
                spec.runtime_env, sort_keys=True).encode()).hexdigest()[:8]
        return (tuple(sorted(spec.resources.items())), env_part)

    def _submit_via_lease(self, spec: TaskSpec):
        spec.direct = True
        self._register_direct(spec.return_ids[0].hex(), "")
        shape = self._shape_of(spec)
        defer = False
        with self._lease_lock:
            pool = self._leases.get(shape)
            if pool is None:
                pool = self._leases[shape] = _LeasePool(
                    spec.resources, spec.runtime_env)
            was_backlogged = bool(pool.queue)
            pool.queue.append(spec)
            pool.idle_since = None
            if was_backlogged:
                # Burst in progress: the workers are saturated (an
                # earlier pump left a backlog), so pumping again per
                # submit only re-sorts the same full pipelines.  Append
                # and let the flusher thread + completion backfills
                # drive assignment — submission overlaps with dispatch
                # and completion draining instead of serializing with
                # them (r4's single_client_tasks_async gap).
                self._pump_shapes.add(shape)
                defer = True
            else:
                self._pump_lease_locked(shape, pool)
        if defer:
            self._ensure_flusher()
            self._flush_ev.set()

    def _pump_deferred_pools(self):
        """Flusher-thread half of the split submit path: assign any
        backlogged shapes' specs to workers (then the same flush cycle
        carries the sends)."""
        with self._lease_lock:
            shapes = list(self._pump_shapes)
            self._pump_shapes.clear()
            for shape in shapes:
                pool = self._leases.get(shape)
                if pool is not None:
                    self._pump_lease_locked(shape, pool)

    def _pump_lease_locked(self, shape: tuple, pool: "_LeasePool"):
        """Lease lock held.  Assign queued specs to granted workers with
        pipeline headroom; ask the head for workers for the rest."""
        depth = self.config.lease_pipeline_depth
        # While more workers are expected IMMINENTLY (granted or
        # spawning), hold pipelining at 1 so concurrent tasks land on
        # distinct workers (parity with the reference's
        # one-lease-per-running-task default); once the fleet is
        # settled — grants exhausted, denied, or the ask has sat
        # unanswered past the scale-up window (the head queued it for a
        # saturated cluster) — pipeline to full depth to absorb the
        # backlog on the workers we do hold.
        if pool.requested > 0 and \
                time.monotonic() - pool.requested_at \
                < self.config.lease_scaleup_clamp_s and \
                len(pool.workers) < self.config.max_lease_workers_per_request:
            depth = 1
        assigns = []
        if pool.queue and pool.workers:
            # Breadth-first, least-loaded first: concurrent tasks land
            # on distinct (ideally empty) workers; pipelining only
            # absorbs backlog beyond the fleet cap.
            order = sorted(pool.workers.items(),
                           key=lambda kv: len(pool.inflight.get(kv[0], ())))
            progress = True
            while pool.queue and progress:
                progress = False
                for whex, addr in order:
                    if not pool.queue:
                        break
                    infl = pool.inflight.setdefault(whex, {})
                    if len(infl) >= depth:
                        continue
                    spec = pool.queue.popleft()
                    task_hex = spec.task_id.hex()
                    infl[task_hex] = spec
                    pool.worker_idle.pop(whex, None)
                    self._lease_of_obj[spec.return_ids[0].hex()] = (
                        shape, whex, task_hex)
                    assigns.append((whex, addr, spec))
                    progress = True
        for whex, addr, spec in assigns:
            key = "lease:" + whex
            obj_hex = spec.return_ids[0].hex()
            with self._lock:
                self._direct_actor_of[obj_hex] = key
                self._direct_inflight.setdefault(key, set()).add(obj_hex)
            self._queue_for_flush("pool", addr, spec)
        if pool.queue and time.monotonic() >= pool.backoff_until and \
                min(len(pool.workers) + len(pool.queue),
                    self.config.max_lease_workers_per_request) \
                - len(pool.workers) - pool.requested > 0:
            # Worker deficit: DEFER the request to the flusher so a
            # submit burst coalesces into one request_lease carrying
            # the whole count — N count=1 requests would each pick a
            # spawn node with no view of the others' demand and stack
            # every spawn on the same node.
            self._lease_request_pending = True
            self._ensure_flusher()
            self._flush_ev.set()

    def _send_lease_requests(self):
        """Deferred lease requests (one per shape, batched count)."""
        if not getattr(self, "_lease_request_pending", False):
            return
        self._lease_request_pending = False
        with self._lease_lock:
            now = time.monotonic()
            for shape, pool in self._leases.items():
                if not pool.queue or now < pool.backoff_until:
                    continue
                # Desired fleet: one worker per still-queued task
                # (tasks that could run concurrently must not serialize
                # behind a pipeline), capped.
                desired = min(len(pool.workers) + len(pool.queue),
                              self.config.max_lease_workers_per_request)
                ask = desired - len(pool.workers) - pool.requested
                if ask <= 0:
                    continue
                self._lease_token_seq += 1
                token = self._lease_token_seq
                self._lease_tokens[token] = [shape, ask]
                pool.requested += ask
                pool.requested_at = time.monotonic()
                try:
                    self.client.send({
                        "op": "request_lease", "token": token,
                        "resources": pool.resources,
                        "runtime_env": pool.runtime_env, "count": ask,
                        # Workers we already hold: with none, the head
                        # must queue (not deny) an unsatisfiable request
                        # so the demand stays visible to the autoscaler.
                        "have": len(pool.workers)})
                except Exception:
                    pool.requested -= ask
                    self._lease_tokens.pop(token, None)

    def _on_lease_granted(self, msg: dict):
        workers = msg.get("workers", ())
        denied = int(msg.get("denied", 0))
        error = msg.get("error", "")
        token = msg.get("token")
        give_back = []
        failed_specs: List[TaskSpec] = []
        with self._lease_lock:
            ent = self._lease_tokens.get(token)
            if ent is None:
                # Lease pool already released (queue drained while the
                # request was in flight): hand the workers straight back.
                give_back = [w["worker"] for w in workers]
                pool = shape = None
            else:
                shape = ent[0]
                ent[1] -= len(workers) + denied
                if ent[1] <= 0:
                    self._lease_tokens.pop(token, None)
                pool = self._leases.get(shape)
                if pool is None:
                    give_back = [w["worker"] for w in workers]
                else:
                    pool.requested = max(
                        0, pool.requested - len(workers) - denied)
                    if workers and pool.requested:
                        # Grants are flowing: keep the scale-up clamp
                        # alive for the remainder of the ask.
                        pool.requested_at = time.monotonic()
                    if denied:
                        # Saturated (or broken env): back off before
                        # re-requesting; keep pipelining what we have.
                        # Applies to partial grants too — immediately
                        # re-asking for the denied remainder would churn
                        # one request/denial per flusher cycle.
                        pool.backoff_until = time.monotonic() + 0.25
                    if error:
                        # Permanent denial (runtime_env setup failed):
                        # fail the queued specs like the head path's
                        # unschedulable fast-fail.
                        import collections

                        failed_specs = list(pool.queue)
                        pool.queue = collections.deque()
                    for w in workers:
                        whex, addr = w["worker"], w["address"]
                        pool.workers[whex] = addr
                        self._lease_addr_workers.setdefault(
                            addr, set()).add(whex)
                    self._pump_lease_locked(shape, pool)
        if failed_specs:
            from ray_tpu_torch.core.exceptions import RuntimeEnvSetupError

            for spec in failed_specs:
                # No worker will ever _finish these specs (same contract
                # as the cancel paths below): release their borrowed args
                # or they stay pinned at the head for the session.
                for bhex in spec.borrows:
                    self._queue_for_flush("decref", None, bhex)
                self._fail_direct(spec.return_ids[0].hex(),
                                  RuntimeEnvSetupError(error))
        if give_back:
            try:
                self.client.send({"op": "release_lease",
                                  "workers": give_back})
            except Exception:
                pass
        # Ship the assignments now — the granting push arrived on the
        # rpc reader thread; the submitting thread may be parked in
        # get() already.
        self._flush_if_pending()

    def _lease_task_completed(self, obj_hex: str):
        """A direct task's result (or failure) arrived: free its
        pipeline slot and feed the lease more work / start its idle
        clock (reference OnWorkerIdle, direct_task_transport.cc:197)."""
        with self._lease_lock:
            ent = self._lease_of_obj.pop(obj_hex, None)
            if ent is None:
                return
            shape, whex, task_hex = ent
            pool = self._leases.get(shape)
            if pool is None:
                return
            pool.inflight.get(whex, {}).pop(task_hex, None)
            if pool.queue:
                self._pump_lease_locked(shape, pool)
            elif not pool.busy():
                pool.idle_since = time.monotonic()

    def _on_lease_worker_lost(self, whex: str, reason: str):
        """A leased worker died (direct connection broke, or the head
        pushed lease_revoked): owner-side retry of its in-flight specs
        through the head path, mirroring the reference's owner-side
        TaskManager retries (task_manager.h:208)."""
        specs: List[TaskSpec] = []
        shape = None
        with self._lease_lock:
            for s, p in self._leases.items():
                # Match by inflight too: a reconnect drops granted
                # workers but keeps their in-flight specs, which must
                # still fail over if the worker then dies.
                if whex in p.workers or p.inflight.get(whex):
                    shape = s
                    pool = p
                    break
            else:
                return
            addr = pool.workers.pop(whex, None)
            if addr is not None:
                peers = self._lease_addr_workers.get(addr)
                if peers is not None:
                    peers.discard(whex)
                    if not peers:
                        self._lease_addr_workers.pop(addr, None)
            for task_hex, spec in pool.inflight.pop(whex, {}).items():
                self._lease_of_obj.pop(spec.return_ids[0].hex(), None)
                specs.append(spec)
        with self._lock:
            self._direct_inflight.pop("lease:" + whex, None)
        from ray_tpu_torch.core.exceptions import WorkerCrashedError

        for spec in specs:
            if spec.retry_count < spec.max_retries:
                spec.retry_count += 1
                self._lease_fallback_resubmit(spec)
            else:
                self._fail_direct(
                    spec.return_ids[0].hex(),
                    WorkerCrashedError(
                        f"task {spec.name or spec.task_id.hex()}: "
                        f"worker died: {reason}"))
        with self._lease_lock:
            pool = self._leases.get(shape)
            if pool is not None and pool.queue:
                self._pump_lease_locked(shape, pool)

    def _lease_fallback_resubmit(self, spec: TaskSpec):
        """Re-route a direct spec through the head's scheduler (worker
        died / lease unavailable): the head registers its returns from
        the spec, and the owner's direct future chains onto the head
        subscription."""
        spec.direct = False
        obj_hex = spec.return_ids[0].hex()
        # Sent inline (not queued): the subscribe below must reach the
        # head AFTER the submit registers the return object.
        try:
            self.client.send({"op": "submit_task", "spec": spec})
        except Exception:
            return  # control plane down; reconnect path re-resolves
        self._chain_head_to_direct(obj_hex)

    def _chain_head_to_direct(self, obj_hex: str):
        """Resolve a direct future from the head's object subscription
        (the same promotion the oversized direct_result_remote path
        uses)."""
        with self._lock:
            fut = self._direct_futures.get(obj_hex)
            head_fut = self._object_futures.get(obj_hex)
            if head_fut is None:
                head_fut = Future()
                self._object_futures[obj_hex] = head_fut
                self._track_resolution(obj_hex, head_fut)
            if obj_hex not in self._subscribed:
                self._subscribed.add(obj_hex)
                self.client.send({"op": "subscribe_objects",
                                  "objs": [obj_hex]})
        if fut is None or fut is head_fut:
            return

        def _chain(hf, fut=fut):
            if fut.done():
                return
            try:
                fut.set_result(hf.result(timeout=0))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        head_fut.add_done_callback(_chain)

    def _sweep_idle_leases(self):
        """Return leases idle past the timeout (reference
        OnWorkerIdle lease return after worker_lease_timeout)."""
        now = time.monotonic()
        to_release: List[str] = []
        with self._lease_lock:
            for shape, pool in list(self._leases.items()):
                if pool.busy():
                    pool.idle_since = None
                    # Backed-off pool whose window expired: retry the
                    # lease request for freed capacity.
                    if pool.queue and pool.requested == 0 and \
                            now >= pool.backoff_until:
                        self._pump_lease_locked(shape, pool)
                    if not pool.queue:
                        to_release += self._sweep_idle_workers_locked(
                            pool, now)
                    continue
                if pool.idle_since is None:
                    pool.idle_since = now
                    continue
                if now - pool.idle_since < self.config.lease_idle_timeout_s:
                    continue
                for whex, addr in pool.workers.items():
                    to_release.append(whex)
                    peers = self._lease_addr_workers.get(addr)
                    if peers is not None:
                        peers.discard(whex)
                        if not peers:
                            self._lease_addr_workers.pop(addr, None)
                del self._leases[shape]
                # Outstanding request tokens for the released pool
                # would otherwise linger forever (their late grants hit
                # the pool-is-gone give-back path without consuming the
                # token when partially filled).
                for tok in [t for t, ent in self._lease_tokens.items()
                            if ent[0] == shape]:
                    self._lease_tokens.pop(tok, None)
        if to_release:
            try:
                self.client.send({"op": "release_lease",
                                  "workers": to_release})
            except Exception:
                pass

    def _sweep_idle_workers_locked(self, pool: "_LeasePool",
                                   now: float) -> List[str]:
        """Lease lock held; `pool` busy with nothing queued.  Take out of
        the pool, and return, its workers idle past the timeout while
        others still run (reference OnWorkerIdle returns each idle
        worker's lease when its scheduling key has nothing queued).
        Returning only whole pools let a pool hold every CPU of the
        node while one task ran, and a task of that one blocked in
        get() on a nested task that no worker was left to run."""
        out = []
        for whex in list(pool.workers):
            if pool.inflight.get(whex):
                pool.worker_idle.pop(whex, None)
                continue
            since = pool.worker_idle.setdefault(whex, now)
            if now - since < self.config.lease_idle_timeout_s:
                continue
            addr = pool.workers.pop(whex)
            pool.inflight.pop(whex, None)
            del pool.worker_idle[whex]
            peers = self._lease_addr_workers.get(addr)
            if peers is not None:
                peers.discard(whex)
                if not peers:
                    self._lease_addr_workers.pop(addr, None)
            out.append(whex)
        return out

    def _release_all_leases(self):
        with self._lease_lock:
            workers = [whex for pool in self._leases.values()
                       for whex in pool.workers]
            self._leases.clear()
            self._lease_addr_workers.clear()
            self._lease_tokens.clear()
        if workers:
            try:
                self.client.send({"op": "release_lease",
                                  "workers": workers})
            except Exception:
                pass

    def cancel_ref(self, obj_hex: str, force: bool = False) -> bool:
        """ray.cancel() entry: lease-path tasks are the owner's to
        cancel (the head never saw them); everything else goes to the
        head (reference: CancelTask is owner-initiated,
        core_worker.proto:441)."""
        from ray_tpu_torch.core.exceptions import TaskCancelledError

        with self._lease_lock:
            # Queued, not yet assigned: drop it locally.
            for pool in self._leases.values():
                for i, spec in enumerate(pool.queue):
                    if spec.return_ids and \
                            spec.return_ids[0].hex() == obj_hex:
                        del pool.queue[i]
                        # No worker will ever _finish this spec: the
                        # borrow decrefs are the owner's to issue, or
                        # the args stay pinned for the session.
                        for bhex in spec.borrows:
                            self._queue_for_flush("decref", None, bhex)
                        self._fail_direct(obj_hex, TaskCancelledError(
                            f"task {spec.name or spec.task_id.hex()}: "
                            "task cancelled"))
                        return True
            ent = self._lease_of_obj.get(obj_hex)
        if ent is not None:
            if not force:
                # Dispatched, but possibly still QUEUED on the worker
                # (pipelined behind a running task).  Ask the executor to
                # drop it from its queue — the reference cancels here too
                # (normal_scheduling_queue CancelTaskIfFound); only a
                # task that already started is uncancellable sans force.
                shape, whex, task_hex = ent
                with self._lease_lock:
                    pool = self._leases.get(shape)
                    addr = pool.workers.get(whex) if pool else None
                if addr is None:
                    return False
                # The spec may still sit in the coalescing send buffer —
                # a direct .call() would overtake it on the socket and
                # the worker would truthfully say "not queued".  Cancel
                # it right out of the buffer when possible; flush
                # otherwise so the queue scan sees it.
                dropped = None
                with self._send_lock:  # NB: never nest _lease_lock inside
                    specs = self._pending_pool.get(addr, [])
                    for i, s in enumerate(specs):
                        if s.task_id is not None \
                                and s.task_id.hex() == task_hex:
                            del specs[i]
                            self._pending_count -= 1
                            dropped = s
                            break
                if dropped is not None:
                    for bhex in dropped.borrows:  # no worker will _finish it
                        self._queue_for_flush("decref", None, bhex)
                    self._fail_direct(obj_hex, TaskCancelledError(
                        "task cancelled"))
                    return True
                self._flush_direct_sends()
                try:
                    reply = self._actor_conn(addr).call(
                        {"op": "cancel_pool_task", "task": task_hex},
                        timeout=10.0)
                except Exception:
                    return False
                if not (reply or {}).get("cancelled"):
                    return False  # already executing
                self._fail_direct(obj_hex, TaskCancelledError(
                    "task cancelled"))
                return True
            shape, whex, task_hex = ent
            with self._lease_lock:
                pool = self._leases.get(shape)
                spec = pool.inflight.get(whex, {}).get(task_hex) \
                    if pool is not None else None
            if spec is not None:
                spec.max_retries = spec.retry_count  # no retry on kill
            self._fail_direct(obj_hex, TaskCancelledError(
                "task cancelled (force)"))
            try:
                self.client.send({"op": "kill_worker", "worker": whex})
            except Exception:
                pass
            return True
        try:
            return bool(self.client.call(
                {"op": "cancel_object", "obj": obj_hex, "force": force}))
        except Exception:
            return False

    # ------------------------------------------------------------------
    # Objects
    def object_future(self, obj_hex: str) -> Future:
        return self.object_futures([obj_hex])[0]

    def object_futures(self, obj_hexes: Sequence[str]) -> List[Future]:
        """Batch variant: ONE subscribe message for all new hexes (a
        get() of N refs used to cost N control messages).  Owner-direct
        actor results resolve from local futures — no head subscribe."""
        if self._pending_count:
            self._flush_direct_sends()
        futs: List[Future] = []
        new: List[str] = []
        created: List[tuple] = []
        with self._lock:
            for obj_hex in obj_hexes:
                fut = self._direct_futures.get(obj_hex)
                if fut is not None:
                    futs.append(fut)
                    continue
                fut = self._object_futures.get(obj_hex)
                if fut is None:
                    fut = Future()
                    self._object_futures[obj_hex] = fut
                    created.append((obj_hex, fut))
                futs.append(fut)
                if obj_hex not in self._subscribed:
                    self._subscribed.add(obj_hex)
                    new.append(obj_hex)
            if new:
                self.client.send({"op": "subscribe_objects", "objs": new})
        for obj_hex, fut in created:
            self._track_resolution(obj_hex, fut)
        return futs

    def _load_object(self, obj_hex: str, info: dict,
                     timeout: Optional[float] = None,
                     _attempt: int = 0,
                     _deadline: Optional[float] = None) -> Any:
        # An explicit caller timeout is a TOTAL budget across every
        # refetch retry round, not per round: convert it to a deadline
        # once and hand each round the remainder.
        if timeout is not None and _deadline is None:
            _deadline = time.monotonic() + timeout
        if info.get("direct"):
            # Owner-direct actor result: the serialized bytes arrived on
            # the direct actor connection (never touched the head).
            return self._finish_load(obj_hex, info["data"], info)
        if info.get("inline") is not None:
            data = info["inline"]
        elif info.get("in_shm"):
            if self.store is None:
                # Thin client: the server reads the shm payload for us.
                # with_meta: the error flag must come from the same
                # snapshot as the payload — the object may have become an
                # ObjectLostError after this client cached `info`.
                reply = self.client.call({"op": "fetch_object",
                                          "obj": obj_hex,
                                          "with_meta": True})
                if reply is None or reply.get("data") is None:
                    raise RuntimeError(
                        f"object {obj_hex} no longer available")
                return self._finish_load(
                    obj_hex, reply["data"],
                    {**info, "is_error": reply["is_error"]})
            try:
                seg = self.store.attach(ObjectID.from_hex(obj_hex),
                                        info["size"])
            except Exception as e:  # noqa: BLE001
                if info.get("node", "head") != self.store_node:
                    # Not in this node's arena (and no cached replica):
                    # pull the bytes from the holding node over the
                    # object plane (reference ObjectManager Pull,
                    # object_manager.h:139) and cache them locally.
                    try:
                        data = self._pull_remote_object(obj_hex, info)
                        return self._finish_load(obj_hex, data, info)
                    except Exception:
                        if _attempt >= 3:
                            raise
                        # Node dead or its arena evicted the copy: tell
                        # the head (it verifies and kicks lineage
                        # reconstruction), then re-subscribe for the
                        # recovered value.
                        try:
                            self.client.call(
                                {"op": "report_object_lost",
                                 "obj": obj_hex}, timeout=30.0)
                        except Exception:
                            pass
                        e = FileNotFoundError(obj_hex)
                # Stale location: the server may have SPILLED the object
                # after this client cached its in-shm info. Drop the
                # cached future + subscription and re-subscribe — the
                # server restores spilled objects on subscribe.  Bounded
                # RETRIES, not one shot: under arena pressure a
                # lineage-reconstructed value can get spilled again
                # between the server's publish and our attach, and one
                # more subscribe round is the correct response.
                if _attempt >= 3 or not _is_missing_segment_error(e):
                    raise
                fut = self._refetch_object(obj_hex)
                try:
                    # Honor an explicit caller deadline fully; for
                    # timeout=None gets, bound the wait generously (a
                    # truly freed object's fresh subscription would stay
                    # PENDING forever, but slow external-storage restores
                    # must be allowed to finish).
                    info2 = fut.result(
                        timeout=max(_deadline - time.monotonic(), 0.1)
                        if _deadline is not None else 300.0)
                except (TimeoutError, _FutureTimeoutError):
                    raise GetTimeoutError(
                        f"timed out refetching {obj_hex}") from None
                return self._load_object(obj_hex, info2,
                                         _attempt=_attempt + 1,
                                         _deadline=_deadline)
            if info.get("node", "head") != self.store_node:
                # Primary copy lives elsewhere but attach succeeded:
                # a previously pulled replica served this read from shm.
                object_plane.OBJ._inc("arena_cache_hits")
            data = seg.buf[: info["size"]]
        else:
            raise RuntimeError(f"object {obj_hex} ready but has no payload")
        return self._finish_load(obj_hex, data, info)

    def _finish_load(self, obj_hex: str, data, info: dict) -> Any:
        # Collect borrow increfs for every ref inside the value into ONE
        # control message (a get() of an object holding 10k refs used to
        # cost 10k sends).
        self._tls.incref_buf = buf = []
        try:
            value = serialization.deserialize(
                data, ref_deserializer=self._on_ref_deser)
        finally:
            self._tls.incref_buf = None
            # Send whatever was buffered even if deserialize raised
            # partway: the already-constructed refs will decref on GC,
            # and uncovered increfs would underflow head refcounts.
            if buf:
                try:
                    self.client.send({"op": "incref_batch", "objs": buf})
                except Exception:
                    pass
        if info.get("is_error"):
            raise value
        return value

    def _node_conn(self, address: str) -> rpc.Client:
        """Connection to another node's object server (cached).  The dial
        happens OUTSIDE self._lock — a dead node's connect retries must
        not stall this process's object subscription path."""
        with self._lock:
            conn = self._node_conns.get(address)
        if conn is not None and not conn._closed:
            return conn
        conn = rpc.Client(address, connect_timeout=5.0)
        with self._lock:
            existing = self._node_conns.get(address)
            if existing is not None and not existing._closed:
                conn.close()
                return existing
            self._node_conns[address] = conn
        return conn

    def _nm_pull(self, obj_hex: str, size: int, addr: str):
        """Route a remote fetch through this host's node manager
        (RAY_TPU_LOCAL_NM, set for spawned workers): the NM single-
        flights per object at NODE level, so two workers on one host
        never pull the same object over the wire twice — the bytes land
        once in the shared arena and both read it via attach().
        Returns the payload view on success, None to fall back to the
        direct per-process pull (driver processes, RAY_TPU_NM_PULL=0,
        arena-full degradation, NM errors)."""
        if self.store is None:
            return None
        nm_addr = os.environ.get("RAY_TPU_LOCAL_NM", "")
        if not nm_addr or os.environ.get(
                "RAY_TPU_NM_PULL", "1").strip().lower() in (
                "0", "false", "no", "off"):
            return None
        try:
            nm = self._node_conn(nm_addr)
            r = nm.call({"op": "pull_object", "obj": obj_hex,
                         "size": size, "addr": addr}, timeout=150.0)
            if not (r and r.get("cached")):
                return None  # NM degraded to uncached — pull directly
            view = self.store.attach(ObjectID.from_hex(obj_hex), size)
            return view.buf[:size]
        except Exception:  # raylint: allow-swallow(NM pull is best-effort; caller falls back to a direct pull)
            return None

    def _pull_remote_object(self, obj_hex: str, info: dict):
        """Windowed chunked pull of an object living in another node's
        arena (reference ObjectManager chunked transfer via
        object_buffer_pool).  addr == "" means the head arena: chunks
        ride the control client.  Chunks land directly in a pre-created
        local arena segment (no intermediate full-size buffer) so later
        readers on this node hit shm, and concurrent pulls of the same
        object in this process coalesce onto one wire transfer
        (object_plane.PullManager)."""

        def _do_pull():
            # One-way announce BEFORE the transfer: the head credits
            # this node in the locality tie-break while the pull is in
            # flight (gcs._locality_bytes "pulling" credit), so a task
            # chasing this object can land here instead of triggering a
            # second transfer elsewhere.  Best-effort; the
            # object_replica announce below supersedes it on landing.
            try:
                self.client.send(
                    {"op": "object_pull_started", "obj": obj_hex})
            except Exception:
                pass
            size = info["size"]
            addr = info.get("addr", "")
            nm_data = self._nm_pull(obj_hex, size, addr)
            if nm_data is not None:
                return nm_data
            client = self._node_conn(addr) if addr else self.client
            data, cached = object_plane.pull_into_store(
                client, self.store, obj_hex, size,
                self.config.transfer_chunk_bytes,
                window=self.config.pull_window, timeout=120.0)
            if cached:
                # Tell the directory about the replica so a cluster-wide
                # free deletes this arena's copy too (no leak on
                # consumer nodes).
                self.client.send({"op": "object_replica", "obj": obj_hex})
            return data

        return self._pull_manager.pull(obj_hex, _do_pull, timeout=150.0)

    def forget_object(self, obj_hex: str):
        """Retire a speculative subscription (a stream-item probe for an
        index the stream ended before): drop the local future and tell
        the directory to delete the PENDING placeholder if nothing else
        references it — otherwise every consumed stream leaks one
        entry on the head and one future here."""
        with self._lock:
            self._object_futures.pop(obj_hex, None)
            self._subscribed.discard(obj_hex)
        self._resolved.discard(obj_hex)
        try:
            self.client.send({"op": "forget_object", "obj": obj_hex})
        except Exception:
            pass

    def _refetch_object(self, obj_hex: str) -> Future:
        """Forget the resolved location of an object and subscribe again
        (used when a cached in-shm location went stale via spilling or
        loss)."""
        with self._lock:
            self._object_futures.pop(obj_hex, None)
            self._subscribed.discard(obj_hex)
            # A stale DIRECT future must go too: object_futures prefers
            # it, so leaving it would replay the dead location forever
            # (oversized direct results resolve to an in_shm pointer).
            fut = self._direct_futures.get(obj_hex)
            if fut is not None and fut.done():
                self._direct_futures.pop(obj_hex, None)
        self._resolved.discard(obj_hex)
        return self.object_future(obj_hex)

    def _on_ref_deser(self, ref: ObjectRef):
        # A ref arrived inside a deserialized value: register a borrow so the
        # owner keeps the object alive while this process holds the ref
        # (reference borrowing protocol, reference_count.h).
        buf = getattr(self._tls, "incref_buf", None)
        if buf is not None:
            buf.append(ref.hex())
            return
        try:
            self.client.send({"op": "incref", "obj": ref.hex()})
        except Exception:
            pass

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None):
        futs = self.object_futures([r.hex() for r in refs])
        deadline = None if timeout is None else time.monotonic() + timeout
        results = []
        for r, fut in zip(refs, futs):
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise GetTimeoutError(f"get() timed out on {r}")
            try:
                info = fut.result(timeout=remaining)
            except (TimeoutError, _FutureTimeoutError):
                # Both spellings: concurrent.futures.TimeoutError only
                # became the builtin TimeoutError in Python 3.11.
                raise GetTimeoutError(f"get() timed out on {r}") from None
            remaining = None if deadline is None \
                else max(deadline - time.monotonic(), 0.1)
            results.append(self._load_object(r.hex(), info,
                                             timeout=remaining))
        return results

    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.from_random()
        self._store_value(oid, value)
        return ObjectRef(oid, owner=self.worker_hex)

    def put_serialized(self, ser) -> "ObjectRef":
        """Store an already-serialized value without re-pickling it.

        The big-arg submit path serializes once to measure size; routing
        the resulting ``Serialized`` here (instead of ``put(value)``,
        which re-serializes from scratch) halves the CPU cost of every
        over-inline-threshold argument and lets pickle5 out-of-band
        buffers flow straight into the arena segment."""
        oid = ObjectID.from_random()
        for hex_id in ser.contained_refs:
            self._maybe_promote_direct(hex_id)
        self._store_serialized(oid, ser)
        return ObjectRef(oid, owner=self.worker_hex)

    def _serialize_for_ship(self, value: Any):
        """Serialize a value that is leaving this process, promoting any
        direct-owned refs it contains so remote holders can resolve them."""
        ser = serialization.serialize(value)
        for hex_id in ser.contained_refs:
            self._maybe_promote_direct(hex_id)
        return ser

    def _store_value(self, oid: ObjectID, value: Any, is_error: bool = False):
        ser = self._serialize_for_ship(value)
        return self._store_serialized(oid, ser, is_error=is_error)

    def _store_serialized(self, oid: ObjectID, ser, is_error: bool = False,
                          lineage_spec=None):
        with self._lock:
            self._local_known.add(oid.hex())
        size = ser.total_bytes
        # Thin clients ship everything inline over the connection (bounded
        # only by the rpc frame limit); full clients inline small objects
        # and put the rest in shm.
        if self.store is None:
            if size > self.config.rpc_max_message_bytes:
                raise ValueError(
                    f"object of {size} bytes exceeds the thin client's "
                    f"message limit ({self.config.rpc_max_message_bytes});"
                    " connect a full driver (ray_tpu_torch.init(address=...)) "
                    "for shared-memory puts")
            inline_ok = True
        else:
            inline_ok = size <= self.config.max_inline_object_size
        if inline_ok:
            data = ser.to_bytes()
            if not is_error and size <= 64 * 1024:
                with self._lock:
                    prev = self._inline_cache.pop(oid.hex(), None)
                    if prev is not None:  # overwrite (retry/recon re-put)
                        self._inline_cache_bytes -= len(prev)
                    self._inline_cache[oid.hex()] = data
                    self._inline_cache_bytes += size
                    while self._inline_cache_bytes > 16 * 1024 * 1024 \
                            and self._inline_cache:
                        old, blob = next(iter(self._inline_cache.items()))
                        del self._inline_cache[old]
                        self._inline_cache_bytes -= len(blob)
            self._send_or_buffer({
                "op": "put_object", "obj": oid.hex(), "size": size,
                "inline": data, "is_error": is_error,
            })
        else:
            seg = self.store.create(oid, size)
            ser.write_into(seg.buf[:size])
            self.store.seal(oid)
            put = {
                "op": "put_object", "obj": oid.hex(), "size": size,
                "inline": None, "in_shm": True, "is_error": is_error,
            }
            if lineage_spec is not None:
                put["lineage"] = lineage_spec
            self._send_or_buffer(put)

    def _send_or_buffer(self, msg: dict):
        buf = getattr(self._tls, "put_buffer", None)
        if buf is not None:
            buf.append(msg)
        else:
            # Ride the ordered coalescing queue: consecutive puts collapse
            # into one put_object_batch frame (head registers the run
            # under one lock hold), and ordering against later submits
            # that reference the object is preserved.  get()/wait()/
            # direct sends flush first, so visibility is unchanged.
            self._queue_for_flush("put", None, msg)

    def begin_put_batch(self):
        self._tls.put_buffer = []

    def take_put_batch(self) -> List[dict]:
        buf = getattr(self._tls, "put_buffer", None) or []
        self._tls.put_buffer = None
        return buf

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None):
        """Readiness via the resolved-hex set (maintained by future
        done-callbacks): each call is set-membership over the refs plus
        a condition wait — no per-future lock traffic, so the classic
        pop-one-of-N polling loop is O(n) set lookups per call instead
        of O(n) future-lock acquisitions."""
        if self._pending_count:
            self._flush_direct_sends()
        resolved = self._resolved
        hexes = [r._hex for r in refs]
        # Refs this process doesn't track yet need futures/subscriptions
        # (and their done-callbacks feed the resolved set).
        with self._lock:
            untracked = [
                h for h in hexes
                if h not in resolved and h not in self._direct_futures
                and h not in self._object_futures]
        if untracked:
            self.object_futures(hexes)
        deadline = None if timeout is None else time.monotonic() + timeout
        # More returns than refs can never be satisfied — clamp so the
        # loop terminates once everything resolved (wait([]) included).
        num_returns = min(num_returns, len(hexes))
        if not hexes:
            return [], []

        def _first_idx():
            for i, h in enumerate(hexes):
                if h in resolved:
                    return i
            return -1

        if num_returns == 1:
            # The pop-one-of-N polling idiom: early-exit scan + C-speed
            # list slicing keep each call near O(position of first
            # resolved) instead of O(n) Python-level list building.
            with self._resolved_cond:
                while True:
                    idx = _first_idx()
                    if idx >= 0:
                        break
                    remaining = None if deadline is None else \
                        deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        break
                    if not self._resolved_cond.wait(timeout=remaining):
                        break
            if idx < 0:
                return [], list(refs)
            refs = list(refs)
            return [refs[idx]], refs[:idx] + refs[idx + 1:]

        with self._resolved_cond:
            while True:
                n_ready = sum(1 for h in hexes if h in resolved)
                if n_ready >= num_returns:
                    break
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                if not self._resolved_cond.wait(timeout=remaining):
                    break
        # Single-pass partition: resolved refs beyond num_returns stay
        # in not_ready, per wait() semantics.
        ready: List[ObjectRef] = []
        not_ready: List[ObjectRef] = []
        for r, h in zip(refs, hexes):
            if len(ready) < num_returns and h in resolved:
                ready.append(r)
            else:
                not_ready.append(r)
        return ready, not_ready

    def on_ref_deleted(self, object_id: ObjectID):
        """Runs from ObjectRef.__del__ — i.e. at ARBITRARY GC points,
        possibly while this thread holds runtime or socket locks.  It
        must only touch the RLock'd flush queue: the decref rides the
        ordered head queue (naturally AFTER the submit that registered
        the object), and the background flusher ships it."""
        if self._closed:
            return
        obj_hex = object_id.hex()
        # Bare discard (no cond): set ops are GIL-atomic, and taking the
        # non-reentrant condition from a GC-triggered __del__ could
        # deadlock against a thread inside _mark_resolved.
        self._resolved.discard(obj_hex)
        with self._lock:
            self._local_known.discard(obj_hex)
            blob = self._inline_cache.pop(obj_hex, None)
            if blob is not None:
                self._inline_cache_bytes -= len(blob)
            if obj_hex in self._direct_futures:
                self._direct_futures.pop(obj_hex, None)
                actor_hex = self._direct_actor_of.pop(obj_hex, "")
                self._direct_inflight.get(actor_hex, set()).discard(obj_hex)
                # Never promoted → the head has no entry: purely local
                # cleanup, zero control messages for the whole call.
                if obj_hex not in self._direct_promoted:
                    return
                self._direct_promoted.discard(obj_hex)
        try:
            self._queue_for_flush("decref", None, obj_hex, from_del=True)
        except Exception:
            pass

    # ------------------------------------------------------------------
    # Task submission
    def _prepare_args(self, args: Sequence[Any], borrows: List[str]):
        out: List[TaskArg] = []
        for a in args:
            if isinstance(a, ObjectRef):
                cached = self._inline_cache.get(a.hex())
                if cached is not None:
                    # Hydrate: the executor gets the value inline — no
                    # borrow, no incref, no fetch round trips (top-level
                    # ref args resolve to values either way).
                    out.append(TaskArg(is_ref=False, data=cached))
                    continue
                self._maybe_promote_direct(a.hex())
                borrows.append(a.hex())
                # Queued (not sent): the submit that registered this ref
                # may itself still be in the flush queue — the incref
                # must reach the head AFTER it or it no-ops.
                self._queue_for_flush("incref", None, a.hex())
                out.append(TaskArg(is_ref=True, object_hex=a.hex()))
            else:
                ser = serialization.serialize(a)
                for hex_id in ser.contained_refs:
                    self._maybe_promote_direct(hex_id)
                    borrows.append(hex_id)
                    self._queue_for_flush("incref", None, hex_id)
                if ser.total_bytes > self.config.max_inline_object_size:
                    # Reuse the serialization we just produced: put(a)
                    # would pickle the arg a second time (and memcpy its
                    # buffers twice for a 64 MiB array).
                    ref = self.put_serialized(ser)
                    borrows.append(ref.hex())
                    # Same ordered queue as the put itself: a direct send
                    # would reach the head BEFORE the buffered put_object
                    # (no-op incref), and the temp ref's __del__ decref —
                    # also queued — would then free the fresh object.
                    self._queue_for_flush("incref", None, ref.hex())
                    out.append(TaskArg(is_ref=True, object_hex=ref.hex()))
                else:
                    out.append(TaskArg(is_ref=False, data=ser.to_bytes()))
        return out

    def ensure_func(self, func_id: str, blob: bytes) -> Optional[bytes]:
        """Upload the function blob once per session; return None if cached."""
        if func_id in self._sent_funcs:
            return None
        self.client.send({"op": "put_func", "func_id": func_id, "blob": blob})
        self._sent_funcs.add(func_id)
        return None

    def fetch_func(self, func_id: str) -> Optional[bytes]:
        return self.client.call({"op": "get_func", "func_id": func_id})

    def _prepare_runtime_env(self, runtime_env: Optional[dict]
                             ) -> Optional[dict]:
        """The reference packages working_dir/py_modules here
        (runtime_env/packaging.py); the port takes `env_vars` only."""
        if not runtime_env:
            return runtime_env
        check_runtime_env(runtime_env)
        return runtime_env

    @staticmethod
    def _split_strategy(scheduling_strategy):
        """Extract (pg_hex, bundle_index, residual_strategy).

        PlacementGroupSchedulingStrategy becomes spec fields (the scheduler
        keys on them); other strategies ship as-is."""
        if scheduling_strategy is None:
            return "", -1, None
        if type(scheduling_strategy).__name__ == \
                "PlacementGroupSchedulingStrategy":
            pg = scheduling_strategy.placement_group
            return (pg._pg_hex,
                    scheduling_strategy.placement_group_bundle_index, None)
        return "", -1, scheduling_strategy

    def submit_task(self, func_id: str, func_blob: bytes, args: Sequence[Any],
                    num_returns, resources: Dict[str, float],
                    max_retries: int, name: str = "",
                    runtime_env: Optional[dict] = None,
                    scheduling_strategy=None):
        """Returns a list of ObjectRefs, or an ObjectRefGenerator when
        num_returns == "streaming" (core/streaming.py)."""
        from ray_tpu_torch.core.streaming import STREAMING, ObjectRefGenerator

        streaming = num_returns == STREAMING
        borrows: List[str] = []
        task_args = self._prepare_args(args, borrows)
        self.ensure_func(func_id, func_blob)
        runtime_env = self._prepare_runtime_env(runtime_env)
        return_ids = [] if streaming else [
            ObjectID.from_random() for _ in range(num_returns)]
        pg_hex, bundle_index, scheduling_strategy = self._split_strategy(
            scheduling_strategy)
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            func_id=func_id,
            func_blob=None,
            args=task_args,
            num_returns=0 if streaming else num_returns,
            return_ids=return_ids,
            resources=resources,
            max_retries=max_retries,
            name=name,
            owner=self.worker_hex,
            runtime_env=runtime_env,
            scheduling_strategy=scheduling_strategy,
            placement_group_hex=pg_hex,
            bundle_index=bundle_index,
            borrows=borrows,
            is_streaming=streaming,
            trace_ctx=_make_trace_ctx(),
        )
        if self._lease_eligible(spec):
            # Owner-direct lease path: the head never sees this task
            # (reference direct task transport).
            self._submit_via_lease(spec)
        else:
            self._queue_for_flush("submit", None, spec)
        if streaming:
            return ObjectRefGenerator(spec.task_id)
        return [ObjectRef(oid, owner=self.worker_hex) for oid in return_ids]

    # ------------------------------------------------------------------
    # Actors
    def create_actor(self, class_id: str, class_blob: bytes,
                     args: Sequence[Any], resources: Dict[str, float],
                     max_restarts: int, name: str, namespace: str,
                     max_concurrency: int,
                     max_task_retries: int = 0,
                     concurrency_groups: Optional[Dict[str, int]] = None,
                     runtime_env: Optional[dict] = None,
                     scheduling_strategy=None) -> ActorID:
        borrows: List[str] = []
        task_args = self._prepare_args(args, borrows)
        self.ensure_func(class_id, class_blob)
        runtime_env = self._prepare_runtime_env(runtime_env)
        actor_id = ActorID.from_random()
        pg_hex, bundle_index, scheduling_strategy = self._split_strategy(
            scheduling_strategy)
        spec = ActorCreationSpec(
            actor_id=actor_id,
            class_id=class_id,
            class_blob=None,
            args=task_args,
            resources=resources,
            max_restarts=max_restarts,
            max_task_retries=max_task_retries,
            name=name,
            namespace=namespace,
            max_concurrency=max_concurrency,
            concurrency_groups=concurrency_groups or None,
            owner=self.worker_hex,
            runtime_env=runtime_env,
            scheduling_strategy=scheduling_strategy,
            placement_group_hex=pg_hex,
            bundle_index=bundle_index,
        )
        self.client.send({"op": "create_actor", "spec": spec})
        self.client.send({"op": "subscribe_actor", "actor": actor_id.hex()})
        with self._actor_cv:
            self._actor_queues.setdefault(actor_id.hex(), [])
        return actor_id

    def subscribe_actor(self, actor_hex: str):
        with self._actor_cv:
            if actor_hex not in self._actor_state:
                self.client.send({"op": "subscribe_actor", "actor": actor_hex})
                self._actor_queues.setdefault(actor_hex, [])

    def actor_state(self, actor_hex: str) -> Optional[dict]:
        with self._actor_cv:
            return self._actor_state.get(actor_hex)

    def wait_actor_alive(self, actor_hex: str, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._actor_cv:
            while True:
                st = self._actor_state.get(actor_hex)
                if st is not None and st["state"] in ("ALIVE", "DEAD"):
                    return st
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(f"actor {actor_hex} not alive in time")
                self._actor_cv.wait(timeout=remaining)

    def submit_actor_task(self, actor_hex: str, method_name: str,
                          args: Sequence[Any], num_returns,
                          name: str = ""):
        """num_returns may be "streaming": the method is a generator and
        each yield becomes its own object (core/streaming.py), returned
        as an ObjectRefGenerator — the streaming-response path serve's
        ingress uses for token streams."""
        from ray_tpu_torch.core.streaming import (
            STREAMING,
            ObjectRefGenerator,
            stream_eos_id,
        )

        streaming = num_returns == STREAMING
        borrows: List[str] = []
        task_args = self._prepare_args(args, borrows)
        task_id = TaskID.from_random()
        return_ids = [] if streaming else [
            ObjectID.from_random() for _ in range(num_returns)]
        # Plain single-return calls take the owner-direct path: the
        # result rides the direct actor connection back and the head
        # never sees the call (reference: direct actor transport — GCS
        # uninvolved — plus the in-process store for small returns).
        direct = not streaming and num_returns == 1
        if direct:
            self._register_direct(return_ids[0].hex(), actor_hex)
        else:
            # Register returns under the actor so its death fails
            # waiters; for streams that role falls to the EOS object.
            reg = [stream_eos_id(task_id).hex()] if streaming else \
                [oid.hex() for oid in return_ids]
            self.client.send({
                "op": "register_objects",
                "objs": reg,
                "actor": actor_hex,
            })
        spec = TaskSpec(
            task_id=task_id,
            func_id="", func_blob=None,
            args=task_args,
            num_returns=0 if streaming else num_returns,
            return_ids=return_ids,
            resources={},
            owner=self.worker_hex,
            actor_id=ActorID.from_hex(actor_hex),
            method_name=method_name,
            name=name or method_name,
            borrows=borrows,
            is_streaming=streaming,
            direct=direct,
            trace_ctx=_make_trace_ctx(),
        )
        self._route_actor_task(actor_hex, spec)
        if streaming:
            return ObjectRefGenerator(spec.task_id)
        return [ObjectRef(oid, owner=self.worker_hex) for oid in return_ids]

    def _route_actor_task(self, actor_hex: str, spec: TaskSpec):
        with self._actor_cv:
            st = self._actor_state.get(actor_hex)
            if st is None or st["state"] in ("PENDING_CREATION", "RESTARTING"):
                self._actor_queues.setdefault(actor_hex, []).append(spec)
                if st is None:
                    self.client.send(
                        {"op": "subscribe_actor", "actor": actor_hex})
                return
            if st["state"] == "DEAD":
                self._fail_actor_task(spec, st.get("reason", "actor dead"))
                return
            address = st["address"]
        self._send_actor_task(actor_hex, address, spec)

    def _actor_conn(self, address: str) -> rpc.Client:
        with self._lock:
            conn = self._actor_conns.get(address)
            if conn is not None:
                return conn
        # Dial outside the lock; on_push carries owner-direct results.
        conn = rpc.Client(
            address, on_push=self._on_direct_push,
            on_disconnect=lambda: self._on_direct_conn_lost(address))
        with self._lock:
            existing = self._actor_conns.get(address)
            if existing is not None:
                conn.close()
                return existing
            self._actor_conns[address] = conn
        return conn

    def _on_direct_conn_lost(self, address: str):
        """A direct (actor / leased-worker) connection dropped.  Actor
        callers recover via the head's actor_update pushes; lease
        workers are the owner's to fail over."""
        if self._closed:
            return
        with self._lock:
            conn = self._actor_conns.get(address)
            if conn is not None and conn._closed:
                self._actor_conns.pop(address, None)
        with self._lease_lock:
            whexes = list(self._lease_addr_workers.get(address, ()))
        for whex in whexes:
            self._on_lease_worker_lost(whex, "connection lost")

    def _send_actor_task(self, actor_hex: str, address: str, spec: TaskSpec):
        # One persistent flusher per client (not a timer per burst:
        # thread spawns cost more than the flush).  It is the
        # fire-and-forget safety net; the common case is the submitting
        # thread flushing at its next get()/wait().
        self._queue_for_flush("direct", address, spec)

    def _flush_if_pending(self):
        if self._pending_count:
            self._flush_direct_sends()
        if getattr(self, "_lease_request_pending", False):
            self._send_lease_requests()

    def _ensure_flusher(self):
        start = False
        with self._send_lock:
            if not self._flusher_started:
                self._flusher_started = True
                start = True
        if start:
            threading.Thread(target=self._send_flusher,
                             name="direct-send-flush",
                             daemon=True).start()

    def _send_flusher(self):
        while not self._closed:
            # With live leases the flusher doubles as the idle-lease
            # sweeper (bounded wait); otherwise it parks until woken.
            self._flush_ev.wait(timeout=0.1 if self._leases else None)
            self._flush_ev.clear()
            time.sleep(0.002)
            try:
                self._pump_deferred_pools()
                self._flush_direct_sends()
                self._send_lease_requests()
                if self._leases:
                    self._sweep_idle_leases()
            except Exception:
                # The flusher is the fire-and-forget safety net; it must
                # survive transient send failures (head restart window).
                time.sleep(0.05)

    def _queue_for_flush(self, kind: str, key, item, from_del=False):
        """Shared enqueue for coalesced control sends (actor tasks, head
        submits, borrow increfs and ref-deletion decrefs — refcount ops
        must stay ORDERED after the submits that register their
        objects); flushed by get()/wait(), the 64-item cap, or the 2 ms
        flusher.  Safe to re-enter from __del__ (pure queue appends
        under an RLock; the flusher thread start happens outside)."""
        start_flusher = False
        with self._send_lock:
            if kind == "direct":
                self._pending_direct.setdefault(key, []).append(item)
            elif kind == "pool":
                self._pending_pool.setdefault(key, []).append(item)
            else:
                self._pending_submits.append((kind, item))
            self._pending_count += 1
            count = self._pending_count
            if not self._flusher_started:
                self._flusher_started = True
                start_flusher = True
        if start_flusher:
            threading.Thread(target=self._send_flusher,
                             name="direct-send-flush",
                             daemon=True).start()
        if count >= 64 and not from_del:
            self._flush_direct_sends()
        else:
            # from_del: never flush inline — the interrupted frame may
            # be inside the rpc client's (non-reentrant) socket lock.
            self._flush_ev.set()

    def _flush_direct_sends(self):
        with self._flush_mutex:
            self._flush_direct_sends_locked()

    def _flush_direct_sends_locked(self):
        with self._send_lock:
            if self._pending_count == 0:
                return
            pending, self._pending_direct = self._pending_direct, {}
            pool_sends, self._pending_pool = self._pending_pool, {}
            submits, self._pending_submits = self._pending_submits, []
            self._pending_count = 0
        if submits:
            sent_upto = 0
            try:
                for end, msg in self._head_frames(submits):
                    self.client.send(msg)
                    sent_upto = end
            except Exception:
                # Head connection down mid-flush (restart window): put
                # back ONLY the unsent tail (re-queuing sent frames
                # would double-execute tasks) and arm the flusher so
                # the retry happens even if no further get()/call()
                # ever fires.
                rest = submits[sent_upto:]
                if rest:
                    with self._send_lock:
                        self._pending_submits = rest + self._pending_submits
                        self._pending_count += len(rest)
                    self._flush_ev.set()
        for address, specs in pending.items():
            try:
                conn = self._actor_conn(address)
                # Mark delivered BEFORE the send: a fast direct_result
                # reply must find the inflight entry already present
                # (resolving discards it; marking after the send could
                # re-add an already-resolved object).
                for spec in specs:
                    self._mark_direct_delivered(spec)
                if len(specs) == 1:
                    conn.send({"op": "actor_task", "spec": specs[0]})
                else:
                    conn.send({"op": "actor_task_batch", "specs": specs})
            except Exception as e:  # connection refused: actor just died
                for spec in specs:
                    self._fail_actor_task(spec, f"cannot reach actor: {e}")
        for address, specs in pool_sends.items():
            try:
                conn = self._actor_conn(address)
                if len(specs) == 1:
                    conn.send({"op": "pool_task", "spec": specs[0]})
                else:
                    conn.send({"op": "pool_task_batch", "specs": specs})
            except Exception:
                # Leased worker unreachable: the per-worker loss path
                # retries/fails each in-flight spec.
                lost = set()
                with self._lease_lock:
                    for spec in specs:
                        ent = self._lease_of_obj.get(
                            spec.return_ids[0].hex())
                        if ent is not None:
                            lost.add(ent[1])
                for whex in lost:
                    self._on_lease_worker_lost(whex, "connection lost")

    @staticmethod
    def _head_frames(items):
        """Yield (end_index, frame_msg) for queued head messages,
        preserving enqueue order: runs of consecutive submits collapse
        into submit_task_batch frames, runs of increfs into
        incref_batch frames.  When wire batching is on, adjacent
        incref/decref runs additionally collapse into ONE refcount_delta
        vector of net per-object counts — no other message can land
        between entries of one run, so netting inside it is order-safe
        (a transient +1/-1 pair can never drive a live object to zero
        mid-run on the head)."""
        merge_refs = rpc.batching_enabled()
        i, n = 0, len(items)
        while i < n:
            kind = items[i][0]
            is_ref = kind in ("incref", "decref")
            j = i
            while j < n and (items[j][0] == kind or
                             (merge_refs and is_ref and
                              items[j][0] in ("incref", "decref"))):
                j += 1
            if is_ref and merge_refs and j - i > 1:
                deltas: Dict[str, int] = {}
                for k, obj_hex in items[i:j]:
                    deltas[obj_hex] = deltas.get(obj_hex, 0) + (
                        1 if k == "incref" else -1)
                deltas = {h: d for h, d in deltas.items() if d}
                if deltas:
                    yield j, {"op": "refcount_delta", "deltas": deltas}
                # All-zero net: drop the frame entirely (re-processing
                # on a retry is harmless — the net is still zero).
                i = j
                continue
            run = [it for _, it in items[i:j]]
            if kind == "submit":
                msg = {"op": "submit_task", "spec": run[0]} \
                    if len(run) == 1 else \
                    {"op": "submit_task_batch", "specs": run}
            elif kind == "task_event":
                # Delta-compress the run: multiple lifecycle events for
                # one task inside a flush window (RECEIVED+RUNNING+
                # FINISHED of a fast task) merge into one dict — later
                # events overlay earlier keys, first-seen order kept.
                merged: Dict[str, dict] = {}
                order: List[str] = []
                for ev in run:
                    tid = ev.get("task_id", "")
                    cur = merged.get(tid)
                    if cur is None:
                        merged[tid] = dict(ev)
                        order.append(tid)
                    else:
                        cur.update(ev)
                msg = {"op": "task_events",
                       "events": [merged[t] for t in order]}
            elif kind == "profile_report":
                # Resource samples are point-in-time state, not deltas:
                # a backlogged run collapses to the NEWEST sample (one
                # flusher per worker, so within-run order is sample
                # order and latest wins).
                msg = {"op": "profile_report", "sample": run[-1]}
            elif kind == "put":
                msg = run[0] if len(run) == 1 else \
                    {"op": "put_object_batch", "items": run}
            elif kind == "incref":
                msg = {"op": "incref", "obj": run[0]} \
                    if len(run) == 1 else \
                    {"op": "incref_batch", "objs": run}
            else:  # decref (ref deletions ride the same ordered queue)
                msg = {"op": "decref", "obj": run[0]} \
                    if len(run) == 1 else \
                    {"op": "decref_batch", "objs": run}
            yield j, msg
            i = j

    def _flush_actor_queue(self, actor_hex: str, address: str):
        with self._actor_cv:
            queue = self._actor_queues.get(actor_hex, [])
            self._actor_queues[actor_hex] = []
        for spec in queue:
            self._send_actor_task(actor_hex, address, spec)

    def _fail_actor_queue(self, actor_hex: str, reason: str):
        with self._actor_cv:
            queue = self._actor_queues.pop(actor_hex, [])
        for spec in queue:
            self._fail_actor_task(spec, reason)

    def _fail_actor_task(self, spec: TaskSpec, reason: str):
        err = ActorDiedError(spec.actor_id, reason)
        if getattr(spec, "is_streaming", False):
            # Streams have no pre-registered returns: fail the
            # end-of-stream object so iteration raises.
            from ray_tpu_torch.core.streaming import stream_eos_id

            self._store_value(stream_eos_id(spec.task_id), err,
                              is_error=True)
            return
        if getattr(spec, "direct", False):
            for oid in spec.return_ids:
                self._fail_direct(oid.hex(), err)
            return
        for oid in spec.return_ids:
            self._store_value(oid, err, is_error=True)

    def kill_actor(self, actor_hex: str, no_restart: bool = True):
        self._flush_direct_sends()  # queued calls precede the kill
        self.client.send({"op": "kill_actor", "actor": actor_hex,
                          "no_restart": no_restart})

    def get_named_actor(self, name: str, namespace: str = "") -> Optional[dict]:
        return self.client.call({"op": "get_named_actor", "name": name,
                                 "namespace": namespace})

    # ------------------------------------------------------------------
    def close(self):
        try:
            self._flush_direct_sends()
        except Exception:
            pass
        try:
            self._release_all_leases()
        except Exception:
            pass
        self._closed = True
        # Wake the send flusher so it observes _closed and exits — a
        # flusher parked in wait() forever leaked one thread per
        # init/shutdown cycle (hundreds across a long test session).
        self._flush_ev.set()
        try:
            from ray_tpu_torch.util import metrics

            metrics.unpublish(self.client.call, self.worker_hex)
        except Exception:
            pass
        for conn in self._actor_conns.values():
            conn.close()
        for conn in self._node_conns.values():
            conn.close()
        self.client.close()


def func_content_id(blob: bytes) -> str:
    return hashlib.sha1(blob).hexdigest()
