"""Worker process: task executor + actor host.

Counterpart of the reference's default_worker.py + the executor half of
CoreWorker (ExecuteTask, core_worker.cc:2906) and the executor-side actor
scheduling queues (transport/actor_scheduling_queue.cc).  Each worker runs:

  - a CoreClient connected to the control server (receives execute_task /
    create_actor_instance pushes),
  - its own rpc.Server so callers submit actor tasks DIRECTLY to this
    process (the reference's peer-to-peer actor transport — GCS is not on
    the actor hot path),
  - an executor: single-slot for pool tasks, FIFO queue (or thread pool for
    max_concurrency > 1) for actor methods.
"""

from __future__ import annotations

import contextvars
import inspect
import os
import queue
import sys
import threading
import time
import traceback
from typing import Any, List, Optional

import cloudpickle

from ray_tpu_torch.core import rpc, serialization
from ray_tpu_torch.core.exceptions import TaskError
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core import runtime as _runtime
from ray_tpu_torch.core.node_manager import is_cpu_class
from ray_tpu_torch.core.runtime import CoreClient, set_runtime
from ray_tpu_torch.core.task_spec import ActorCreationSpec, KwargsMarker, TaskSpec

# Current task for async actor method bodies: coroutines interleave on
# ONE loop thread, so thread-locals can't carry identity — contextvars
# follow each asyncio task (runtime_context.py reads this).
_current_spec_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_current_task_spec", default=None)

# Cached lazy import (ray_tpu_torch.util eagerly pulls in the runtime; core
# modules import util lazily to stay cycle-free).
_tracing = None


def _get_tracing():
    global _tracing
    if _tracing is None:
        from ray_tpu_torch.util import tracing

        _tracing = tracing
    return _tracing


def _compiled_dag_not_ported(*_args, **_kwargs):
    raise NotImplementedError(
        "compiled DAGs (dag/) are not ported yet: ROADMAP Queue A item 7")


class WorkerRuntime:
    """The runtime facade inside a worker process (get/put/submit all work,
    so tasks can launch nested tasks and hold actor handles)."""

    def __init__(self, control_addr: str, worker_hex: str, kind: str,
                 env_key: str):
        self.namespace = os.environ.get("RAY_TPU_NAMESPACE", "")
        self._exit_ev = threading.Event()
        from ray_tpu_torch.core.config import get_config

        cfg = get_config()
        self.server = rpc.Server(self._handle_direct,
                                 host=cfg.node_ip_address)
        # Advertised (not bind) address: actor callers on other hosts
        # dial this.
        self.advertised_address = (f"{cfg.advertised_host()}:"
                                   f"{self.server.port}")
        self.core = CoreClient(
            control_addr, worker_hex, kind=kind,
            address=self.advertised_address, env_key=env_key)
        self.core.on_execute_task = self._on_execute_task
        self.core.on_create_actor = self._on_create_actor
        self.core.on_exit = self._on_exit
        self.core.on_reconnect = self._on_reconnect
        self._func_cache: dict[str, Any] = {}
        self._actor_instance: Any = None
        self._actor_is_async = False
        self._actor_hex: str = ""
        self._gpu_class = not is_cpu_class(env_key)
        # The profile runner of the one thread that runs this worker's
        # tasks, where it names one (_name_device_thread).
        self._device_runner: Optional[_runtime.ThreadRunner] = None
        self._task_queue: "queue.Queue[TaskSpec]" = queue.Queue()
        self._cancelled_pool: set = set()  # task hexes cancelled while queued
        self._exec_pool: Optional[Any] = None
        self._aio_lock = threading.Lock()
        # Direct-result coalescing (see _push_direct_result).
        self._res_lock = threading.Lock()
        self._res_buf: dict = {}
        self._res_flush_ev = threading.Event()
        threading.Thread(target=self._result_flusher,
                         name="direct-result-flush", daemon=True).start()
        # Per-thread currently-executing spec (runtime_context.py).
        self._cur_tls = threading.local()
        self.is_initialized = True
        set_runtime(self)
        # Apply this pool's runtime env (the port's: env_vars only, as
        # submission checked — runtime.check_runtime_env) BEFORE
        # reporting online so the first task already sees the prepared
        # environment; a failed setup kills the worker with the error in
        # its .err log (reference: runtime-env agent failure fails the
        # lease).
        renv = self.core.client.call({"op": "get_runtime_env",
                                      "env_key": env_key})
        if renv:
            from ray_tpu_torch.core.runtime import check_runtime_env

            try:
                check_runtime_env(renv)
                os.environ.update({str(k): str(v) for k, v in
                                   (renv.get("env_vars") or {}).items()})
            except Exception as e:  # noqa: BLE001
                import traceback

                traceback.print_exc()
                # Poison the env server-side so pending/future tasks fail
                # fast instead of respawning this doomed pool forever.
                try:
                    self.core.client.call({
                        "op": "worker_setup_failed", "env_key": env_key,
                        "error": f"{type(e).__name__}: {e}"})
                finally:
                    os._exit(1)
        self.core.client.send({"op": "worker_online"})
        # Low-frequency resource sampler: CPU %, RSS, arena usage and
        # queue depths, shipped as profile_report deltas on the
        # coalescing flusher (runtime._head_frames keeps only the
        # newest sample of a backlogged run).  Head-retunable via the
        # profile_config push; RAY_TPU_PROFILE_SAMPLER=0 disables.
        threading.Thread(target=self._profile_sampler_loop,
                         name="profile-sampler", daemon=True).start()

    # -- per-worker resource profiling ---------------------------------
    def _profile_sampler_loop(self):
        from ray_tpu_torch.core.memory_monitor import system_memory

        cfg = self.core.profile_config
        cfg.setdefault("enabled", os.environ.get(
            "RAY_TPU_PROFILE_SAMPLER", "1").strip().lower()
            not in ("0", "false", "no", "off"))
        try:
            interval = float(os.environ.get(
                "RAY_TPU_PROFILE_SAMPLE_INTERVAL_S", "5"))
        except ValueError:
            interval = 5.0
        cfg.setdefault("interval_s", max(0.05, interval))
        ev = self.core.profile_config_ev
        try:
            ticks = os.sysconf("SC_CLK_TCK") or 100
            page = os.sysconf("SC_PAGE_SIZE") or 4096
        except (ValueError, OSError, AttributeError):
            ticks, page = 100, 4096
        last_cpu_s = last_t = None
        while not self._exit_ev.is_set():
            ev.wait(timeout=float(cfg.get("interval_s", 5.0)))
            ev.clear()
            if self._exit_ev.is_set():
                return
            if not cfg.get("enabled", True):
                last_cpu_s = last_t = None  # stale CPU deltas on resume
                continue
            try:
                sample, last_cpu_s, last_t = self._profile_sample(
                    ticks, page, system_memory, last_cpu_s, last_t)
                self.core._queue_for_flush("profile_report", None, sample)
            except Exception:
                pass  # sampling must never hurt the worker

    def _profile_sample(self, ticks, page, system_memory,
                        last_cpu_s, last_t):
        now = time.monotonic()
        cpu_s = 0.0
        rss = 0
        try:
            with open("/proc/self/stat") as f:
                # utime/stime are fields 14/15; split after the ")" that
                # closes comm (which may itself contain spaces).
                parts = f.read().rsplit(")", 1)[1].split()
            cpu_s = (int(parts[11]) + int(parts[12])) / ticks
        except (OSError, ValueError, IndexError):
            pass
        try:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * page
        except (OSError, ValueError, IndexError):
            pass
        cpu_pct = 0.0
        if last_t is not None and now > last_t:
            cpu_pct = max(
                0.0, 100.0 * (cpu_s - last_cpu_s) / (now - last_t))
        cap, used, nobj, _evicted = self.core.store.stats()
        avail, total = system_memory()
        pool_q = getattr(self, "_pool_queue", None)
        sample = {
            "ts": time.time(), "pid": os.getpid(),
            "worker": self.core.worker_hex,
            "cpu_percent": round(cpu_pct, 2),
            "rss_bytes": rss,
            "mem_available_bytes": avail,
            "mem_total_bytes": total,
            "arena_used_bytes": used,
            "arena_capacity_bytes": cap,
            "arena_objects": nobj,
            "queue_depth": self._task_queue.qsize() + (
                pool_q.qsize() if pool_q is not None else 0),
        }
        # Device-plane piggyback: "device" is None on hosts without an
        # accelerator (JAX_PLATFORMS=cpu emits device: null — the probe
        # never raises and never imports jax itself); recompile counts
        # and the last roofline/MFU window ride along when the process
        # produced them, so the head's history rings grow percentiles
        # for them for free.
        from ray_tpu_torch.util import device_stats

        device_stats.attribute("arena", used)
        sample.update(device_stats.profile_fields())
        return sample, cpu_s, now

    # -- runtime facade (same surface the driver runtime exposes) -------
    def get(self, refs, timeout=None):
        return self.core.get(refs, timeout)

    def put(self, value):
        return self.core.put(value)

    def wait(self, refs, num_returns=1, timeout=None):
        return self.core.wait(refs, num_returns, timeout)

    def submit_task(self, *a, **kw):
        return self.core.submit_task(*a, **kw)

    def create_actor(self, *a, **kw):
        if not kw.get("namespace"):
            kw["namespace"] = self.namespace
        return self.core.create_actor(*a, **kw)

    def submit_actor_task(self, *a, **kw):
        return self.core.submit_actor_task(*a, **kw)

    def kill_actor(self, *a, **kw):
        return self.core.kill_actor(*a, **kw)

    def get_named_actor(self, name: str, namespace: str = ""):
        return self.core.get_named_actor(name, namespace or self.namespace)

    def subscribe_actor(self, *a, **kw):
        return self.core.subscribe_actor(*a, **kw)

    def wait_actor_alive(self, *a, **kw):
        return self.core.wait_actor_alive(*a, **kw)

    def on_ref_deleted(self, object_id: ObjectID):
        self.core.on_ref_deleted(object_id)

    def _local_nm(self):
        """Connection to this node's manager, if any (N8 resource-view
        sync: resource queries answer from the manager's synced view
        without a head round trip)."""
        addr = os.environ.get("RAY_TPU_LOCAL_NM", "")
        if not addr:
            return None
        conn = getattr(self, "_nm_conn", None)
        if conn is not None and not conn._closed:
            return conn
        try:
            conn = rpc.Client(addr, connect_timeout=2.0)
        except Exception:
            return None
        self._nm_conn = conn
        return conn

    def cluster_resources(self):
        nm = self._local_nm()
        if nm is not None:
            try:
                out = nm.call({"op": "cluster_resources"}, timeout=5.0)
                if out:
                    return out
            except Exception:
                pass
        return self.core.client.call({"op": "cluster_resources"})

    def available_resources(self):
        nm = self._local_nm()
        if nm is not None:
            try:
                out = nm.call({"op": "available_resources"}, timeout=5.0)
                if out:
                    return out
            except Exception:
                pass
        return self.core.client.call({"op": "available_resources"})

    def state_list(self, kind: str):
        return self.core.client.call({"op": f"list_{kind}"})

    def as_future(self, ref: ObjectRef):
        import concurrent.futures

        out: concurrent.futures.Future = concurrent.futures.Future()
        inner = self.core.object_future(ref.hex())

        def _chain(f):
            try:
                out.set_result(self.core._load_object(ref.hex(), f.result()))
            except BaseException as e:  # noqa: BLE001
                out.set_exception(e)

        inner.add_done_callback(_chain)
        return out

    def kv(self):
        return self.core.client

    # -- direct server (actor task submission path) ---------------------
    def _handle_direct(self, conn, msg):
        op = msg.get("op")
        if op == "actor_task":
            spec = msg["spec"]
            # Owner-direct path: remember which connection the call came
            # in on so the result can be pushed straight back to the
            # submitter (no head involvement) — see _store_returns.
            spec._arrival_conn = conn
            self._task_queue.put(spec)
            return None
        if op == "actor_task_batch":
            for spec in msg["specs"]:
                spec._arrival_conn = conn
                self._task_queue.put(spec)
            return None
        if op == "pool_task":
            # Owner-direct leased task (reference PushNormalTask,
            # direct_task_transport.cc:601): executes on the pool lane;
            # the result rides this connection back.
            spec = msg["spec"]
            spec._arrival_conn = conn
            self._on_execute_task(spec)
            return None
        if op == "pool_task_batch":
            for spec in msg["specs"]:
                spec._arrival_conn = conn
                self._on_execute_task(spec)
            return None
        if op == "cancel_pool_task":
            # Owner-initiated cancel of a dispatched-but-not-started
            # task (reference normal_scheduling_queue CancelTaskIfFound):
            # cancellable only while it still sits in the pool queue.
            task_hex = msg.get("task")
            q = getattr(self, "_pool_queue", None)
            if q is not None:
                # The add must happen under q.mutex: the executor's pop
                # also takes it, so in-queue-while-marked guarantees the
                # drain check sees the hex (no started-anyway race).
                with q.mutex:
                    found = any(
                        s.task_id is not None
                        and s.task_id.hex() == task_hex for s in q.queue)
                    if found:
                        self._cancelled_pool.add(task_hex)
                if found:
                    return {"cancelled": True}
            return {"cancelled": False}
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown direct op {op}")

    # -- execution ------------------------------------------------------
    def _resolve_fn(self, spec: TaskSpec):
        func_id = spec.func_id
        fn = self._func_cache.get(func_id)
        if fn is None:
            blob = spec.func_blob or self.core.fetch_func(func_id)
            if blob is None:
                # The owner's put_func is a one-way send racing the
                # owner-direct task spec (which travels straight to this
                # worker): the blob may still be in flight to the GCS.
                # Brief bounded retry before declaring it missing.
                deadline = time.monotonic() + 5.0
                while blob is None and time.monotonic() < deadline:
                    time.sleep(0.05)
                    blob = self.core.fetch_func(func_id)
            if blob is None:
                raise RuntimeError(f"function {func_id} not found in GCS")
            fn = cloudpickle.loads(blob)
            self._func_cache[func_id] = fn
        return fn

    def _resolve_call(self, spec: TaskSpec):
        """(args, kwargs) for a task spec — the shared preamble of every
        execution path (kwargs ride as a trailing marker arg)."""
        args = self._resolve_args(spec)
        kwargs = {}
        if args and isinstance(args[-1], KwargsMarker):
            kwargs = args.pop().kwargs
        return args, kwargs

    def _resolve_args(self, spec: TaskSpec) -> List[Any]:
        args = []
        for a in spec.args:
            if a.is_ref:
                # Balance this temp ref's __del__ decref with an explicit
                # incref: without it, concurrent tasks borrowing the same
                # arg drove the owner's count negative and the object was
                # freed under other tasks still resolving it.  Rides the
                # coalescing queue (one frame per burst, not per arg);
                # get() below flushes pending sends before subscribing,
                # so the incref still reaches the head first.
                self.core._queue_for_flush("incref", None, a.object_hex)
                ref = ObjectRef(ObjectID.from_hex(a.object_hex))
                args.append(self.core.get([ref])[0])
            else:
                args.append(serialization.deserialize(
                    a.data, ref_deserializer=self.core._on_ref_deser))
        return args

    def _store_error(self, spec: TaskSpec, err: TaskError):
        """Best-effort error store; must not raise (an unstorable error would
        otherwise leave return objects PENDING and the worker wedged)."""
        for oid in spec.return_ids:
            try:
                self.core._store_value(oid, err, is_error=True)
            except BaseException:  # noqa: BLE001  e.g. unpicklable cause
                fallback = TaskError(
                    spec.name or spec.method_name, None,
                    tb=err.traceback_str or str(err))
                fallback.cause = None
                self.core._store_value(oid, fallback, is_error=True)

    def _store_streaming_returns(self, spec: TaskSpec, value: Any,
                                 failed: bool):
        """Drain a generator task: each yield becomes its own object at
        a derived id; the end-of-stream object records the item count
        (core/streaming.py). A mid-stream exception lands in the next
        item slot so iteration surfaces it on get()."""
        from ray_tpu_torch.core.streaming import stream_eos_id, stream_item_id

        count = 0
        if failed:
            self.core._store_value(
                stream_item_id(spec.task_id, 0), value, is_error=True)
            count = 1
        else:
            try:
                for item in value:
                    self.core._store_value(
                        stream_item_id(spec.task_id, count), item)
                    # Streamed items must flow LIVE: puts normally ride
                    # the coalescing queue, but a consumer is already
                    # waiting on this item — and a crash between yields
                    # (or user code calling os._exit) must not lose an
                    # item the generator already produced.  The wire
                    # fence matters for the same reason: bytes buffered
                    # in the rpc sender die with the process too.
                    self.core._flush_direct_sends()
                    self.core.client.flush_sends()
                    count += 1
            except BaseException as e:  # noqa: BLE001
                err = TaskError(spec.name or spec.method_name, e)
                self.core._store_value(
                    stream_item_id(spec.task_id, count), err,
                    is_error=True)
                count += 1
        self.core._store_value(stream_eos_id(spec.task_id), count)
        self.core._flush_direct_sends()
        self.core.client.flush_sends()

    def _store_returns(self, spec: TaskSpec, value: Any, failed: bool):
        if spec.is_streaming:
            self._store_streaming_returns(spec, value, failed)
            return
        if getattr(spec, "direct", False) and \
                self._store_direct_return(spec, value, failed):
            return
        if failed:
            self._store_error(spec, value)
            return
        if spec.num_returns == 1:
            values = [value]
        else:
            try:
                values = list(value)
            except TypeError as e:
                self._store_error(spec, TaskError(spec.name, e))
                return
            if len(values) != spec.num_returns:
                self._store_error(spec, TaskError(
                    spec.name,
                    ValueError(
                        f"task declared {spec.num_returns} returns, got "
                        f"{len(values)}")))
                return
        for oid, v in zip(spec.return_ids, values):
            try:
                self.core._store_value(oid, v)
            except BaseException as e:  # noqa: BLE001 serialization failure
                self._store_error(spec, TaskError(spec.name, e))

    def _store_direct_return(self, spec: TaskSpec, value: Any,
                             failed: bool) -> bool:
        """Push an owner-direct actor result back over the connection the
        task arrived on (reference: direct actor transport replies
        peer-to-peer; the GCS never sees the call).  Returns False to
        fall back to the head path (no arrival conn, e.g. a queued spec
        replayed through an exotic route).  Oversized results go to the
        head store and the owner gets a 'see head' marker instead."""
        conn = getattr(spec, "_arrival_conn", None)
        if conn is None or not spec.return_ids:
            return False
        obj_hex = spec.return_ids[0].hex()
        try:
            ser = self.core._serialize_for_ship(value)
        except BaseException as e:  # noqa: BLE001 unpicklable result
            err = TaskError(spec.name or spec.method_name, e) \
                if not failed else value
            try:
                ser = self.core._serialize_for_ship(err)
            except BaseException:
                fallback = TaskError(
                    spec.name or spec.method_name, None,
                    tb=getattr(err, "traceback_str", None) or str(err))
                fallback.cause = None
                ser = self.core._serialize_for_ship(fallback)
            failed = True
        size = ser.total_bytes
        if size > self.core.config.max_direct_result_bytes:
            # Large result: store via head (shm) and point the owner at
            # it.  For lease-path pool tasks, ship the producing spec as
            # lineage so the head can re-execute on copy loss (the spec
            # never transited the head on submit).
            self.core._store_serialized(
                spec.return_ids[0], ser, is_error=failed,
                lineage_spec=spec if spec.actor_id is None else None)
            # The put rides the coalescing queue; the owner reacts to the
            # push below INSTANTLY (subscribe, or a fire-and-forget
            # __del__ decref) — the head must learn of the object first
            # or that decref lands on nothing and the entry leaks.  The
            # wire fence makes the cross-connection ordering hold under
            # rpc coalescing too (the push travels a different socket).
            self.core._flush_direct_sends()
            self.core.client.flush_sends()
            try:
                conn.push({"op": "direct_result_remote", "obj": obj_hex})
            except Exception:
                pass  # owner gone; the head copy ages out via refcount
            return True
        self._push_direct_result(conn, obj_hex, ser.to_bytes(), failed)
        return True

    def _push_direct_result(self, conn, obj_hex: str, data: bytes,
                            is_error: bool):
        """Coalesce back-to-back results into one direct_result_batch
        push: with more calls already queued, buffer; the buffer flushes
        when the queue drains, at 64 results, or after 1 ms (flusher
        thread) — whichever first.  A lone result pushes immediately, so
        sync callers see no added latency."""
        pool_q = getattr(self, "_pool_queue", None)
        queued = not self._task_queue.empty() or (
            pool_q is not None and not pool_q.empty())
        with self._res_lock:
            buffered = self._res_buf.get(id(conn))
            if buffered is None and not queued:
                buffered = False  # immediate path
            else:
                if buffered is None:
                    buffered = self._res_buf[id(conn)] = (conn, [])
                buffered[1].append((obj_hex, data, is_error))
                n = len(buffered[1])
        if buffered is False:
            try:
                conn.push({"op": "direct_result", "obj": obj_hex,
                           "data": data, "is_error": is_error})
            except Exception:
                pass  # owner disconnected: nobody is waiting
            return
        if n >= 64 or not queued:
            self._flush_direct_results()
        else:
            self._res_flush_ev.set()

    def _flush_direct_results(self):
        with self._res_lock:
            if not self._res_buf:
                return
            bufs, self._res_buf = self._res_buf, {}
        for conn, results in bufs.values():
            try:
                if len(results) == 1:
                    obj_hex, data, is_error = results[0]
                    conn.push({"op": "direct_result", "obj": obj_hex,
                               "data": data, "is_error": is_error})
                else:
                    conn.push({"op": "direct_result_batch",
                               "results": results})
            except Exception:
                pass  # owner disconnected

    def _result_flusher(self):
        """Bounds the buffering delay: a burst followed by a slow task
        must not park finished results behind it."""
        while not self._exit_ev.is_set():
            self._res_flush_ev.wait()
            self._res_flush_ev.clear()
            time.sleep(0.001)
            self._flush_direct_results()

    def _finish(self, spec: TaskSpec, failed: bool,
                puts: Optional[List[dict]] = None):
        if spec.actor_id is None:
            if getattr(spec, "direct", False) and \
                    getattr(spec, "_arrival_conn", None) is not None:
                # Leased task (owner-direct): no head slot to return —
                # the lease holds the resources until the owner releases
                # it.  Only the borrow decrefs (coalesced) and a batched
                # task event for observability go to the head
                # (reference: TaskEventBuffer flushes execution events
                # off the hot path, task_event_buffer.h:206).
                for obj_hex in spec.borrows:
                    self.core._queue_for_flush("decref", None, obj_hex)
                self._buffer_task_event(spec, failed)
                if getattr(self, "_announce_pending", False):
                    # Deferred post-head-restart announce (see
                    # _on_reconnect): without it this worker would stay
                    # 'starting' on the restarted head forever.
                    pool_q = getattr(self, "_pool_queue", None)
                    if pool_q is None or pool_q.empty():
                        self._announce_pending = False
                        try:
                            self.core.client.send({"op": "worker_online"})
                        except Exception:
                            pass
                return
            # One combined control message: result puts + borrow decrefs
            # + completion (was 1 put per return + 1 decref per borrow +
            # 1 done = the control plane's hottest path).
            msg = {
                "op": "task_done", "task_id": spec.task_id.hex(),
                "failed": failed, "puts": puts or [],
                "decrefs": list(spec.borrows)}
            tr = getattr(spec, "_trace", None)
            if tr is not None:
                msg["trace"] = tr
            self.core.client.send(msg)
            self._announce_pending = False  # task_done re-binds state
        else:
            # Actor-method borrows: ride the coalescing queue so a burst
            # of completions releases refs in delta vectors, not one
            # frame per borrowed arg.
            for obj_hex in spec.borrows:
                self.core._queue_for_flush("decref", None, obj_hex)

    def _buffer_task_event(self, spec: TaskSpec, failed: bool,
                           state: str = ""):
        """Queue a compact task-lifecycle delta; it rides the core
        client's coalescing flusher (runtime.py _queue_for_flush /
        _head_frames), where a run of events collapses into one
        task_events frame and same-task deltas within a flush window
        merge — so the state API / timeline / OOM victim policy still
        see lease-path tasks the head never scheduled, at far fewer
        frames than tasks (reference GcsTaskManager events +
        TaskEventBuffer, task_event_buffer.h:206)."""
        state = state or ("FAILED" if failed else "FINISHED")
        ev = {
            "task_id": spec.task_id.hex(),
            "name": spec.name or spec.func_id[:8],
            "owner": spec.owner,
            "state": state,
            "retries_left": max(0, spec.max_retries - spec.retry_count),
            "retry_count": spec.retry_count,
        }
        received = getattr(spec, "_received_at", 0.0)
        if received:
            ev["received"] = received
        if state != "RECEIVED":
            ev["start"] = getattr(spec, "_exec_started", 0.0)
            if state != "RUNNING":
                ev["end"] = time.time()
                if ev["start"]:
                    ev["duration"] = ev["end"] - ev["start"]
        tr = getattr(spec, "_trace", None)
        if tr is not None:
            # One compact key, not trace_id/span_id/parent_span_id: the
            # key names alone would add ~40 bytes to every event frame.
            ev["trace"] = tr
        self.core._queue_for_flush("task_event", None, ev)

    def _execute(self, spec: TaskSpec, target_fn=None):
        failed = False
        self._executing = True
        self._cur_tls.spec = spec
        spec._exec_started = time.time()
        # Restore the submitter's trace context (util/tracing.py): the
        # execution span parents everything this task does — nested
        # submissions carry ITS span id, stitching the driver→worker→
        # nested-task chain under one trace_id.
        _ttok = _span_id = None
        tctx = getattr(spec, "trace_ctx", None)
        if tctx:
            _ttok, _span_id = _get_tracing().begin_task_span(tctx)
            spec._trace = (tctx[0], _span_id, tctx[1])
        if spec.actor_id is None and getattr(spec, "direct", False) and \
                getattr(spec, "_arrival_conn", None) is not None:
            # Leased task: tell the head it is RUNNING here (batched) so
            # the state API and the OOM victim policy see it.
            self._buffer_task_event(spec, failed=False, state="RUNNING")
        # Pool (non-actor, non-streaming) tasks batch their result puts
        # into the task_done message; streaming items must flow live.
        # Leased (owner-direct) tasks send no task_done at all, so their
        # (rare, oversized-result) puts must flow immediately.
        batch_puts = (spec.actor_id is None and not spec.is_streaming
                      and not (getattr(spec, "direct", False)
                               and getattr(spec, "_arrival_conn", None)
                               is not None))
        try:
            args, kwargs = self._resolve_call(spec)
            fn = target_fn if target_fn is not None else self._resolve_fn(spec)
            value = fn(*args, **kwargs)
            if inspect.iscoroutine(value):
                # Async actor method (reference: asyncio actors run via
                # fibers, transport/fiber.h): await it on the actor's
                # event loop. Each exec thread blocks on ITS call while
                # the loop overlaps awaits across threads, so
                # max_concurrency requests make progress concurrently.
                import asyncio

                value = asyncio.run_coroutine_threadsafe(
                    value, self._actor_event_loop()).result()
        except BaseException as e:  # noqa: BLE001
            failed = True
            value = TaskError(spec.name or spec.method_name, e)
            traceback.print_exc()
        puts: Optional[List[dict]] = None
        try:
            if batch_puts:
                self.core.begin_put_batch()
            self._store_returns(spec, value, failed)
        except BaseException:  # noqa: BLE001
            failed = True
            traceback.print_exc()
        finally:
            if batch_puts:
                puts = self.core.take_put_batch()
            self._cur_tls.spec = None
            self._executing = False
            # Always release resources/borrows, even if storing returns
            # blew up — a wedged-busy worker starves the whole pool.
            self._finish(spec, failed, puts)
            if _ttok is not None:
                _get_tracing().end_task_span(
                    _ttok,
                    f"task:{spec.name or spec.method_name or spec.func_id[:8]}",
                    spec._exec_started, time.time(), tctx, _span_id)
        return failed

    @property
    def _current_task_spec(self):
        ctx_spec = _current_spec_ctx.get()
        if ctx_spec is not None:
            return ctx_spec
        return getattr(self._cur_tls, "spec", None)

    def _on_execute_task(self, spec: TaskSpec):
        # pool tasks: one at a time on a PERSISTENT executor thread (a
        # thread spawn per task costs ~100 us — the dominant per-task
        # overhead at small-task rates); the rpc receive thread stays
        # responsive because it only enqueues.
        spec._received_at = time.time()
        if getattr(spec, "direct", False) and \
                getattr(spec, "_arrival_conn", None) is not None:
            # Lease-path task: the head never saw the submission, so
            # the arrival delta is its first sighting (it merges with
            # RUNNING/FINISHED if the task drains fast).
            self._buffer_task_event(spec, failed=False, state="RECEIVED")
        q = getattr(self, "_pool_queue", None)
        if q is None:
            with self._aio_lock:
                q = getattr(self, "_pool_queue", None)
                if q is None:
                    q = queue.Queue()
                    self._name_device_thread()
                    threading.Thread(target=self._pool_exec_loop,
                                     args=(q,), name="task-exec",
                                     daemon=True).start()
                    self._pool_queue = q
        q.put(spec)

    def _name_device_thread(self):
        """On a GPU-class worker, name the one thread that runs its tasks
        (the task loop, or the actor loop of a max_concurrency=1 actor
        without concurrency groups or async methods) as the profile
        runner, unless the actor named a thread of its own: torch_trace
        then starts and stops its session there, between two tasks
        (core/runtime.py _torch_trace)."""
        if not self._gpu_class:
            return
        runner = _runtime.ThreadRunner()
        if _runtime.default_profile_runner(runner):
            self._device_runner = runner

    def _run_device_calls(self):
        if self._device_runner is not None:
            self._device_runner.run_pending()

    def _pool_exec_loop(self, q: "queue.Queue[TaskSpec]"):
        while not self._exit_ev.is_set():
            self._run_device_calls()
            try:
                spec = q.get(timeout=0.2)
            except queue.Empty:
                continue
            th = spec.task_id.hex() if spec.task_id is not None else None
            if th is not None and th in self._cancelled_pool:
                # Owner cancelled it while queued: release borrows and
                # report the terminal event, never run the body.  The
                # owner already failed its future with
                # TaskCancelledError (cancel_ref).
                self._cancelled_pool.discard(th)
                self._finish(spec, failed=True)
                continue
            self._execute(spec)

    # -- actor hosting --------------------------------------------------
    def _on_create_actor(self, spec: ActorCreationSpec):
        threading.Thread(
            target=self._create_actor_instance, args=(spec,),
            name="actor-init", daemon=True).start()

    def _create_actor_instance(self, spec: ActorCreationSpec):
        try:
            blob = spec.class_blob or self.core.fetch_func(spec.class_id)
            cls = cloudpickle.loads(blob)
            fake_task = TaskSpec(
                task_id=None, func_id="", func_blob=None, args=spec.args,
                num_returns=0, return_ids=[], resources={},
                borrows=[])
            args, kwargs = self._resolve_call(fake_task)
            self._actor_instance = cls(*args, **kwargs)
            self._actor_hex = spec.actor_id.hex()
            # Async actors serialize ALL method bodies on one event loop
            # (see _actor_loop); detected once here.
            self._actor_is_async = any(
                inspect.iscoroutinefunction(m)
                for _, m in inspect.getmembers(
                    type(self._actor_instance),
                    predicate=inspect.isfunction))
            # Named concurrency groups: one bounded executor pool per
            # group (reference concurrency_group_manager.cc); methods
            # annotated @ray_tpu_torch.method(concurrency_group=...) run
            # there, overlapping with the default lane while staying
            # FIFO within their group.
            groups = getattr(spec, "concurrency_groups", None) or {}
            if groups:
                from concurrent.futures import ThreadPoolExecutor

                self._group_pools = {
                    gname: ThreadPoolExecutor(
                        max_workers=max(1, int(size)),
                        thread_name_prefix=f"actor-cg-{gname}")
                    for gname, size in groups.items()}
                # With groups on, the queue thread is a pure
                # dispatcher: un-grouped methods run on a default pool
                # (size max_concurrency) so a long default-lane call
                # never blocks dispatch into the other lanes.
                self._group_pools["_default"] = ThreadPoolExecutor(
                    max_workers=max(1, spec.max_concurrency),
                    thread_name_prefix="actor-cg-default")
            # With groups, exactly ONE dispatcher thread feeds the pools
            # (multiple dispatchers would race task_queue.get -> submit
            # and break FIFO within a group); concurrency comes from the
            # pools themselves.  Without groups, the queue threads ARE
            # the executors.
            n = 1 if groups else max(1, spec.max_concurrency)
            if not groups and n == 1 and not self._actor_is_async:
                self._name_device_thread()
            for _ in range(n):
                threading.Thread(target=self._actor_loop, name="actor-exec",
                                 daemon=True).start()
            self.core.client.send({
                "op": "actor_ready", "actor": spec.actor_id.hex(),
                "address": self.advertised_address})
        except BaseException as e:  # noqa: BLE001
            traceback.print_exc()
            self.core.client.send({
                "op": "actor_creation_failed", "actor": spec.actor_id.hex(),
                "reason": "".join(traceback.format_exception(e))[-2000:]})

    def _actor_loop(self):
        while not self._exit_ev.is_set():
            self._run_device_calls()
            try:
                spec = self._task_queue.get(timeout=0.2)
            except queue.Empty:
                continue
            method_name = spec.method_name
            if method_name == "__ray_terminate__":
                self._store_returns(spec, None, failed=False)
                self._on_exit()
                return
            if method_name == "__ray_tpu_compiled_loop__":
                # The reference runs a compiled DAG's resident stage loop
                # here (dag/compiled_dag.py); the caller gets the error.
                self._execute(spec, target_fn=_compiled_dag_not_ported)
                continue
            try:
                method = getattr(self._actor_instance, method_name)
            except AttributeError as e:
                self._store_returns(
                    spec, TaskError(method_name, e), failed=True)
                self._finish(spec, failed=True)
                continue
            if self._actor_is_async:
                # Async actor: EVERY method body runs on the actor's
                # event loop (sync ones wrapped in a trivial coroutine),
                # so no two bodies ever run in parallel — the reference's
                # asyncio-actor serialization — while awaits overlap.
                # The queue thread moves on immediately; no parked OS
                # thread per in-flight call.
                self._execute_async_actor_task(spec, method)
            else:
                pools = getattr(self, "_group_pools", None)
                if pools:
                    group = getattr(method, "__concurrency_group__", None)
                    if group is not None and group not in pools:
                        # An undeclared group silently landing in the
                        # default lane would quietly drop the isolation
                        # the caller asked for — fail the call instead.
                        self._store_returns(
                            spec, TaskError(method_name, ValueError(
                                f"method {method_name!r} names "
                                f"concurrency group {group!r}, which "
                                "this actor does not declare")),
                            failed=True)
                        self._finish(spec, failed=True)
                        continue
                    pool = pools.get(group) or pools["_default"]
                    # Grouped dispatch: lanes overlap; FIFO within a
                    # lane; the single dispatcher thread moves on.
                    pool.submit(self._execute, spec, method)
                else:
                    self._execute(spec, target_fn=method)

    def _execute_async_actor_task(self, spec: TaskSpec, method):
        import asyncio

        try:
            args, kwargs = self._resolve_call(spec)

            async def _body():
                _current_spec_ctx.set(spec)
                tctx = getattr(spec, "trace_ctx", None)
                if tctx:
                    # Each asyncio task runs in its own contextvars copy:
                    # install-without-reset is safe and nested submissions
                    # from the body parent to this execution span.
                    sid = _get_tracing().set_task_ctx(tctx)
                    spec._trace = (tctx[0], sid, tctx[1])
                if inspect.iscoroutinefunction(method):
                    return await method(*args, **kwargs)
                # Sync method of an async actor: run its body ON the
                # loop so it serializes with async bodies.
                return method(*args, **kwargs)

            coro = _body()
        except BaseException as e:  # noqa: BLE001
            traceback.print_exc()
            self._store_returns(
                spec, TaskError(spec.method_name, e), failed=True)
            self._finish(spec, failed=True)
            return
        fut = asyncio.run_coroutine_threadsafe(
            coro, self._actor_event_loop())

        def _store(f):
            failed = False
            try:
                value = f.result()
            except BaseException as e:  # noqa: BLE001
                failed = True
                value = TaskError(spec.method_name, e)
                traceback.print_exc()
            try:
                self._store_returns(spec, value, failed)
            except BaseException:  # noqa: BLE001
                failed = True
                traceback.print_exc()
            finally:
                self._finish(spec, failed)

        # Completion (serialization + shm write + control sends) runs on
        # a dedicated thread, NOT the loop thread — a multi-MB result
        # must not stall every other in-flight await on this actor.
        fut.add_done_callback(
            lambda f: self._async_completions().submit(_store, f))

    def _actor_event_loop(self):
        """Lazily start this actor's asyncio loop thread."""
        loop = getattr(self, "_aio_loop", None)
        if loop is None:
            import asyncio

            with self._aio_lock:
                loop = getattr(self, "_aio_loop", None)
                if loop is None:
                    loop = asyncio.new_event_loop()
                    threading.Thread(target=loop.run_forever,
                                     name="actor-asyncio",
                                     daemon=True).start()
                    self._aio_loop = loop
        return loop

    def _async_completions(self):
        """Single-thread executor storing async task results in
        completion order (off the loop thread)."""
        pool = getattr(self, "_aio_done_pool", None)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            with self._aio_lock:
                pool = getattr(self, "_aio_done_pool", None)
                if pool is None:
                    pool = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="actor-aio-done")
                    self._aio_done_pool = pool
        return pool

    # -- lifecycle ------------------------------------------------------
    def _on_reconnect(self):
        """Control plane came back (head restart): re-announce so the
        restored registry can rebind this worker (reference: raylet
        re-registration after NotifyGCSRestart)."""
        try:
            if self._actor_hex:
                self.core.client.send({
                    "op": "actor_ready", "actor": self._actor_hex,
                    "address": self.advertised_address})
            elif not getattr(self, "_executing", False):
                # Mid-task workers must NOT report online: the restarted
                # head would mark them idle and double-book a second
                # concurrent task; the in-flight task's task_done flips
                # them idle when it actually finishes.
                self.core.client.send({"op": "worker_online"})
            else:
                # Leased tasks send no task_done, so nothing would ever
                # flip this worker out of 'starting' on the restarted
                # head — announce when the current work drains
                # (_finish direct branch).
                self._announce_pending = True
        except Exception:
            pass

    def _on_exit(self):
        self._exit_ev.set()

    def run_forever(self):
        self._exit_ev.wait()
        try:
            self.server.stop()
            self.core.close()
        finally:
            os._exit(0)


def main():
    import faulthandler

    faulthandler.enable()  # native-crash stacks land in the worker .err log
    from ray_tpu_torch.core import knobs

    knobs.apply_interpreter_tuning()
    from ray_tpu_torch.core.logging_config import apply_from_env

    apply_from_env()  # session LoggingConfig (TEXT/JSON), if the driver set one
    control_addr = os.environ["RAY_TPU_CONTROL_ADDR"]
    worker_hex = os.environ["RAY_TPU_WORKER_ID"]
    kind = os.environ.get("RAY_TPU_WORKER_KIND", "pool")
    env_key = os.environ.get("RAY_TPU_ENV_KEY", "")
    rt = WorkerRuntime(control_addr, worker_hex, kind=kind, env_key=env_key)
    rt.run_forever()


if __name__ == "__main__":
    main()
