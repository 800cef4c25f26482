"""Control server: object directory, actor registry, KV, scheduler, worker pool.

This is the single-node fusion of the reference's GCS server
(src/ray/gcs/gcs_server/gcs_server.cc — actor/node/KV/pubsub managers) and
raylet (src/ray/raylet/node_manager.cc — ClusterTaskManager / LocalTaskManager
/ WorkerPool).  It runs as threads inside the head process and speaks the
rpc.py framed protocol to driver and worker processes.

Design deviations from the reference, deliberate for the TPU-first rebuild
(the JAX package's design, carried over):
  - Small objects live in the directory itself rather than in per-owner
    memory stores; on a single node the directory IS the owner's metadata
    table.  Multi-node ownership (owner-resident values + location lookups,
    reference reference_count.h / ownership_based_object_directory.cc) is
    layered on in the multi-host control plane.
  - Scheduling is event-driven FIFO + resource fit over one node; the
    hybrid pack/spread policy slot is where multi-node placement goes.
  - GPUs are resource vector entries, as in the reference.  A worker
    that asks for none is of the CPU class and sees no card
    (CUDA_VISIBLE_DEVICES="", node_manager.cpu_worker_env); a GPU-class
    worker keeps the node's visibility (env key `gpu<N>-...`).
"""

from __future__ import annotations

import itertools
import logging
import os
import subprocess
import sys
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

from ray_tpu_torch.core import object_plane, rpc
from ray_tpu_torch.core.config import HEAD_RUNTIME, Config
from ray_tpu_torch.core.exceptions import ObjectLostError
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_store import ShmObjectStore
from ray_tpu_torch.core.resources import CPU, GPU, ResourceSet
from ray_tpu_torch.core.task_spec import ActorCreationSpec, TaskSpec
from ray_tpu_torch.core.log_once import warn_once

logger = logging.getLogger(__name__)

# Object states
PENDING = "PENDING"
READY = "READY"
ERRORED = "ERRORED"

# Actor states (mirrors reference gcs_actor_manager.h state machine)
A_PENDING = "PENDING_CREATION"
A_ALIVE = "ALIVE"
A_RESTARTING = "RESTARTING"
A_DEAD = "DEAD"


@dataclass
class ObjectEntry:
    state: str = PENDING
    size: int = 0
    inline: Optional[bytes] = None
    in_shm: bool = False
    refcount: int = 1
    is_error: bool = False
    subscribers: List[rpc.Connection] = field(default_factory=list)
    producing_task: Optional[str] = None  # task hex, lineage hook
    spilled_uri: Optional[str] = None  # external-storage URI when spilled
    restoring: bool = False
    stored_at: float = 0.0
    # Times this object's value was re-created by lineage reconstruction.
    reconstructions: int = 0
    # Which node's shm arena holds the primary copy ("head" = the head's
    # arena, shared by logical/fake-cluster nodes).  Counterpart of the
    # reference's object directory locations
    # (ownership_based_object_directory.cc).
    node_id: str = "head"
    # Nodes that cached a pulled replica (so freeing the object can
    # delete every arena copy, not just the primary's).
    replicas: Set[str] = field(default_factory=set)
    # Nodes with an in-flight PullManager pull (object_pull_started
    # announce): node_id -> announce time.  The locality tie-break
    # credits these too — a task chasing an object already in transit
    # to a node should land there, not trigger a second transfer.
    # Entries expire (stale announce) and clear on replica landing.
    pulling: Dict[str, float] = field(default_factory=dict)


@dataclass
class NodeState:
    """One logical node: a resource pool + its worker processes.

    Counterpart of a raylet's local resource view (raylet/node_manager.h).
    In-process ("fake cluster") nodes partition the head's control plane the
    way the reference's cluster_utils.Cluster partitions one host into many
    raylets (python/ray/cluster_utils.py:135); worker processes are real
    either way.
    """

    node_id: str
    total: ResourceSet
    available: ResourceSet
    alive: bool = True
    is_head: bool = False
    # Graceful drain (reference DrainRaylet, node_manager.proto:401 /
    # autoscaler DrainNode, autoscaler.proto:334): a draining node is
    # still alive but no longer schedulable; running work finishes,
    # sole-copy objects migrate to a survivor, idle PG bundles
    # reschedule, then the node terminates WITHOUT lineage re-execution.
    draining: bool = False
    drain_reason: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    # Real (remote-host) nodes: set by register_node.  Logical nodes
    # (fake-cluster partitions) leave these empty and share the head's
    # arena/worker spawner.
    address: str = ""  # the node manager's object-plane rpc server
    conn: Optional[rpc.Connection] = None  # its control connection
    store_key: str = ""  # its arena name ('' = shares the head arena)
    shm_dir: str = ""
    # Last host-stats report from the node's reporter
    # (dashboard/reporter.py; reference reporter_agent.py).
    stats: Dict[str, Any] = field(default_factory=dict)
    # When that report arrived (time.time()); the health watchdog
    # flags remote nodes whose reporter has gone silent.
    stats_at: float = 0.0

    @property
    def is_remote(self) -> bool:
        return self.conn is not None or bool(self.store_key)

    @property
    def schedulable(self) -> bool:
        """Scheduling eligibility: alive AND not draining (a draining
        node stops accepting leases/placements immediately)."""
        return self.alive and not self.draining


@dataclass
class Bundle:
    """A placement-group bundle: resources reserved on one node."""

    index: int
    node_id: str
    reserved: ResourceSet
    available: ResourceSet


@dataclass
class PlacementGroupEntry:
    """Counterpart of GcsPlacementGroupManager state
    (gcs/gcs_server/gcs_placement_group_manager.h:230)."""

    pg_hex: str
    strategy: str  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    bundle_specs: List[Dict[str, float]]
    state: str = "PENDING"  # PENDING | CREATED | REMOVED | INFEASIBLE
    bundles: List[Bundle] = field(default_factory=list)
    ready_obj: str = ""  # object set when CREATED (PlacementGroup.ready())
    name: str = ""


@dataclass
class WorkerInfo:
    worker_hex: str
    conn: Optional[rpc.Connection] = None
    pid: int = 0
    address: str = ""  # worker's own rpc server (direct actor transport)
    kind: str = "pool"  # pool | actor | driver
    env_key: str = ""
    state: str = "starting"  # starting | idle | busy | dead
    current_task: Optional[str] = None
    acquired: ResourceSet = field(default_factory=ResourceSet)
    actor_hex: str = ""
    proc: Optional[subprocess.Popen] = None
    node_id: str = ""
    # where acquired resources were charged: ("node", node_id) or
    # ("pg", pg_hex, bundle_index)
    charge: tuple = ()
    # state == "leased": the owner (worker hex) this worker is leased to
    # (reference: a granted lease binds the worker to the requesting
    # CoreWorkerDirectTaskSubmitter, direct_task_transport.h:353)
    leased_to: str = ""
    # When the spawn was requested; remote spawns (proc is None) that
    # never register are reaped after worker_register_timeout_s.
    spawned_at: float = 0.0


@dataclass
class ActorEntry:
    spec: ActorCreationSpec
    state: str = A_PENDING
    worker_hex: str = ""
    address: str = ""
    death_reason: str = ""
    subscribers: List[rpc.Connection] = field(default_factory=list)


@dataclass
class TaskRecord:
    spec: TaskSpec
    state: str = "PENDING"  # PENDING | RUNNING | FINISHED | FAILED
    worker_hex: str = ""
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    # Streamed-event extras (worker _buffer_task_event deltas): arrival
    # time on the executing worker, retry ordinal, and the trace span
    # this execution belongs to (util/tracing.py propagation).
    received_at: float = 0.0
    retry_count: int = 0
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""
    # Total READY shm bytes of the spec's ref args, captured while the
    # task (and therefore its args) is alive; -1 = not yet computed.
    # The watchdog buckets straggler baselines by this so a 1 GiB-input
    # sibling is never judged against 1 KiB-input completions.
    arg_bytes: int = -1


def _sum_bundles(bundle_specs: List[Dict[str, float]]) -> Dict[str, float]:
    total: Dict[str, float] = {}
    for b in bundle_specs:
        for k, v in b.items():
            total[k] = total.get(k, 0.0) + v
    return total


_TRUE_BYTES: Optional[bytes] = None


def _serialized_true() -> bytes:
    global _TRUE_BYTES
    if _TRUE_BYTES is None:
        from ray_tpu_torch.core.serialization import serialize

        _TRUE_BYTES = serialize(True).to_bytes()
    return _TRUE_BYTES


_FALSY = ("0", "false", "no", "off")


def _env_int(name: str, default: int, floor: int) -> int:
    try:
        v = int(os.environ.get(name, str(default)))
    except ValueError:
        v = default
    return max(floor, v)


def _env_float(name: str, default: float, floor: float) -> float:
    try:
        v = float(os.environ.get(name, str(default)))
    except ValueError:
        v = default
    return max(floor, v)


def _watchdog_enabled() -> bool:
    """RAY_TPU_WATCHDOG gate, read once at head construction: when off
    the watchdog object is never built and the scheduler loop's only
    trace of it is one `is not None` check."""
    return os.environ.get(
        "RAY_TPU_WATCHDOG", "1").strip().lower() not in _FALSY


class _Watchdog:
    """Straggler / node-health detector (head-side).

    Counterpart of the operational watchdogs TPU-pod training stacks
    grow by necessity: at scale the dominant failures are not crashes
    but tasks that silently run 10x longer than their siblings and
    hosts whose reporters go quiet.  The detector compares each RUNNING
    task's age against the completed-duration distribution of its
    same-name siblings (percentile x multiplier threshold), and each
    remote node's last stats report against a heartbeat timeout.
    Verdicts land on the flight recorder's "health" lane and the
    ray_tpu_stragglers_total / ray_tpu_node_unhealthy_total counters —
    detection only, no automatic kills (the OOM killer owns policy).

    Knobs: RAY_TPU_WATCHDOG (off switch), _INTERVAL_S (tick period,
    default 5), _MIN_SAMPLES (sibling completions required, default 5),
    _PERCENTILE (default 95), _MULTIPLIER (threshold factor, default
    3), _MIN_AGE_S (never flag younger than this, default 1),
    _HEARTBEAT_TIMEOUT_S (stale-reporter cutoff, default 30)."""

    def __init__(self, server: "ControlServer"):
        self.server = server
        self.interval_s = _env_float(
            "RAY_TPU_WATCHDOG_INTERVAL_S", 5.0, 0.05)
        self.min_samples = _env_int(
            "RAY_TPU_WATCHDOG_MIN_SAMPLES", 5, 1)
        self.percentile = min(100.0, _env_float(
            "RAY_TPU_WATCHDOG_PERCENTILE", 95.0, 1.0))
        self.multiplier = _env_float(
            "RAY_TPU_WATCHDOG_MULTIPLIER", 3.0, 1.0)
        self.min_age_s = _env_float(
            "RAY_TPU_WATCHDOG_MIN_AGE_S", 1.0, 0.0)
        self.heartbeat_timeout_s = _env_float(
            "RAY_TPU_WATCHDOG_HEARTBEAT_TIMEOUT_S", 30.0, 1.0)
        self._last_tick = 0.0
        self._flagged_tasks: Set[str] = set()  # flag once per task
        self._unhealthy_nodes: Set[str] = set()
        # Device-plane rules: recompile storms flag once per
        # (worker, function); HBM watermark alerts re-arm when the
        # occupancy drops back under the threshold.
        self.recompile_max = _env_int(
            "RAY_TPU_DEVICE_RECOMPILE_MAX", 8, 1)
        self.hbm_watermark = _env_float(
            "RAY_TPU_DEVICE_HBM_WATERMARK", 0.9, 0.01)
        self._flagged_recompiles: Set[tuple] = set()
        self._hbm_alerted: Set[str] = set()
        # Totals for /api/profile and tests (counters may be None when
        # metrics failed to import).
        self.stragglers_flagged = 0
        self.nodes_flagged = 0
        self.recompile_storms_flagged = 0
        self.hbm_alerts = 0

    @staticmethod
    def _percentile_of(sorted_vals: List[float], pct: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = int(len(sorted_vals) * pct / 100.0)
        return sorted_vals[min(idx, len(sorted_vals) - 1)]

    @staticmethod
    def _size_bucket(arg_bytes: int) -> int:
        """Arg-size class: 0 for no/unknown args, then one bucket per
        16x of total READY-arg bytes (1 KiB and 4 KiB share a bucket;
        1 KiB and 1 GiB never do).  Coarse on purpose — buckets must
        collect min_samples completions before they gate anything."""
        if arg_bytes <= 0:
            return 0
        return max(1, int(arg_bytes).bit_length() // 4)

    def maybe_tick(self) -> None:
        now = time.time()
        if now - self._last_tick < self.interval_s:
            return
        self._last_tick = now
        try:
            self.tick(now)
        except Exception:
            pass  # detection must never take down the scheduler

    def tick(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        self._check_stragglers(now)
        self._check_nodes(now)
        self._check_device(now)

    def _check_stragglers(self, now: float) -> None:
        srv = self.server
        # Completed-sibling durations, both pooled per task name and
        # split per (name, arg-size bucket): heterogeneous batches
        # (same function over 1 KiB vs 1 GiB inputs) threshold within
        # their own size class when it has enough samples, falling back
        # to the pooled distribution when it does not.
        durations: Dict[str, List[float]] = {}
        bucketed: Dict[tuple, List[float]] = {}
        running: List[tuple] = []
        with srv.lock:
            for th, rec in srv.tasks.items():
                name = rec.spec.name or \
                    getattr(rec.spec, "func_id", "")[:8]
                if rec.state == "FINISHED":
                    start = rec.started_at or rec.received_at
                    if start and rec.finished_at > start:
                        dur = rec.finished_at - start
                        durations.setdefault(name, []).append(dur)
                        bucket = self._size_bucket(rec.arg_bytes)
                        bucketed.setdefault((name, bucket),
                                            []).append(dur)
                elif rec.state == "RUNNING" and \
                        th not in self._flagged_tasks:
                    start = rec.started_at or rec.received_at or \
                        rec.submitted_at
                    if start:
                        if rec.arg_bytes < 0:
                            rec.arg_bytes = srv._task_arg_bytes(rec.spec)
                        running.append(
                            (th, name, now - start, rec.worker_hex,
                             rec.arg_bytes))
        for sibs in durations.values():
            sibs.sort()
        for sibs in bucketed.values():
            sibs.sort()
        from ray_tpu_torch.util import flight_recorder

        for th, name, age, worker_hex, arg_bytes in running:
            bucket = self._size_bucket(arg_bytes)
            sibs = bucketed.get((name, bucket))
            pooled = False
            if sibs is None or len(sibs) < self.min_samples:
                sibs = durations.get(name)
                pooled = True
            if sibs is None or len(sibs) < self.min_samples:
                continue
            threshold = max(
                self.min_age_s,
                self._percentile_of(sibs, self.percentile)
                * self.multiplier)
            if age <= threshold:
                continue
            self._flagged_tasks.add(th)
            self.stragglers_flagged += 1
            if srv._m_stragglers is not None:
                srv._m_stragglers.inc()
            flight_recorder.record(
                "health", "straggler", task=th, name=name,
                age_s=round(age, 3), threshold_s=round(threshold, 3),
                siblings=len(sibs), worker=worker_hex,
                arg_bytes=max(0, arg_bytes), size_bucket=bucket,
                pooled_baseline=pooled)

    def _check_nodes(self, now: float) -> None:
        srv = self.server
        stale: List[tuple] = []
        recovered: List[str] = []
        with srv.lock:
            for nid, node in srv.nodes.items():
                # Only remote nodes report via the wire; the head and
                # logical (fake-cluster) nodes share this process.
                if node.is_head or node.conn is None or not node.alive:
                    continue
                seen = node.stats_at
                if seen and now - seen > self.heartbeat_timeout_s:
                    if nid not in self._unhealthy_nodes:
                        stale.append((nid, now - seen))
                elif nid in self._unhealthy_nodes:
                    recovered.append(nid)
        from ray_tpu_torch.util import flight_recorder

        for nid, silent_s in stale:
            self._unhealthy_nodes.add(nid)
            self.nodes_flagged += 1
            if srv._m_node_unhealthy is not None:
                srv._m_node_unhealthy.inc()
            flight_recorder.record(
                "health", "node_unhealthy", node=nid,
                silent_s=round(silent_s, 1),
                timeout_s=self.heartbeat_timeout_s)
        for nid in recovered:
            self._unhealthy_nodes.discard(nid)
            flight_recorder.record("health", "node_recovered", node=nid)

    def _check_device(self, now: float) -> None:
        """Device-plane rules over the latest profile samples (the
        recompile counts and HBM ledger piggybacked by the worker
        sampler): a recompile storm — post-warmup compiles of one
        function past RAY_TPU_DEVICE_RECOMPILE_MAX — flags once per
        (worker, function); an HBM watermark at/over
        RAY_TPU_DEVICE_HBM_WATERMARK alerts and re-arms when the
        reported watermark drops back under."""
        srv = self.server
        with srv.lock:
            latest = {wh: dict(s) for wh, s in srv._profiles.items()}
        storms: List[tuple] = []
        hbm_hits: List[tuple] = []
        hbm_clear: List[str] = []
        for wh, sample in latest.items():
            rec = sample.get("recompiles")
            if isinstance(rec, dict):
                for fn, n in rec.items():
                    try:
                        n = int(n)
                    except (TypeError, ValueError):  # raylint: allow-swallow(a malformed count in one report must not kill the sweep)
                        continue
                    if n > self.recompile_max and \
                            (wh, fn) not in self._flagged_recompiles:
                        self._flagged_recompiles.add((wh, fn))
                        storms.append((wh, fn, n))
            dev = sample.get("device")
            frac = (dev or {}).get("watermark_fraction") \
                if isinstance(dev, dict) else None
            if frac is None:
                frac = sample.get("hbm_watermark_fraction")
            if isinstance(frac, (int, float)) and \
                    not isinstance(frac, bool):
                if frac >= self.hbm_watermark:
                    if wh not in self._hbm_alerted:
                        self._hbm_alerted.add(wh)
                        hbm_hits.append((wh, float(frac)))
                elif wh in self._hbm_alerted:
                    hbm_clear.append(wh)
        from ray_tpu_torch.util import flight_recorder

        for wh, fn, n in storms:
            self.recompile_storms_flagged += 1
            flight_recorder.record(
                "health", "recompile_storm", worker=wh, function=fn,
                recompiles_after_warmup=n,
                threshold=self.recompile_max)
        for wh, frac in hbm_hits:
            self.hbm_alerts += 1
            flight_recorder.record(
                "health", "hbm_watermark", worker=wh,
                watermark_fraction=round(frac, 4),
                threshold=self.hbm_watermark)
        for wh in hbm_clear:
            self._hbm_alerted.discard(wh)
            flight_recorder.record(
                "health", "hbm_watermark_cleared", worker=wh)

    def profile_distributions(self) -> Dict[str, Dict[str, Any]]:
        """Per-worker percentile summaries over the head's profile
        history rings — worker load as a distribution (p50/p95 across
        the ring) instead of whichever sample arrived last."""
        srv = self.server
        with srv.lock:
            rings = {wh: list(ring)
                     for wh, ring in srv._profile_hist.items()
                     if wh in srv.workers
                     and srv.workers[wh].state != "dead"}
        return {wh: _profile_history_summary(samples)
                for wh, samples in rings.items()}

    def snapshot(self) -> Dict[str, Any]:
        return {
            "enabled": True,
            "interval_s": self.interval_s,
            "stragglers_flagged": self.stragglers_flagged,
            "nodes_flagged": self.nodes_flagged,
            "unhealthy_nodes": sorted(self._unhealthy_nodes),
            "recompile_storms_flagged": self.recompile_storms_flagged,
            "recompile_max": self.recompile_max,
            "hbm_alerts": self.hbm_alerts,
            "hbm_watermark": self.hbm_watermark,
            "profile_distributions": self.profile_distributions(),
        }


def _profile_history_summary(samples: List[dict]) -> Dict[str, Any]:
    """p50/p95 per numeric field over one worker's history ring (the
    /api/profile and watchdog distribution view; computed at query
    time, never on the report path)."""
    numeric: Dict[str, List[float]] = {}
    for s in samples:
        for k, v in s.items():
            if k in ("ts", "pid") or isinstance(v, bool):
                continue
            if isinstance(v, (int, float)):
                numeric.setdefault(k, []).append(float(v))
    pcts: Dict[str, Dict[str, float]] = {}
    for k, vals in numeric.items():
        vals.sort()
        pcts[k] = {"p50": _Watchdog._percentile_of(vals, 50.0),
                   "p95": _Watchdog._percentile_of(vals, 95.0)}
    return {
        "samples": len(samples),
        "first_ts": samples[0].get("ts", 0.0) if samples else 0.0,
        "last_ts": samples[-1].get("ts", 0.0) if samples else 0.0,
        "percentiles": pcts,
    }


# ---------------------------------------------------------------------------
# Head scale-out structures (reference: the sharded GCS table layer,
# gcs_table_storage.h — per-key-space partitions so hot paths stop
# serializing on one store — and the raylet's bucketed
# ClusterResourceManager view).


def _gcs_shards() -> int:
    """RAY_TPU_GCS_SHARDS: owner-keyed submit-ingress shards (0 =
    legacy single-lock ingress, used by the paired benchmarks)."""
    try:
        return max(0, int(os.environ.get("RAY_TPU_GCS_SHARDS", "8")))
    except ValueError:
        return 8


def _node_index_enabled() -> bool:
    return os.environ.get("RAY_TPU_NODE_INDEX", "1").strip().lower() \
        not in ("0", "false", "no")


class ShardedTaskTable:
    """Task-record table partitioned into N shards, each with its own
    lock.  The dict protocol (get/[]/pop/len/items) is preserved so the
    scheduler's global-lock call sites read through unchanged; the win
    is `_op_task_events` — the highest-volume completion-drain op —
    which merges event deltas under only the record's shard lock and
    never touches the scheduler's global lock.

    items()/values()/keys() return per-shard snapshots (safe to iterate
    while other threads insert), so iteration order is shard-grouped
    rather than global insertion order — lineage pruning becomes
    approximate-oldest-first, which it already effectively was."""

    __slots__ = ("_shards", "_locks", "_n")

    def __init__(self, n: int = 8):
        self._n = max(1, n)
        self._shards: List[Dict[str, Any]] = [
            {} for _ in range(self._n)]
        self._locks = [threading.Lock() for _ in range(self._n)]

    def _idx(self, key: str) -> int:
        return hash(key) % self._n

    def lock_for(self, key: str) -> threading.Lock:
        return self._locks[self._idx(key)]

    def get(self, key, default=None):
        return self._shards[self._idx(key)].get(key, default)

    def __getitem__(self, key):
        return self._shards[self._idx(key)][key]

    def __setitem__(self, key, value):
        i = self._idx(key)
        with self._locks[i]:
            self._shards[i][key] = value

    def __delitem__(self, key):
        i = self._idx(key)
        with self._locks[i]:
            del self._shards[i][key]

    def pop(self, key, *default):
        i = self._idx(key)
        with self._locks[i]:
            return self._shards[i].pop(key, *default)

    def __contains__(self, key) -> bool:
        return key in self._shards[self._idx(key)]

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def __bool__(self) -> bool:
        return any(self._shards)

    def items(self):
        out = []
        for i, s in enumerate(self._shards):
            with self._locks[i]:
                out.extend(s.items())
        return out

    def values(self):
        return [v for _, v in self.items()]

    def keys(self):
        return [k for k, _ in self.items()]


class PendingLeaseQueue:
    """Queued worker-lease demand, sharded by owner with incremental
    per-node / per-env / per-owner indexes.

    `_op_request_lease`'s virtual-availability view used to subtract
    queued demand by scanning EVERY pending entry per candidate node
    (O(pending x nodes) per request); the node index makes that
    O(demand actually targeting the node).  Appends are O(1); the grant
    pass rebuilds via reset() exactly where it used to rebuild the flat
    list."""

    __slots__ = ("_items", "_by_node", "_by_env", "_by_owner")

    def __init__(self):
        self._items: List[dict] = []
        self._by_node: Dict[str, List[dict]] = {}
        self._by_env: Dict[str, int] = {}
        self._by_owner: Dict[str, int] = {}

    def _index(self, pl: dict):
        nid = pl.get("node_id") or ""
        if nid:
            self._by_node.setdefault(nid, []).append(pl)
        ek = pl.get("env_key", "")
        self._by_env[ek] = self._by_env.get(ek, 0) + 1
        ow = pl.get("owner", "")
        self._by_owner[ow] = self._by_owner.get(ow, 0) + 1

    def append(self, pl: dict):
        self._items.append(pl)
        self._index(pl)

    def reset(self, items: List[dict]):
        self._items = list(items)
        self._by_node = {}
        self._by_env = {}
        self._by_owner = {}
        for pl in self._items:
            self._index(pl)

    def __iter__(self):
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def node_demand(self, node_id: str) -> List[dict]:
        return self._by_node.get(node_id, ())

    def env_count(self, env_key: str) -> int:
        return self._by_env.get(env_key, 0)

    def owners_except(self, owner_hex: str):
        return [o for o in self._by_owner if o != owner_hex]

    def earliest_deadline(self) -> Optional[float]:
        """Absolute time the soonest queued entry goes stale (spawned
        demand expires at 10s, cluster-infeasible at 15s — the grant
        pass's denial windows).  Drives the scheduler's timer-wheel arm
        instead of a fixed 0.5 s poll."""
        best = None
        for pl in self._items:
            d = pl["created"] + (10.0 if pl.get("node_id") else 15.0)
            if best is None or d < best:
                best = d
        return best


class _NodeIndex:
    """Utilization-bucketed node index + per-resource free sets: the
    O(1)-amortized candidate generator behind `_pick_node` and
    SPREAD/STRICT_SPREAD bundle placement (replacing full node-table
    scans, which made 1,000-PG create-ready collapse 3.6x on the
    2,000-node sim).

    Buckets partition [0, 1] utilization into NBUCKETS slices; each
    bucket is a list with swap-pop removal so membership updates are
    O(1) and positional probing (hash-rotated) is stable enough for
    SPREAD tie fan-out.  The index is a *candidate generator*, not an
    oracle: queries re-verify fit against the caller's (possibly
    virtual) availability view before committing, so staleness can only
    cost optimality, never correctness.  Callers `touch()` a node after
    mutating its availability; `rebuild()` runs on join/death."""

    NBUCKETS = 8

    __slots__ = ("_server", "_buckets", "_pos", "_free", "rebuilds")

    def __init__(self, server: "ControlServer"):
        self._server = server
        self._buckets: List[List[str]] = [
            [] for _ in range(self.NBUCKETS + 1)]
        # node_id -> (bucket index, position in bucket list)
        self._pos: Dict[str, tuple] = {}
        # Per-resource-class free sets: node ids with available[res]>0.
        # A scarce resource's set (e.g. GPU on a mostly-CPU cluster) is
        # tiny, so queries needing it iterate the set instead of the
        # buckets.
        self._free: Dict[str, Set[str]] = {}
        self.rebuilds = 0

    def _bucket_of(self, node) -> int:
        u = self._server._utilization(node)
        b = int(u * self.NBUCKETS)
        return min(max(b, 0), self.NBUCKETS)

    def _remove(self, node_id: str):
        at = self._pos.pop(node_id, None)
        if at is None:
            return
        b, i = at
        bucket = self._buckets[b]
        last = bucket.pop()
        if last != node_id:
            bucket[i] = last
            self._pos[last] = (b, i)

    def _insert(self, node_id: str, b: int):
        bucket = self._buckets[b]
        bucket.append(node_id)
        self._pos[node_id] = (b, len(bucket) - 1)

    def touch(self, node_id: str):
        """Re-bucket one node after its availability changed (lock
        held by the caller)."""
        node = self._server.nodes.get(node_id)
        if node is None or not node.schedulable:
            self._remove(node_id)
            for s in self._free.values():
                s.discard(node_id)
            return
        avail = node.available.to_dict()
        for res, s in self._free.items():
            if avail.get(res, 0) <= 0:
                s.discard(node_id)
        for res, v in avail.items():
            if v > 0:
                self._free.setdefault(res, set()).add(node_id)
        b = self._bucket_of(node)
        at = self._pos.get(node_id)
        if at is not None and at[0] == b:
            return
        self._remove(node_id)
        self._insert(node_id, b)

    def rebuild(self):
        """Full re-index (node join/death/drain — rare)."""
        self._buckets = [[] for _ in range(self.NBUCKETS + 1)]
        self._pos = {}
        self._free = {}
        for nid, node in self._server.nodes.items():
            if node.schedulable:
                self._insert(nid, self._bucket_of(node))
                for res, v in node.available.to_dict().items():
                    if v > 0:
                        self._free.setdefault(res, set()).add(nid)
        self.rebuilds += 1
        try:
            from ray_tpu_torch.util import flight_recorder

            flight_recorder.record("sched", "index_rebuild",
                                   nodes=len(self._pos))
        except Exception:  # raylint: allow-swallow(telemetry only)
            pass

    def buckets_low_to_high(self):
        for b in self._buckets:
            if b:
                yield b

    def buckets_high_to_low(self, below: Optional[float] = None):
        """Buckets from most- to least-utilized; `below` drops whole
        buckets at/above that utilization (the hybrid policy's pack
        threshold)."""
        hi = len(self._buckets) - 1
        if below is not None:
            hi = min(hi, max(0, int(below * self.NBUCKETS) - 1))
        for i in range(hi, -1, -1):
            if self._buckets[i]:
                yield self._buckets[i]

    def scarce_set(self, res_names, cap: int = 16) -> Optional[Set[str]]:
        """The smallest per-resource free set among `res_names`, when
        it is small enough that iterating it beats the bucket walk;
        None when every named resource is plentiful (or unknown —
        unknown means no node has it free, returned as the empty
        set)."""
        best = None
        for r in res_names:
            s = self._free.get(r)
            if s is None:
                return set()
            if best is None or len(s) < len(best):
                best = s
        return best if best is not None and len(best) <= cap else None

    def probe(self, bucket: List[str], seed: int, accept) -> Optional[str]:
        """Rotated linear probe over one bucket: start at seed %% len
        so equal-utilization nodes fan out, return the first node
        `accept` confirms.  O(1) expected when most nodes fit."""
        n = len(bucket)
        if n == 0:
            return None
        start = seed % n
        for i in range(n):
            nid = bucket[start + i - n if start + i >= n else start + i]
            if accept(nid):
                return nid
        return None


class ControlServer:
    def __init__(self, session_id: str, config: Config, resources: ResourceSet,
                 session_dir: str, namespace: str = ""):
        self.session_id = session_id
        self.config = config
        self.session_dir = session_dir
        self.namespace = namespace
        os.makedirs(os.path.join(session_dir, "logs"), exist_ok=True)
        from ray_tpu_torch.core.node_manager import prewarm_zygote

        prewarm_zygote()  # worker template warms while the head boots

        self.lock = threading.RLock()
        # Object-settle condition (shares self.lock): fetch-path waiters
        # block here instead of sleep-polling; every READY/ERRORED
        # transition and restore completion notifies.
        self._obj_settled = threading.Condition(self.lock)
        # Owner-keyed submit ingress: _op_submit_task(_batch) appends
        # specs to a per-owner-shard deque WITHOUT the global lock; the
        # scheduler (and any reader that could observe an undrained
        # spec) drains them under the lock.  deque append/popleft are
        # GIL-atomic, so the ingress itself is lock-free.  None = legacy
        # single-lock ingress (RAY_TPU_GCS_SHARDS=0).
        n_shards = _gcs_shards()
        self._ingress: Optional[List[deque]] = (
            [deque() for _ in range(n_shards)] if n_shards else None)
        self._node_index = None  # built after journal restore
        self._lease_timer = None  # timer-wheel handle for lease expiry
        try:
            self._idle_wait_s = float(os.environ.get(
                "RAY_TPU_SCHED_IDLE_WAIT_S", "30.0"))
        except ValueError:
            self._idle_wait_s = 30.0
        self.objects: Dict[str, ObjectEntry] = {}
        self.workers: Dict[str, WorkerInfo] = {}
        self.actors: Dict[str, ActorEntry] = {}
        self.named_actors: Dict[tuple, str] = {}
        # Pluggable KV storage (reference gcs/store_client/, N6):
        # in-memory by default; a configured path journals to disk so
        # the KV survives head restarts.
        from ray_tpu_torch.core.store_client import make_store_client

        self.kv = make_store_client(config.gcs_store_path)
        self.funcs: Dict[str, bytes] = {}
        # In-flight actor-task return objects: actor hex -> pending obj
        # hexes, and the reverse map. Used to fail callers' gets when an
        # actor dies with tasks in its queue (the reference fails these via
        # DirectActorTaskSubmitter::DisconnectActor).
        self.actor_inflight: Dict[str, Set[str]] = {}
        self.obj_actor: Dict[str, str] = {}
        self.tasks = ShardedTaskTable(max(1, n_shards or 8))
        # Lineage: object hex -> producing task hex, kept even after the
        # object entry itself is freed so a lost dependency can be
        # re-created (reference lineage map, task_manager.h:208).
        self.lineage: Dict[str, str] = {}
        self.pending_tasks: List[TaskSpec] = []
        # Objects some pending task waits on (ref args not yet READY):
        # lets task_done wake the scheduler only when a completion's
        # puts actually unblock someone (fast-redispatch keeps the
        # no-deps burst path pass-free).  Stale entries merely cause an
        # extra wake; pruned when the pending queue drains.
        self._dep_waiters: set = set()
        self.pending_actors: List[ActorCreationSpec] = []
        # Unsatisfied worker-lease requests (owner-direct task path):
        # granted as workers come online / free up, or denied on expiry
        # so the owner re-requests (reference: queued lease requests in
        # NodeManager::HandleRequestWorkerLease, node_manager.cc:1794).
        self.pending_leases = PendingLeaseQueue()
        # env_key -> runtime_env dict; workers fetch + apply their pool's
        # env at startup (runtime_env/plugin.py).
        self.runtime_envs: Dict[str, dict] = {}
        # env_key -> (setup error, poisoned_at); tasks needing a broken
        # env fail fast instead of respawning workers forever (reference:
        # runtime-env agent setup failure fails the lease request). The
        # poison expires so transient node-local failures (full disk, KV
        # hiccup) don't brick the env for the cluster's lifetime.
        self.broken_envs: Dict[str, tuple] = {}
        self.broken_env_ttl_s = 60.0
        # C++-defined tasks/actors (reference: cpp/include/ray/api —
        # remote functions DEFINED in C++, executed by a C++ worker
        # that registers its function/class names here).
        self.cpp_functions: Dict[str, rpc.Connection] = {}
        self.cpp_actor_classes: Dict[str, rpc.Connection] = {}
        self.cpp_instances: Dict[str, rpc.Connection] = {}
        self.cpp_inflight: Dict[int, tuple] = {}  # id(conn) -> (conn, objs)

        head = NodeState(node_id="head", total=resources,
                         available=resources, is_head=True)
        self.nodes: Dict[str, NodeState] = {"head": head}
        self.placement_groups: Dict[str, PlacementGroupEntry] = {}
        self.store = ShmObjectStore(session_id, config.shm_dir,
                                    capacity=config.object_store_memory,
                                    owner=True)
        # Spilling (reference LocalObjectManager + external_storage.py):
        # cold shm objects move to external storage past the usage
        # threshold and restore transparently on next subscribe.
        from ray_tpu_torch.core.external_storage import storage_from_spec

        self.external_storage = storage_from_spec(
            config.spill_storage, session_dir)
        self.spilled_bytes_total = 0
        # OOM defense (reference memory_monitor.h + worker killing
        # policies): kill-and-retry the newest retriable running task
        # under host memory pressure.
        self.memory_monitor = None
        if config.memory_usage_threshold > 0:
            from ray_tpu_torch.core.memory_monitor import MemoryMonitor

            self.memory_monitor = MemoryMonitor(
                config.memory_usage_threshold,
                config.memory_monitor_refresh_s,
                on_high=self._on_memory_pressure).start()

        # Restore journaled cluster metadata (named actors, PGs, logical
        # nodes) BEFORE serving: a restarted head must know its actors
        # before their still-alive workers redial and re-announce
        # (reference: GCS restart from Redis, redis_store_client.h:33).
        # Drain bookkeeping: node_id -> object hexes whose migration to
        # a survivor arena is in flight (cleared by objects_migrated),
        # plus when the last migrate_objects batch was issued — a lost
        # report (node->head send failure) must not wedge the drain, so
        # pending entries older than the retry window re-issue
        # (completed objects answer "have" on the re-push: idempotent).
        self._drain_migrating: Dict[str, Set[str]] = {}
        self._drain_issued_at: Dict[str, float] = {}
        self._drain_retry_s = 120.0

        self._restored_actors: Set[str] = set()
        self._restore_from_journal()
        for nid in getattr(self, "_restored_drains", set()):
            node = self.nodes.get(nid)
            if node is not None:
                node.draining = True

        # O(1)-amortized node selection (RAY_TPU_NODE_INDEX=0 restores
        # the legacy full-scan policies, byte-for-byte).
        if _node_index_enabled():
            self._node_index = _NodeIndex(self)
            self._node_index.rebuild()

        # Scheduler observability (util/metrics.py): lease decisions and
        # task-event ingest volume export through the same /metrics
        # pipeline as user metrics.  frames vs events makes the delta
        # batching directly measurable (events ≫ frames under load).
        try:
            from ray_tpu_torch.util import metrics as _m

            self._m_lease_grants = _m.Counter(
                "ray_tpu_lease_grants_total",
                "Worker leases granted by the scheduler")
            self._m_lease_denials = _m.Counter(
                "ray_tpu_lease_denials_total",
                "Lease slots requested but not granted")
            self._m_lease_clamps = _m.Counter(
                "ray_tpu_lease_fair_share_clamps_total",
                "Lease requests clamped to the per-owner fair share")
            self._m_task_events = _m.Counter(
                "ray_tpu_task_events_total",
                "Task lifecycle events ingested from workers")
            self._m_task_event_frames = _m.Counter(
                "ray_tpu_task_event_frames_total",
                "task_events frames received (events arrive batched)")
            self._m_locality_hits = _m.Counter(
                "ray_tpu_locality_hits_total",
                "Tasks placed on a node already holding >=1 shm arg")
            self._m_stragglers = _m.Counter(
                "ray_tpu_stragglers_total",
                "RUNNING tasks flagged as stragglers by the watchdog")
            self._m_node_unhealthy = _m.Counter(
                "ray_tpu_node_unhealthy_total",
                "Nodes flagged unhealthy (stale heartbeat) by the "
                "watchdog")
            self._m_shard_ops = _m.Counter(
                "ray_tpu_sched_shard_ops_total",
                "Submissions accepted through the lock-free owner-"
                "keyed ingress shards")
        except Exception:
            self._m_lease_grants = self._m_lease_denials = None
            self._m_lease_clamps = None
            self._m_task_events = self._m_task_event_frames = None
            self._m_locality_hits = None
            self._m_stragglers = self._m_node_unhealthy = None
            self._m_shard_ops = None

        # Cluster span harvest state (collect_spans wire op): per-worker
        # ring cursors persist across harvests so each pull ships only
        # new spans, and harvested spans accumulate in a bounded,
        # trace_id-indexed store the dashboard queries.
        self._span_waiters: Dict[str, tuple] = {}  # token -> (Event, slot)
        self._span_cursors: Dict[str, int] = {}  # worker_hex -> cursor
        self._span_store: "deque" = deque(
            maxlen=_env_int("RAY_TPU_SPAN_STORE_MAX", 200000, 1000))
        self._span_seen: Set[str] = set()  # span ids in _span_store
        self._span_missed = 0  # ring evictions that beat the harvest
        self._span_lock = threading.Lock()
        self._harvest_lock = threading.Lock()  # one harvest at a time
        # Latest per-worker resource samples (profile_report deltas)
        # plus a bounded per-worker history ring so /api/profile and
        # the watchdog see distributions, not just the newest sample.
        self._profiles: Dict[str, dict] = {}
        self._profile_hist: Dict[str, "deque"] = {}
        self._profile_hist_cap = _env_int("RAY_TPU_PROFILE_HISTORY",
                                          120, 8)
        # Straggler/health watchdog: constructed ONLY when enabled, so
        # with RAY_TPU_WATCHDOG off the scheduler loop's gate is a
        # single `is not None` check — today's hot path byte-for-byte.
        self._watchdog = _Watchdog(self) if _watchdog_enabled() else None
        # Durable ops plane: rehydrate the span store and flight
        # recorder from the on-disk journal (util/journal.py) so a head
        # restart still serves yesterday's trace.  No-op when
        # RAY_TPU_OPS_JOURNAL_DIR is unset.
        self._rehydrate_ops_journal()

        self._wake = threading.Event()
        self._stopped = threading.Event()
        from ray_tpu_torch.core.wire_schema import validate as _wire_validate

        self.server = rpc.Server(self._handle, host=config.node_ip_address,
                                 port=config.control_port,
                                 on_disconnect=self._on_disconnect,
                                 json_validator=_wire_validate)
        self._sched_thread = threading.Thread(
            target=self._schedule_loop, name="scheduler", daemon=True
        )
        self._sched_thread.start()
        if self._restored_actors:
            timer = threading.Timer(config.head_restart_grace_s,
                                    self._reap_restored_actors)
            timer.daemon = True
            timer.start()

    # -- journal (reference: GCS table persistence via StoreClient) -----
    def _journal_put(self, key: str, value):
        if self.config.gcs_store_path:
            self.kv[f"__meta__/{key}"] = value

    def _journal_del(self, key: str):
        if self.config.gcs_store_path:
            self.kv.pop(f"__meta__/{key}", None)

    def _rehydrate_ops_journal(self):
        """Reload the span store and flight recorder from the durable
        ops journal after a head restart (kill -9 included: replay
        drops at most the one truncated tail record per stream).
        Replayed spans enter _span_seen, so the first post-restart
        harvest neither duplicates the store nor re-journals them."""
        from ray_tpu_torch.util import journal as ops_journal

        directory = ops_journal.journal_dir()
        if not directory:
            return
        try:
            envs = ops_journal.replay(
                directory, "spans",
                max_records=self._span_store.maxlen or 0)
        except Exception as e:
            warn_once(logger, "ops-rehydrate", e,
                      "span journal replay failed")
            envs = []
        restored = 0
        with self._span_lock:
            for env in envs:
                row = env.get("d")
                if not isinstance(row, list) or len(row) < 7:
                    continue
                sid = row[0]
                if sid in self._span_seen:
                    continue
                if len(self._span_store) == self._span_store.maxlen \
                        and self._span_store:
                    self._span_seen.discard(self._span_store[0][0])
                self._span_seen.add(sid)
                self._span_store.append(row)
                restored += 1
        from ray_tpu_torch.util import flight_recorder

        flight = flight_recorder.rehydrate()
        if restored or flight:
            logger.info("ops journal rehydrated: %d spans, %d flight "
                        "events (dir=%s)", restored, flight, directory)

    def _restore_from_journal(self):
        if not self.config.gcs_store_path:
            return
        if self.kv.get("__meta__/session_id") is None:
            self.kv["__meta__/session_id"] = self.session_id
            return
        # A previous head wrote this journal: restore cluster metadata.
        # Resource accounting for still-alive workers is rebuilt lazily
        # (they re-register unclaimed; transient over-subscription is
        # accepted, as in the reference's GCS-restart window).
        for key in list(self.kv):
            if key.startswith("__meta__/actor/"):
                spec = self.kv[key]
                actor_hex = spec.actor_id.hex()
                entry = ActorEntry(spec=spec, state=A_RESTARTING)
                self.actors[actor_hex] = entry
                if spec.name:
                    self.named_actors[(spec.namespace, spec.name)] = \
                        actor_hex
                self._restored_actors.add(actor_hex)
            elif key.startswith("__meta__/pg/"):
                d = self.kv[key]
                pg = PlacementGroupEntry(
                    pg_hex=key.rsplit("/", 1)[1],
                    strategy=d["strategy"],
                    bundle_specs=d["bundle_specs"],
                    name=d.get("name", ""),
                    ready_obj=d.get("ready_obj", ""))
                self.placement_groups[pg.pg_hex] = pg
                if pg.ready_obj:
                    # Re-reservation will seal it; a reconnecting
                    # driver's pg.ready() then resolves instead of
                    # hitting the restart-grace lost error.
                    self.objects.setdefault(pg.ready_obj,
                                            ObjectEntry(refcount=0))
            elif key.startswith("__meta__/drain/"):
                node_id = key.rsplit("/", 1)[1]
                self._drain_migrating.setdefault(node_id, set())
                self._restored_drains = getattr(
                    self, "_restored_drains", set())
                self._restored_drains.add(node_id)
            elif key.startswith("__meta__/node/"):
                d = self.kv[key]
                node_id = key.rsplit("/", 1)[1]
                res = ResourceSet(d["resources"])
                self.nodes[node_id] = NodeState(
                    node_id=node_id, total=res, available=res,
                    labels=d.get("labels") or {})

    def _reap_restored_actors(self):
        """Grace expired: restored actors whose worker never re-announced
        are respawned (restarts permitting) or declared dead."""
        with self.lock:
            for actor_hex in list(self._restored_actors):
                entry = self.actors.get(actor_hex)
                self._restored_actors.discard(actor_hex)
                if entry is None or entry.state != A_RESTARTING \
                        or entry.worker_hex:
                    continue
                spec = entry.spec
                if spec.restart_count < spec.max_restarts:
                    spec.restart_count += 1
                    self.pending_actors.append(spec)
                else:
                    entry.state = A_DEAD
                    entry.death_reason = \
                        "lost in head restart (no restarts left)"
                    self._push_actor_update(entry, actor_hex)
        self._wake.set()

    # ------------------------------------------------------------------
    @property
    def address(self) -> str:
        # Advertised (not bind) address: binding 0.0.0.0 must not hand
        # peers an unroutable wildcard.
        return f"{self.config.advertised_host()}:{self.server.port}"

    def stop(self):
        self._stopped.set()
        self._wake.set()
        if self._lease_timer is not None:
            self._lease_timer.cancel()
        if self.memory_monitor is not None:
            self.memory_monitor.stop()
        with self.lock:
            workers = list(self.workers.values())
            node_conns = [n.conn for n in self.nodes.values()
                          if n.conn is not None]
        for w in workers:
            if w.conn is not None and w.kind != "driver":
                try:
                    w.conn.push({"op": "exit"})
                except Exception:
                    pass
        for conn in node_conns:
            try:
                conn.push({"op": "exit"})
            except Exception:
                pass
        for client in getattr(self, "_node_clients", {}).values():
            try:
                client.close()
            except Exception:
                pass
        procs = [w.proc for w in workers if w.proc is not None]
        # Event-driven reap: block in each child's wait() against one
        # shared deadline instead of poll()+sleep spinning — the kernel
        # wakes us the instant a child exits.
        deadline = time.monotonic() + 1.0
        for p in procs:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                p.wait(max(remaining, 0.001))
            except Exception:  # raylint: allow-swallow(timeout or reaped elsewhere; stragglers escalate below)
                pass
        procs = [p for p in procs if p.poll() is None]
        for p in procs:  # stragglers: escalate
            try:
                p.kill()
            except OSError:
                pass
        self.server.stop()
        # Close the KV journal only after the server stops accepting ops
        # (an in-flight kv_put must not hit a closed file).
        try:
            self.kv.close()
        except Exception:
            pass
        self.store.cleanup()

    # ------------------------------------------------------------------
    # RPC dispatch
    def _handle(self, conn: rpc.Connection, msg: dict):
        op = msg["op"]
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise ValueError(f"unknown control op: {op}")
        return fn(conn, msg)

    def _on_disconnect(self, conn: rpc.Connection):
        # Stale-connection fencing: with client reconnection, a dropped
        # OLD socket must not kill an entity that has already re-bound a
        # NEW one (reference: GCS ignores failure reports from
        # superseded raylet connections).
        if conn.meta.get("cpp_worker"):
            self._cleanup_cpp_worker(conn)
        node_id = conn.meta.get("node_id")
        if node_id is not None:
            with self.lock:
                node = self.nodes.get(node_id)
                if node is None or node.conn is not conn:
                    return
            self._handle_node_death(node_id)
            return
        worker_hex = conn.meta.get("worker_hex")
        if worker_hex is None:
            return
        with self.lock:
            w = self.workers.get(worker_hex)
            if w is None or w.state == "dead" or w.conn is not conn:
                return
            self._mark_worker_dead(w, "connection lost")
        self._wake.set()
        self._sweep_store()

    def _handle_node_death(self, node_id: str):
        """A node manager's connection dropped: the host (and its arena)
        is gone.  Counterpart of GCS node-failure handling
        (gcs_node_manager.cc OnNodeFailure): fail/retry its workers'
        work, tear down its PG bundles, and recover or error every object
        whose only copy lived in its arena (lineage reconstruction,
        object_recovery_manager.h)."""
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return
            node.alive = False
            node.available = ResourceSet()
            node.conn = None
            self._index_touch(node_id)
            self._drop_drain_state_locked(node_id)
            for w in list(self.workers.values()):
                if w.node_id == node_id and w.state != "dead":
                    self._mark_worker_dead(w, f"node {node_id} died")
            for pg in self.placement_groups.values():
                if pg.state == "CREATED" and any(
                        b.node_id == node_id for b in pg.bundles):
                    self._teardown_pg(pg, reason=f"node {node_id} died")
            # Objects whose shm copy lived on the dead node: reconstruct
            # from lineage or materialize ObjectLostError.
            for obj_hex, entry in list(self.objects.items()):
                if entry.node_id != node_id or not entry.in_shm \
                        or entry.state != READY:
                    continue
                entry.in_shm = False
                if not self._try_reconstruct_locked(obj_hex):
                    self._store_lost_error_locked(
                        obj_hex, f"node {node_id} holding the only copy "
                        "died and lineage reconstruction was not possible")
        self._wake.set()

    def _sweep_store(self):
        """Drop shm-arena pins held by dead processes so their blocks can be
        reclaimed (plasma's client-disconnect accounting)."""
        with self.lock:
            alive = [w.pid for w in self.workers.values()
                     if w.state != "dead" and w.pid]
        alive.append(os.getpid())
        try:
            self.store.sweep(alive)
        except Exception as exc:
            # A failing sweep leaks dead workers' arena pins until the
            # store fills — keep it best-effort but never silent.
            warn_once(logger, "store-sweep", exc,
                      "shm-store sweep failed (dead-process pins leak)")

    def _mark_worker_dead(self, w: WorkerInfo, reason: str):
        """Called with lock held. Fail/retry its task, kill/restart its actor."""
        was_leased_to = w.leased_to if w.state == "leased" else ""
        w.state = "dead"
        w.conn = None
        w.leased_to = ""
        self._release(w)
        if was_leased_to:
            # Tell the lease holder so it fails over the in-flight
            # specs it owns (the head never saw them).
            owner = self.workers.get(was_leased_to)
            if owner is not None and owner.conn is not None:
                try:
                    owner.conn.push({"op": "lease_revoked",
                                     "worker": w.worker_hex,
                                     "reason": reason})
                except Exception as exc:
                    # The owner never learns its leased worker died; its
                    # in-flight specs stall until lease timeout — log so
                    # the stall has a visible cause.
                    warn_once(logger, "lease-revoke-push", exc,
                              "could not notify %s of dead leased "
                              "worker %s", was_leased_to, w.worker_hex)
        # Leases this worker HELD as an owner die with it.
        for x in self.workers.values():
            if x.state == "leased" and x.leased_to == w.worker_hex:
                self._release(x)
                x.state = "idle"
                x.leased_to = ""
        if self.pending_leases:
            self.pending_leases.reset(
                [pl for pl in self.pending_leases
                 if pl["owner"] != w.worker_hex])
        if w.current_task:
            rec = self.tasks.get(w.current_task)
            if rec is not None and rec.state == "RUNNING":
                spec = rec.spec
                if spec.direct and not spec.return_ids:
                    # Skeletal event-mirror of a lease-path task —
                    # retry/failure is the OWNER's job (lease_revoked
                    # push above); never requeue the arg-less mirror.
                    # Full direct specs (lineage-shipped, re-dispatched
                    # by reconstruction) take the normal retry path.
                    rec.state = "FAILED"
                elif spec.retry_count < spec.max_retries:
                    spec.retry_count += 1
                    rec.state = "PENDING"
                    rec.worker_hex = ""
                    self.pending_tasks.append(spec)
                else:
                    rec.state = "FAILED"
                    self._fail_task_returns_with(
                        spec, f"worker died: {reason}")
            w.current_task = None
        if w.actor_hex:
            entry = self.actors.get(w.actor_hex)
            if entry is not None and entry.state not in (A_DEAD,):
                spec = entry.spec
                # Tasks already delivered to the dead process are lost either
                # way; fail their return objects so callers' gets raise
                # instead of hanging.
                will_restart = spec.restart_count < spec.max_restarts
                if not (will_restart
                        and getattr(spec, "max_task_retries", 0) > 0):
                    self._fail_actor_inflight(w.actor_hex, reason)
                # else: the OWNER arbitrates in-flight calls across the
                # restart (runtime max_task_retries): retried calls'
                # results — and non-retried calls' errors — flow back
                # through the owner's promoted-object forwarding, so
                # the head writing ActorDiedError here would make one
                # ref read as an error remotely while the owner's
                # retry succeeds locally.  The entries stay queued; a
                # later DEAD transition fails whatever remains.
                if will_restart:
                    spec.restart_count += 1
                    entry.state = A_RESTARTING
                    entry.worker_hex = ""
                    entry.address = ""
                    self._push_actor_update(entry, w.actor_hex)
                    self.pending_actors.append(spec)
                else:
                    entry.state = A_DEAD
                    entry.death_reason = reason
                    self._push_actor_update(entry, w.actor_hex)

    def _fail_actor_inflight(self, actor_hex: str, reason: str):
        """Lock held. Store ActorDiedError into every unfinished return
        object of tasks already sent to this actor."""
        from ray_tpu_torch.core.exceptions import ActorDiedError
        from ray_tpu_torch.core.serialization import serialize

        pending = self.actor_inflight.pop(actor_hex, None)
        if not pending:
            return
        data = serialize(
            ActorDiedError(actor_hex, f"worker died: {reason}")).to_bytes()
        for obj_hex in list(pending):
            self.obj_actor.pop(obj_hex, None)
            entry = self.objects.get(obj_hex)
            if entry is None or entry.state == PENDING:
                self._store_object_locked(
                    obj_hex, inline=data, size=len(data), is_error=True)

    # ------------------------------------------------------------------
    # Registration
    def _op_register(self, conn, msg):
        worker_hex = msg["worker_hex"]
        with self.lock:
            w = self.workers.get(worker_hex)
            if w is None:
                # Unknown worker: either a driver, or a worker surviving
                # a head restart re-registering (it reports its node).
                w = WorkerInfo(worker_hex=worker_hex,
                               node_id=msg.get("node_id") or "head")
                self.workers[worker_hex] = w
            w.conn = conn
            w.pid = msg.get("pid", 0)
            w.address = msg.get("address", "")
            w.kind = msg.get("kind", w.kind or "pool")
            w.env_key = msg.get("env_key", w.env_key)
            conn.meta["worker_hex"] = worker_hex
            # Pool workers stay "starting" until they send worker_online
            # (hooks installed); dispatching earlier races task delivery.
            if w.kind == "driver":
                w.state = "driver"
                w.node_id = w.node_id or "head"
            # The client attaches ITS node's arena; logical nodes (and
            # the head) share the head arena.
            node = self.nodes.get(w.node_id)
            if node is not None and node.store_key:
                shm_dir = node.shm_dir or self.config.shm_dir
                store_key, store_node = node.store_key, node.node_id
            else:
                shm_dir = self.config.shm_dir
                store_key, store_node = self.session_id, "head"
        self._wake.set()
        return {
            "session_id": self.session_id,
            "shm_dir": shm_dir,
            "store_key": store_key,
            "store_node": store_node,
            "session_dir": self.session_dir,
            "runtime": HEAD_RUNTIME,
        }

    def _op_node_stats(self, conn, msg):
        """Periodic host-stats report from a node manager's reporter
        thread (dashboard/reporter.py)."""
        with self.lock:
            for n in self.nodes.values():
                if n.conn is conn:
                    n.stats = msg.get("stats") or {}
                    n.stats_at = time.time()  # watchdog heartbeat
                    return

    def _op_register_node(self, conn, msg):
        """A node manager joins the cluster (reference raylet → GCS
        RegisterNode, gcs_service.proto NodeInfoGcsService)."""
        node_id = msg.get("node_id") or ""
        res = ResourceSet(msg["resources"])
        with self.lock:
            if not node_id:
                i = len(self.nodes)
                while f"node-{i}" in self.nodes:
                    i += 1
                node_id = f"node-{i}"
            existing = self.nodes.get(node_id)
            if existing is not None and existing.alive \
                    and existing.conn is not None:
                raise ValueError(f"node {node_id} already exists")
            # Dead (or restart-orphaned) node ids may be revived: the
            # manager reconnecting after a head restart keeps its
            # identity, arena and workers.
            self.nodes[node_id] = NodeState(
                node_id=node_id, total=res, available=res,
                labels=msg.get("labels") or {},
                address=msg.get("address", ""), conn=conn,
                store_key=msg.get("store_key", ""),
                shm_dir=msg.get("shm_dir", ""))
            self._index_touch(node_id)
            conn.meta["node_id"] = node_id
        # Force a view broadcast so the (re)joining manager gets the
        # current resource view even when nothing else changed.
        self._view_last = None
        self._wake.set()
        return {"node_id": node_id, "session_id": self.session_id,
                "namespace": self.namespace}

    def _op_worker_spawn_failed(self, conn, msg):
        """A node manager could not start a requested worker process."""
        with self.lock:
            w = self.workers.get(msg.get("worker_hex", ""))
            if w is not None and w.state != "dead":
                self._mark_worker_dead(
                    w, f"spawn failed: {msg.get('error', 'unknown')}")
        self._wake.set()

    # ------------------------------------------------------------------
    # Objects
    def _store_object_locked(self, obj_hex: str, *, inline, size, is_error,
                             in_shm: bool = False, node_id: str = "head"):
        entry = self.objects.get(obj_hex)
        if entry is None:
            entry = self.objects[obj_hex] = ObjectEntry()
        entry.state = ERRORED if is_error else READY
        entry.inline = inline
        entry.size = size
        entry.in_shm = in_shm
        entry.node_id = node_id if in_shm else "head"
        entry.is_error = is_error
        entry.stored_at = time.time()
        # Wake fetch-path waiters parked in _await_object_settled (the
        # condition shares self.lock, which is held here).
        self._obj_settled.notify_all()
        actor_hex = self.obj_actor.pop(obj_hex, None)
        if actor_hex is not None:
            self.actor_inflight.get(actor_hex, set()).discard(obj_hex)
        subs, entry.subscribers = entry.subscribers, []
        push = self._object_ready_msg(obj_hex, entry)
        for c in subs:
            try:
                c.push(push)
            except Exception as exc:
                # A lost object_ready leaves that subscriber's get()
                # blocked until timeout — worth a (rate-limited) trace.
                warn_once(logger, "object-ready-push", exc,
                          "could not push object_ready for %s to a "
                          "subscriber", obj_hex)
        # A dropped generator's free may have arrived before this EOS
        # put: apply it now that the stream is provably finished.
        frees = getattr(self, "_pending_stream_frees", None)
        if frees:
            parked = frees.pop(obj_hex, None)
            if parked is not None:
                threading.Thread(
                    target=self._op_free_stream, args=(None, parked),
                    name="stream-free", daemon=True).start()

    def _object_ready_msg(self, obj_hex, entry):
        # Location info lets clients on OTHER nodes pull the bytes from
        # the holding node's manager ("addr"); addr == "" means the copy
        # is in the head arena (fetch rides the control connection).
        addr = ""
        if entry.in_shm and entry.node_id != "head":
            node = self.nodes.get(entry.node_id)
            addr = node.address if node is not None else ""
        return {
            "op": "object_ready",
            "obj": obj_hex,
            "size": entry.size,
            "inline": entry.inline,
            "in_shm": entry.in_shm,
            "is_error": entry.is_error,
            "node": entry.node_id,
            "addr": addr,
        }

    def _store_node_for(self, conn) -> str:
        """Lock held. Which node's arena a connection's shm puts land in."""
        worker_hex = conn.meta.get("worker_hex")
        w = self.workers.get(worker_hex) if worker_hex else None
        if w is None:
            return "head"
        node = self.nodes.get(w.node_id)
        return node.node_id if node is not None and node.store_key \
            else "head"

    def _op_put_object_batch(self, conn, msg):
        """A run of consecutive puts from one owner, registered under ONE
        lock hold with one spill check and at most one scheduler wake
        (the put-heavy loops in ray_perf made per-put head work the
        dominant cost)."""
        any_shm = False
        with self.lock:
            for item in msg["items"]:
                self._put_object_locked(conn, item)
                any_shm = any_shm or bool(item.get("in_shm"))
        if any_shm:
            self._maybe_spill()
        if self.pending_tasks or self.pending_leases \
                or self._ingress_pending():
            self._wake.set()

    def _op_put_object(self, conn, msg):
        with self.lock:
            self._put_object_locked(conn, msg)
        if msg.get("in_shm"):
            # Outside the lock: spilling does storage I/O that must not
            # stall the control plane.
            self._maybe_spill()
        # Wake the scheduler only when something could be waiting on the
        # arrival (a put with no queued work has nothing to unblock; the
        # loop's timeout covers stragglers).
        if self.pending_tasks or self.pending_leases \
                or self._ingress_pending():
            self._wake.set()

    def _put_object_locked(self, conn, msg):
        """Lock held (both callers)."""
        spec = msg.get("lineage")
        if spec is not None:
            # Owner-side lineage shipped with the object (lease-path
            # tasks whose oversized result lands in shm: the head
            # never saw the spec, but must be able to re-execute it
            # if the copy is lost — reference: owner-held lineage,
            # task_manager.h:208).
            task_hex = spec.task_id.hex()
            existing = self.tasks.get(task_hex)
            if existing is None or not existing.spec.return_ids:
                # Replace the skeletal event-mirror record (if any):
                # only the full spec can be re-executed.
                self.tasks[task_hex] = TaskRecord(
                    spec=spec, state="FINISHED",
                    submitted_at=time.time(),
                    finished_at=time.time())
            self.lineage[msg["obj"]] = task_hex
        self._store_object_locked(
            msg["obj"],
            inline=msg.get("inline"),
            size=msg["size"],
            is_error=msg.get("is_error", False),
            in_shm=msg.get("in_shm", False),
            node_id=self._store_node_for(conn),
        )

    # -- spilling ------------------------------------------------------
    def _maybe_spill(self):
        """Spill oldest cold shm objects until under the threshold
        (reference LocalObjectManager::SpillObjectsOfSize). Candidate
        snapshot under the lock; reads/uploads outside it; per-object
        finalize re-checks the entry (it may have been freed/raced)."""
        thresh = self.config.object_spilling_threshold
        cap, used, _, _ = self.store.stats()
        if thresh <= 0 or cap <= 0 or used <= thresh * cap:
            return
        target = int(thresh * cap * 0.9)  # hysteresis below the threshold
        with self.lock:
            now = time.time()
            candidates = sorted(
                ((h, e.size, e.stored_at)
                 for h, e in self.objects.items()
                 if e.state == READY and e.in_shm
                 and e.node_id == "head"  # only the head reads its arena
                 and e.spilled_uri is None and not e.restoring
                 and now - e.stored_at >= self.config.spill_min_age_s),
                key=lambda t: t[2])
        for obj_hex, size, _ in candidates:
            if used <= target:
                break
            oid = ObjectID.from_hex(obj_hex)
            try:
                seg = self.store.attach(oid, size)
                data = bytes(seg.buf[:size])
                self.store.release(oid)
                # Unique key per spill ATTEMPT: concurrent spillers of the
                # same object must not share a URI, or the loser's stale
                # cleanup would unlink the winner's (only) copy.
                uri = self.external_storage.spill(
                    f"{obj_hex}-{uuid.uuid4().hex[:8]}", data)
            except Exception as exc:
                # Spill failures loop forever against a full arena; the
                # operator needs to see WHY eviction is making no room.
                warn_once(logger, "spill", exc,
                          "could not spill object %s (arena stays full)",
                          obj_hex)
                continue
            with self.lock:
                entry = self.objects.get(obj_hex)
                if entry is None or not entry.in_shm \
                        or entry.state != READY or entry.restoring:
                    stale = True  # freed or changed while we spilled
                else:
                    stale = False
                    entry.in_shm = False
                    entry.spilled_uri = uri
                    self.spilled_bytes_total += size
            if stale:
                try:
                    self.external_storage.delete(uri)
                except Exception as exc:
                    warn_once(logger, "spill-cleanup", exc,
                              "could not delete stale spill %s "
                              "(external storage leaks)", uri)
                continue
            # Readers that attached before this keep valid views (the
            # arena orphans pinned blocks); late readers restore.
            self.store.delete(oid)
            used -= size

    def _restore_and_publish(self, obj_hex: str):
        """Background restore of a spilled object: storage I/O happens
        off the control-plane lock; subscribers get the ready push (or a
        serialized error) when it lands."""
        with self.lock:
            entry = self.objects.get(obj_hex)
            if entry is None or entry.spilled_uri is None \
                    or entry.restoring:
                return
            entry.restoring = True
            uri = entry.spilled_uri
        data, err = None, None
        try:
            data = self.external_storage.restore(uri)
        except Exception as e:  # noqa: BLE001
            err = e
        if data is not None:
            try:
                oid = ObjectID.from_hex(obj_hex)
                seg = self.store.create(oid, len(data))
                seg.buf[:len(data)] = data
                self.store.seal(oid)
            except Exception as e:  # noqa: BLE001
                err, data = e, None
        with self.lock:
            entry = self.objects.get(obj_hex)
            if entry is None:
                return
            entry.restoring = False
            self._obj_settled.notify_all()
            if data is None:
                # The spilled copy is gone: fall back to lineage
                # reconstruction; queued subscribers stay on the entry and
                # resolve when the re-executed task stores the value.
                entry.spilled_uri = None
                if not self._try_reconstruct_locked(obj_hex):
                    # Store a REAL serialized error (not just a push):
                    # current waiters raise it now and later gets see the
                    # same ObjectLostError instead of a payload-less READY.
                    self._store_lost_error_locked(
                        obj_hex, f"restore of spilled copy failed ({err}) "
                        "and lineage reconstruction was not possible")
                return
            subs, entry.subscribers = entry.subscribers, []
            entry.spilled_uri = None
            entry.in_shm = True
            entry.node_id = "head"  # restored into the head arena
            entry.stored_at = time.time()
            push = self._object_ready_msg(obj_hex, entry)
        for c in subs:
            try:
                c.push(push)
            except Exception:
                pass
        if data is not None:
            try:
                self.external_storage.delete(uri)
            except Exception:
                pass

    # -- lineage reconstruction ----------------------------------------
    def _shm_value_lost(self, obj_hex: str, entry: ObjectEntry) -> bool:
        """Lock held. True for a READY shm-backed object whose arena
        segment is gone with no spilled copy: the value itself is lost."""
        if not (entry.state == READY and entry.in_shm
                and entry.inline is None and entry.spilled_uri is None
                and not entry.restoring):
            return False
        if entry.node_id != "head":
            # Remote-node arena: the head can't probe it; the copy is
            # lost exactly when its node is (node death already triggers
            # reconstruction eagerly in _handle_node_death).
            node = self.nodes.get(entry.node_id)
            return node is None or not node.alive
        return not self.store.contains(ObjectID.from_hex(obj_hex))

    def _try_reconstruct_locked(self, obj_hex: str) -> bool:
        """Lock held. Re-execute the task that produced a lost object
        (reference ObjectRecoveryManager::RecoverObject,
        core_worker/object_recovery_manager.h, + TaskManager lineage
        resubmission, task_manager.h:208), recursively re-creating lost
        dependencies first. Plans the full dependency tree before
        mutating anything, so an unrecoverable dep deep in the chain
        can't leave earlier deps pointlessly re-executing.

        Returns True when the entry has been reset to PENDING and its
        producing task queued (or already in flight); subscribers then
        resolve through the normal object_ready push when the
        re-execution stores the value."""
        plan: List[tuple] = []  # (obj_hex, task_hex, resubmit)
        if not self._plan_reconstruct_locked(obj_hex, plan, set()):
            return False
        requeued: Set[str] = set()
        for o_hex, task_hex, resubmit in plan:
            entry = self.objects.get(o_hex)
            if entry is None:
                entry = self.objects[o_hex] = ObjectEntry(
                    refcount=0, producing_task=task_hex)
            entry.reconstructions += 1
            entry.state = PENDING
            entry.inline = None
            entry.in_shm = False
            entry.spilled_uri = None
            entry.is_error = False
            if resubmit and task_hex not in requeued:
                requeued.add(task_hex)
                rec = self.tasks[task_hex]
                spec = rec.spec
                # Completing the re-run decrefs the task's borrows again
                # (worker.py batches decrefs into task_done);
                # pre-compensate so the double decref can't free
                # arguments early.
                for b in spec.borrows:
                    dep = self.objects.get(b)
                    if dep is not None:
                        dep.refcount += 1
                spec.retry_count = 0
                rec.state = "PENDING"
                rec.worker_hex = ""
                self.pending_tasks.append(spec)
        if requeued:
            self._wake.set()
        return True

    def _plan_reconstruct_locked(self, obj_hex: str, plan: List[tuple],
                                 seen: Set[str]) -> bool:
        """Lock held. Validate that obj_hex (and every lost dependency
        under it) is recoverable, appending (obj, task, resubmit) steps
        to ``plan`` in dependency-first order. No mutation."""
        if not self.config.enable_object_reconstruction:
            return False
        if obj_hex in seen:
            # Already planned along another path (duplicate arg /
            # diamond dependency). Object IDs form a DAG, so a revisit
            # can't be a cycle; a node that failed validation aborts the
            # whole plan before any revisit could happen.
            return True
        seen.add(obj_hex)
        task_hex = self.lineage.get(obj_hex)
        rec = self.tasks.get(task_hex) if task_hex else None
        if rec is None:
            return False
        spec = rec.spec
        # Actor-method results depend on actor state and streaming items
        # on consumed generators; neither re-executes deterministically
        # (the reference likewise only reconstructs normal task returns).
        if spec.actor_id is not None or spec.is_streaming:
            return False
        entry = self.objects.get(obj_hex)
        if entry is not None and entry.reconstructions >= \
                self.config.object_reconstruction_max_attempts:
            return False
        resubmit = rec.state not in ("PENDING", "RUNNING")
        if resubmit:
            # Lost dependencies must be re-created first; the scheduler
            # then holds this task until they are READY (_deps_ready).
            for arg in spec.args:
                if not arg.is_ref:
                    continue
                dep = self.objects.get(arg.object_hex)
                if dep is None or self._shm_value_lost(arg.object_hex,
                                                       dep):
                    if not self._plan_reconstruct_locked(
                            arg.object_hex, plan, seen):
                        return False
        plan.append((obj_hex, task_hex, resubmit))
        return True

    def _store_lost_error_locked(self, obj_hex: str, why: str):
        """Lock held. Store + publish a serialized ObjectLostError as the
        object's value so pending and future gets raise it."""
        from ray_tpu_torch.core.serialization import serialize

        payload = serialize(ObjectLostError(
            f"object {obj_hex} is lost: {why}")).to_bytes()
        self._store_object_locked(
            obj_hex, inline=payload, size=len(payload), is_error=True)

    def _prune_lineage_locked(self):
        """Lock held. Evict the oldest finished task records (and their
        return objects' lineage links) past the retention cap, bounding
        control-plane memory on long-running drivers (reference: lineage
        eviction under max_lineage_bytes + GcsTaskManager's
        task_events_max_num_task_in_gcs cap)."""
        cap = self.config.max_lineage_entries
        if cap <= 0 or len(self.tasks) <= cap:
            return
        target = (cap * 3) // 4
        drop = []
        excess = len(self.tasks) - target
        for task_hex, rec in self.tasks.items():
            if len(drop) >= excess:
                break
            if rec.state in ("FINISHED", "FAILED"):
                drop.append(task_hex)
        for task_hex in drop:
            rec = self.tasks.pop(task_hex)
            for oid in rec.spec.return_ids:
                self.lineage.pop(oid.hex(), None)

    # -- OOM defense ---------------------------------------------------
    def _on_memory_pressure(self, fraction: float):
        from ray_tpu_torch.core.memory_monitor import pick_worker_to_kill

        # Cooldown: give the previous kill's reclaim time to land before
        # considering another, or a single spike cascades through the
        # whole pool.
        now = time.time()
        if now - getattr(self, "_last_oom_kill", 0.0) \
                < self.config.oom_kill_cooldown_s:
            return
        with self.lock:
            candidates = []
            for w in self.workers.values():
                # "leased" workers' running tasks are known via their
                # batched RUNNING events (_op_task_events).
                if w.state not in ("busy", "leased") or not w.current_task:
                    continue
                if w.proc is None:
                    # Remote-node worker: its pid belongs to another host
                    # (killing it locally would hit an unrelated process),
                    # and the pressure being relieved is THIS host's.
                    continue
                rec = self.tasks.get(w.current_task)
                if rec is None:
                    continue
                candidates.append({
                    "worker": w,
                    "retriable":
                        rec.spec.retry_count < rec.spec.max_retries,
                    "started_at": rec.started_at,
                })
            pick = pick_worker_to_kill(
                candidates,
                allow_nonretriable=(
                    fraction
                    >= self.config.memory_usage_threshold_critical))
        if pick is None:
            return
        self._last_oom_kill = now
        w = pick["worker"]
        try:
            os.kill(w.pid, 9)  # _mark_worker_dead retries the task
        except (ProcessLookupError, PermissionError):
            pass

    def _op_subscribe_objects(self, conn, msg):
        """Batched subscribe (one message for a whole get())."""
        for obj_hex in msg["objs"]:
            self._op_subscribe_object(
                conn, {"obj": obj_hex, "grace": msg.get("grace", False)})

    def _schedule_object_grace(self, obj_hex: str):
        """A post-restart re-subscribe referenced an object this head
        doesn't know.  Its producer may still be running (result lands
        via task_done puts) — give it a grace window, then fail the
        object so gets surface an error instead of hanging (the
        'resubmitted or surfaced as errors' half of restart FT).
        Lock held.  ONE shared timer sweeps the whole graced set — a
        big fan-out's re-subscribe batch must not spawn a thread per
        object."""
        graced = getattr(self, "_graced_objects", None)
        if graced is None:
            graced = self._graced_objects = set()
        graced.add(obj_hex)
        timer = getattr(self, "_grace_timer", None)
        if timer is None or not timer.is_alive():
            timer = threading.Timer(self.config.head_restart_grace_s,
                                    self._expire_graced_objects)
            timer.daemon = True
            self._grace_timer = timer
            timer.start()

    def _expire_graced_objects(self):
        with self.lock:
            graced = getattr(self, "_graced_objects", set())
            self._graced_objects = set()
            for obj_hex in graced:
                entry = self.objects.get(obj_hex)
                if entry is not None and entry.state == PENDING:
                    self._store_lost_error_locked(
                        obj_hex, "lost in head restart (no producer "
                        "re-reported it within the grace window)")

    def _op_subscribe_object(self, conn, msg):
        obj_hex = msg["obj"]
        with self.lock:
            entry = self._object_entry_or_drain_locked(obj_hex)
            if entry is None:
                entry = self.objects[obj_hex] = ObjectEntry(refcount=0)
                if msg.get("grace"):
                    self._schedule_object_grace(obj_hex)
            if entry.state in (READY, ERRORED):
                if entry.spilled_uri is not None or entry.restoring:
                    # Spilled: queue the subscriber and restore in the
                    # background (storage I/O must not hold self.lock).
                    # An in-flight restore publishes to the whole queue,
                    # so only the first subscriber spawns the thread.
                    entry.subscribers.append(conn)
                    if not entry.restoring:
                        threading.Thread(
                            target=self._restore_and_publish,
                            args=(obj_hex,), daemon=True,
                            name=f"restore-{obj_hex[:8]}").start()
                elif self._shm_value_lost(obj_hex, entry):
                    # Only copy vanished from the arena (swept orphan,
                    # external deletion): reconstruct from lineage; the
                    # subscriber resolves when the re-run stores it.
                    entry.subscribers.append(conn)
                    if not self._try_reconstruct_locked(obj_hex):
                        self._store_lost_error_locked(
                            obj_hex, "shm copy gone and lineage "
                            "reconstruction not possible")
                else:
                    conn.push(self._object_ready_msg(obj_hex, entry))
            else:
                entry.subscribers.append(conn)

    def _op_object_info(self, conn, msg):
        """Synchronous location/size lookup for a READY object (the
        push-broadcast path, core/object_plane.py, needs size +
        shm-residency without a subscription round trip)."""
        with self.lock:
            entry = self.objects.get(msg["obj"])
            if entry is None or entry.state != READY:
                return None
            info = self._object_ready_msg(msg["obj"], entry)
        info.pop("op", None)
        return info

    def _op_forget_object(self, conn, msg):
        """Drop a speculative PENDING entry created by a subscribe that
        will never resolve (stream item probes past the final index)."""
        with self.lock:
            entry = self.objects.get(msg["obj"])
            if entry is None:
                return
            entry.subscribers = [c for c in entry.subscribers
                                 if c is not conn]
            if entry.state == PENDING and entry.refcount <= 0 \
                    and not entry.subscribers \
                    and entry.producing_task is None:
                del self.objects[msg["obj"]]

    def _op_incref(self, conn, msg):
        with self.lock:
            entry = self._object_entry_or_drain_locked(msg["obj"])
            if entry is not None:
                entry.refcount += msg.get("n", 1)

    def _op_incref_batch(self, conn, msg):
        with self.lock:
            for obj_hex in msg["objs"]:
                entry = self._object_entry_or_drain_locked(obj_hex)
                if entry is not None:
                    entry.refcount += 1

    def _op_decref_batch(self, conn, msg):
        for obj_hex in msg["objs"]:
            self._op_decref(conn, {"obj": obj_hex})

    def _op_refcount_delta(self, conn, msg):
        """Net per-object ref-count deltas, coalesced client-side from
        an adjacent incref/decref run (runtime._head_frames): positive
        entries are plain increfs, negative ones go through the decref
        path so free-on-zero (shm/spill cleanup) still fires."""
        decrefs = []
        with self.lock:
            for obj_hex, d in msg["deltas"].items():
                d = int(d)
                if d > 0:
                    entry = self._object_entry_or_drain_locked(obj_hex)
                    if entry is not None:
                        entry.refcount += d
                elif d < 0:
                    decrefs.append((obj_hex, -d))
        for obj_hex, n in decrefs:
            self._op_decref(conn, {"obj": obj_hex, "n": n})

    def _op_decref(self, conn, msg):
        to_delete = []
        with self.lock:
            obj_hex = msg["obj"]
            entry = self._object_entry_or_drain_locked(obj_hex)
            if entry is None:
                return
            entry.refcount -= msg.get("n", 1)
            if entry.refcount <= 0 and entry.state in (READY, ERRORED):
                del self.objects[obj_hex]
                if entry.in_shm:
                    for loc in {entry.node_id, *entry.replicas}:
                        to_delete.append((obj_hex, loc))
                if entry.spilled_uri:
                    try:
                        self.external_storage.delete(entry.spilled_uri)
                    except Exception as exc:
                        warn_once(logger, "spill-cleanup", exc,
                                  "could not delete spill %s for freed "
                                  "object (external storage leaks)",
                                  entry.spilled_uri)
        for obj_hex, node_loc in to_delete:
            self._delete_shm_copy(obj_hex, node_loc)

    def _delete_shm_copy(self, obj_hex: str, node_loc: str):
        """Free an object's arena copy wherever it lives: the head's
        store directly, or a delete push to the holding node's manager
        (remote arenas would otherwise fill with freed garbage)."""
        if node_loc == "head":
            self.store.delete(ObjectID.from_hex(obj_hex))
            return
        with self.lock:
            cached = getattr(self, "_proxy_cache", None)
            if cached is not None and cached[0] == obj_hex:
                self._proxy_cache = None
            node = self.nodes.get(node_loc)
            conn = node.conn if node is not None and node.alive else None
        if conn is not None:
            try:
                conn.push({"op": "delete_object", "obj": obj_hex})
            except Exception as exc:
                # The remote arena keeps the freed copy until that node
                # restarts — a slow remote leak worth one warning.
                warn_once(logger, "delete-push", exc,
                          "could not push delete_object %s to node %s",
                          obj_hex, node_loc)

    def _op_object_replica(self, conn, msg):
        """A client cached a pulled copy in its node's arena: record the
        location so freeing the object deletes every copy."""
        with self.lock:
            entry = self.objects.get(msg["obj"])
            if entry is None:
                return
            node = self._store_node_for(conn)
            entry.pulling.pop(node, None)  # in-flight pull landed
            if node != entry.node_id:
                entry.replicas.add(node)

    def _op_object_pull_started(self, conn, msg):
        """One-way announce from a PullManager leader: this node is
        pulling the object.  The locality tie-break credits in-flight
        destinations too so a task chasing the
        object lands where it is about to be, instead of triggering a
        second transfer.  Entries are timestamps — _locality_bytes
        ignores announcements older than the pull timeout (the pull
        failed or the announce outlived its object)."""
        with self.lock:
            entry = self.objects.get(msg["obj"])
            if entry is None:
                return
            node = self._store_node_for(conn)
            if node != entry.node_id and node not in entry.replicas:
                entry.pulling[node] = time.time()

    def _op_register_objects(self, conn, msg):
        """Pre-register return objects of direct (actor) tasks with one ref
        held by the submitter, mirroring TaskManager::AddPendingTask return
        registration (reference core_worker.cc:2231).  When tied to an
        actor, track them so actor death fails outstanding callers."""
        actor_hex = msg.get("actor")
        with self.lock:
            for obj_hex in msg["objs"]:
                self.objects.setdefault(obj_hex, ObjectEntry())
                if actor_hex:
                    self.actor_inflight.setdefault(
                        actor_hex, set()).add(obj_hex)
                    self.obj_actor[obj_hex] = actor_hex

    def _op_free_objects(self, conn, msg):
        to_delete = []
        with self.lock:
            for obj_hex in msg["objs"]:
                # Explicit free forfeits reconstruction (the reference
                # likewise deletes lineage on ray.internal.free).
                self.lineage.pop(obj_hex, None)
                entry = self.objects.pop(obj_hex, None)
                if entry is not None and entry.in_shm:
                    for loc in {entry.node_id, *entry.replicas}:
                        to_delete.append((obj_hex, loc))
                if entry is not None and entry.spilled_uri:
                    try:
                        self.external_storage.delete(entry.spilled_uri)
                    except Exception:
                        pass
        for obj_hex, node_loc in to_delete:
            self._delete_shm_copy(obj_hex, node_loc)

    # ------------------------------------------------------------------
    # Functions (counterpart of _private/function_manager.py export tables)
    def _op_put_func(self, conn, msg):
        with self.lock:
            self.funcs.setdefault(msg["func_id"], msg["blob"])
            # Persistent-KV mode also journals the blob so named
            # functions remain invokable after a head restart.
            if self.config.gcs_store_path:
                key = f"__fn_blob__/{msg['func_id']}"
                if key not in self.kv:
                    self.kv[key] = msg["blob"]

    def _op_get_func(self, conn, msg):
        with self.lock:
            blob = self.funcs.get(msg["func_id"])
            if blob is None:
                blob = self.kv.get(f"__fn_blob__/{msg['func_id']}")
            return blob

    # ------------------------------------------------------------------
    # KV store (reference: gcs_kv_manager / experimental/internal_kv.py)
    # Internal-only namespaces: persisted function BLOBS are executed as
    # code on workers and __meta__/ holds journaled cluster state, so
    # user-facing KV ops must not be able to write or delete them (a
    # kv_put there would be code injection across a head restart).
    _KV_RESERVED = ("__fn_blob__/", "__meta__/")

    def _op_kv_put(self, conn, msg):
        key = msg["key"]
        if key.startswith(self._KV_RESERVED):
            raise ValueError(f"key prefix {self._KV_RESERVED!r} is "
                             "reserved for the control plane")
        with self.lock:
            if msg.get("overwrite", True) or key not in self.kv:
                self.kv[key] = msg["value"]
                return True
            return False

    def _op_kv_get(self, conn, msg):
        with self.lock:
            return self.kv.get(msg["key"])

    def _op_kv_del(self, conn, msg):
        if msg["key"].startswith(self._KV_RESERVED):
            raise ValueError(f"key prefix {self._KV_RESERVED!r} is "
                             "reserved for the control plane")
        with self.lock:
            return self.kv.pop(msg["key"], None) is not None

    def _op_kv_keys(self, conn, msg):
        prefix = msg.get("prefix", "")
        with self.lock:
            return [k for k in self.kv if k.startswith(prefix)
                    and not k.startswith(self._KV_RESERVED)]

    def _op_kv_exists(self, conn, msg):
        with self.lock:
            return msg["key"] in self.kv

    # ------------------------------------------------------------------
    # Tasks
    def _enqueue_task_locked(self, spec: TaskSpec, now: float):
        for oid in spec.return_ids:
            self.objects.setdefault(oid.hex(), ObjectEntry(
                producing_task=spec.task_id.hex()))
            self.lineage[oid.hex()] = spec.task_id.hex()
        for arg in spec.args:
            if arg.is_ref:
                entry = self.objects.get(arg.object_hex)
                if entry is None or entry.state == PENDING:
                    self._dep_waiters.add(arg.object_hex)
        self.tasks[spec.task_id.hex()] = TaskRecord(
            spec=spec, submitted_at=now)
        self.pending_tasks.append(spec)

    def _ingress_pending(self) -> bool:
        """Any submitted-but-undrained specs in the ingress shards?
        deque truthiness is GIL-atomic, so this is safe lock-free."""
        ing = self._ingress
        return ing is not None and any(ing)

    def _ingress_shard_of(self, spec) -> int:
        # Owner id keys the shard so one owner's submissions stay FIFO
        # (a shard deque preserves per-producer order) while different
        # owners never touch the same deque entry.
        owner = getattr(spec, "owner", "") or ""
        return hash(owner) % len(self._ingress)

    def _drain_submit_ingress_locked(self):
        """Lock held.  Move every staged spec into the real pending
        queue/table.  Amortized O(1) per task (each spec is drained
        exactly once); the empty check is a handful of GIL-atomic deque
        reads."""
        ing = self._ingress
        if ing is None:
            return
        drained = 0
        for shard in ing:
            while True:
                try:
                    spec, ts = shard.popleft()
                except IndexError:
                    break
                self._enqueue_task_locked(spec, ts)
                drained += 1
        if drained:
            try:
                from ray_tpu_torch.util import flight_recorder

                flight_recorder.record("sched", "shard_dispatch",
                                       n=drained)
            except Exception:  # raylint: allow-swallow(telemetry only)
                pass

    def _object_entry_or_drain_locked(self, obj_hex: str):
        """Lock held.  Object-directory lookup that tolerates ingress
        deferral: a ref-counting / subscribe op can arrive (from a
        DIFFERENT owner's connection) before the submit that registers
        the object's entry has drained — without the drain-on-miss an
        incref would silently no-op and the ref later double-free."""
        entry = self.objects.get(obj_hex)
        if entry is None and self._ingress_pending():
            self._drain_submit_ingress_locked()
            entry = self.objects.get(obj_hex)
        return entry

    def _op_submit_task(self, conn, msg):
        spec = msg["spec"]
        if self._ingress is not None:
            self._ingress[self._ingress_shard_of(spec)].append(
                (spec, time.time()))
            if self._m_shard_ops is not None:
                try:
                    self._m_shard_ops.inc()
                except Exception:  # raylint: allow-swallow(telemetry only)
                    pass
        else:
            with self.lock:
                self._enqueue_task_locked(spec, time.time())
        self._wake.set()

    def _op_submit_task_batch(self, conn, msg):
        """Coalesced submission (runtime.py _queue_for_flush): one frame
        for a whole burst of tasks.  With ingress shards enabled the
        burst is staged lock-free on the owner's shard and drained by
        the scheduler; submission no longer contends with dispatch or
        completion on the global lock."""
        now = time.time()
        specs = msg["specs"]
        if self._ingress is not None and specs:
            shard = self._ingress[self._ingress_shard_of(specs[0])]
            for spec in specs:
                shard.append((spec, now))
            if self._m_shard_ops is not None:
                try:
                    self._m_shard_ops.inc(len(specs))
                except Exception:  # raylint: allow-swallow(telemetry only)
                    pass
        else:
            with self.lock:
                for spec in specs:
                    self._enqueue_task_locked(spec, now)
        self._wake.set()

    # -- C++-defined tasks/actors ---------------------------------------
    # Reference: cpp/include/ray/api/*.h lets users DEFINE remote
    # functions and actors in C++; a C++ worker process registers its
    # function/class names and executes pushed calls
    # (cpp/include/ray_tpu/worker.h speaks this protocol).
    def _op_register_cpp_functions(self, conn, msg):
        with self.lock:
            conn.meta["cpp_worker"] = True
            for name in msg.get("functions", ()):
                self.cpp_functions[name] = conn
            for name in msg.get("actor_classes", ()):
                self.cpp_actor_classes[name] = conn
        return {"registered": True}

    def _submit_cpp_call(self, target: rpc.Connection, what: dict,
                         args) -> str:
        """Create the return object and push the call to the C++ worker
        (JSON one-way frame); returns the return object hex."""
        return_id = ObjectID.from_random().hex()
        with self.lock:
            self.objects.setdefault(return_id, ObjectEntry())
            self.cpp_inflight.setdefault(
                id(target), (target, set()))[1].add(return_id)
        try:
            target.push_json({"op": "execute_cpp_task", **what,
                              "args": list(args or ()),
                              "return": return_id})
        except Exception as e:  # worker gone mid-call
            self._fail_cpp_return(return_id, f"cpp worker unreachable: {e}")
        return return_id

    def _fail_cpp_return(self, obj_hex: str, reason: str):
        from ray_tpu_torch.core.serialization import serialize

        data = serialize(RuntimeError(reason)).to_bytes()
        with self.lock:
            entry = self.objects.get(obj_hex)
            if entry is None or entry.state == PENDING:
                self._store_object_locked(
                    obj_hex, inline=data, size=len(data), is_error=True)

    def _cleanup_cpp_worker(self, conn):
        """The C++ worker's connection dropped: unregister its names,
        fail its in-flight calls, drop its actor instances."""
        with self.lock:
            self.cpp_functions = {
                k: v for k, v in self.cpp_functions.items() if v is not conn}
            self.cpp_actor_classes = {
                k: v for k, v in self.cpp_actor_classes.items()
                if v is not conn}
            self.cpp_instances = {
                k: v for k, v in self.cpp_instances.items() if v is not conn}
            _, objs = self.cpp_inflight.pop(id(conn), (None, set()))
        for obj_hex in objs:
            self._fail_cpp_return(obj_hex, "cpp worker died")

    def _op_cpp_task_done(self, conn, msg):
        from ray_tpu_torch.core.serialization import serialize

        obj_hex = msg["return"]
        err = msg.get("error")
        value = (RuntimeError(f"cpp task failed: {err}") if err
                 else msg.get("result"))
        data = serialize(value).to_bytes()
        with self.lock:
            ent = self.cpp_inflight.get(id(conn))
            if ent is not None:
                ent[1].discard(obj_hex)
            self._store_object_locked(
                obj_hex, inline=data, size=len(data),
                is_error=bool(err))
        return True

    def _op_list_cpp_functions(self, conn, msg):
        with self.lock:
            return sorted(self.cpp_functions)

    def _op_create_cpp_actor(self, conn, msg):
        cls = msg["actor_class"]
        with self.lock:
            target = self.cpp_actor_classes.get(cls)
        if target is None:
            raise ValueError(f"no C++ actor class registered as {cls!r}")
        import uuid as _uuid

        instance = _uuid.uuid4().hex[:16]
        with self.lock:
            self.cpp_instances[instance] = target
        ready = self._submit_cpp_call(
            target, {"create_actor": cls, "instance": instance},
            msg.get("args"))
        return {"instance": instance, "ready_obj": ready}

    def _op_submit_cpp_actor_task(self, conn, msg):
        instance = msg["instance"]
        with self.lock:
            target = self.cpp_instances.get(instance)
        if target is None:
            raise ValueError(f"unknown C++ actor instance {instance!r}")
        return self._submit_cpp_call(
            target, {"method": msg["method"], "instance": instance},
            msg.get("args"))

    def _op_submit_named_task(self, conn, msg):
        """Cross-language task submission (cpp/ frontend; counterpart of
        the reference's cross-language FunctionDescriptor calls): invoke
        a Python function registered under a name
        (ray_tpu_torch.register_named_function) with JSON-decoded args —
        or a C++-defined function if a C++ worker registered the name
        (_op_register_cpp_functions).
        Returns the return object's hex for polling via get_object_json."""
        from ray_tpu_torch.core.ids import ObjectID as OID
        from ray_tpu_torch.core.ids import TaskID
        from ray_tpu_torch.core.serialization import serialize
        from ray_tpu_torch.core.task_spec import TaskArg

        name = msg["name"]
        with self.lock:
            cpp_target = self.cpp_functions.get(name)
        if cpp_target is not None:
            return self._submit_cpp_call(
                cpp_target, {"fn": name}, msg.get("args"))
        with self.lock:
            func_id = self.kv.get(f"__named_fn__/{name}")
        if func_id is None:
            raise ValueError(f"no function registered as {name!r}")
        func_id = func_id.decode() if isinstance(func_id, bytes) else func_id
        args = []
        for a in msg.get("args", []):
            if (isinstance(a, dict) and set(a) == {"__ref__"}
                    and isinstance(a["__ref__"], str)
                    and len(a["__ref__"]) == 28
                    and all(c in "0123456789abcdef"
                            for c in a["__ref__"])):
                # Cross-language ObjectRef marker: a real ref arg, so
                # the executing worker pulls the value from the object
                # plane (zero JSON round-trip for plasma values).
                args.append(TaskArg(is_ref=True, object_hex=a["__ref__"]))
            else:
                args.append(TaskArg(is_ref=False,
                                    data=serialize(a).to_bytes()))
        return_id = OID.from_random()
        owner = conn.meta.get("worker_hex", "")
        spec = TaskSpec(
            task_id=TaskID.from_random(), func_id=func_id, func_blob=None,
            args=args, num_returns=1, return_ids=[return_id],
            # The frame's accelerator field keeps the reference's name,
            # `num_tpus`: the wire contract (wire_schema.py and the
            # committed WIRE_CONFORMANCE.json) is one for both packages.
            # On this head the accelerator it counts is the GPU.
            resources={"CPU": float(msg.get("num_cpus", 1.0)),
                       **({GPU: float(msg["num_tpus"])}
                          if msg.get("num_tpus") else {})},
            max_retries=int(msg.get("max_retries", 0)),
            name=f"named:{name}", owner=owner)
        self._op_submit_task(conn, {"spec": spec})
        return return_id.hex()

    def _op_get_object_json(self, conn, msg):
        """Poll an object's value for non-Python clients: deserializes
        and re-encodes as JSON. {"status": "pending"|"ready"|"error"}."""
        import json as _json

        with self.lock:
            entry = self.objects.get(msg["obj"])
            if entry is None:
                return {"status": "error", "error": "object not found"}
            if entry.state == PENDING:
                return {"status": "pending"}
        reply = self._op_fetch_object(
            conn, {"obj": msg["obj"], "with_meta": True})
        if reply is None or reply.get("data") is None:
            return {"status": "error",
                    "error": "object payload unavailable"}
        payload, is_error = reply["data"], reply["is_error"]
        from ray_tpu_torch.core.serialization import deserialize

        try:
            value = deserialize(payload)
        except Exception as e:  # noqa: BLE001
            return {"status": "error",
                    "error": f"undeserializable result: {e}"}
        if is_error:
            return {"status": "error", "error": f"{value}"}
        from ray_tpu_torch.core.rpc import _to_jsonable

        try:
            # Validate the WIRE encoding (bytes become base64 envelopes);
            # allow_nan=False because bare NaN/Infinity tokens are not
            # JSON and break non-Python parsers.
            _json.dumps(_to_jsonable(value), allow_nan=False)
        except (TypeError, ValueError):
            return {"status": "error",
                    "error": f"result of type {type(value).__name__} is "
                             "not JSON-representable; fetch it from a "
                             "Python client"}
        return {"status": "ready", "value": value}

    def _op_task_done(self, conn, msg):
        with self.lock:
            self._drain_submit_ingress_locked()
            # Batched result puts ride the done message (worker.py
            # _finish); store them BEFORE completing the task so
            # subscribers resolve before any retry bookkeeping.
            put_node = self._store_node_for(conn)
            for put in msg.get("puts", ()):
                self._store_object_locked(
                    put["obj"], inline=put.get("inline"),
                    size=put["size"],
                    is_error=put.get("is_error", False),
                    in_shm=put.get("in_shm", False),
                    node_id=put_node)
            rec = self.tasks.get(msg["task_id"])
            worker_hex = conn.meta.get("worker_hex")
            w = self.workers.get(worker_hex) if worker_hex else None
            if rec is not None:
                rec.state = "FAILED" if msg.get("failed") else "FINISHED"
                rec.finished_at = time.time()
                tr = msg.get("trace")
                if tr:
                    rec.trace_id, rec.span_id, rec.parent_span_id = tr
            claimed = None
            need_wake = True
            if w is not None and w.kind == "pool":
                w.state = "idle"
                w.current_task = None
                released = w.acquired
                self._release(w)
                # Fast redispatch: hand this worker the next compatible
                # pending task WITHOUT a full scheduler pass (a 1k-task
                # burst used to trigger 1k O(pending) rescans, one per
                # completion).  Conservative: plain tasks only; anything
                # with placement/strategy/PG falls back to the pass.
                claimed = self._fast_claim_locked(w)
                if claimed is not None:
                    # The pass is still needed when this completion could
                    # have unblocked anything BEYOND the claimed task:
                    # leftover freed resources (shapes differ), a put
                    # that made a dep-blocked task ready (which may need
                    # a worker SPAWN, not just an idle worker), an idle
                    # worker for it, or queued actors/PGs.
                    if not self.pending_tasks:
                        self._dep_waiters.clear()
                    unblocked = any(
                        p["obj"] in self._dep_waiters
                        for p in msg.get("puts", ()))
                    need_wake = bool(
                        unblocked
                        or released.to_dict()
                        != ResourceSet(claimed.resources).to_dict()
                        or self.pending_actors
                        or any(pg.state == "PENDING"
                               for pg in self.placement_groups.values())
                        or any(x.kind == "pool" and x.state == "idle"
                               and x.conn is not None
                               for x in self.workers.values()))
            self._prune_lineage_locked()
        for obj_hex in msg.get("decrefs", ()):
            self._op_decref(conn, {"obj": obj_hex})
        if any(p.get("in_shm") for p in msg.get("puts", ())):
            self._maybe_spill()
        if claimed is not None:
            try:
                w.conn.push({"op": "execute_task", "spec": claimed})
            except Exception:
                with self.lock:
                    self._mark_worker_dead(w, "push failed")
                need_wake = True
        if need_wake:
            self._wake.set()

    def _fast_claim_locked(self, w) -> Optional[TaskSpec]:
        """Lock held.  Pop the first plain pending task this idle worker
        can run right now (deps ready, same env, resources fit its
        node); None defers to the scheduling pass."""
        node = self.nodes.get(w.node_id)
        if node is None or not node.alive:
            return None
        pending = self.pending_tasks
        for i in range(min(len(pending), 64)):
            spec = pending[i]
            if (spec.placement_group_hex
                    or spec.scheduling_strategy is not None
                    or not self._deps_ready(spec)):
                continue
            if self._env_key_for(spec.resources, spec.runtime_env) \
                    != w.env_key:
                continue
            need = ResourceSet(spec.resources)
            if not need.is_subset_of(node.available):
                continue
            del pending[i]
            node.available = node.available.subtract(need)
            self._index_touch(w.node_id)
            w.acquired = need
            w.charge = ("node", w.node_id)
            w.state = "busy"
            w.current_task = spec.task_id.hex()
            rec = self.tasks.get(spec.task_id.hex())
            if rec is not None:
                rec.state = "RUNNING"
                rec.worker_hex = w.worker_hex
                rec.started_at = time.time()
                rec.arg_bytes = self._task_arg_bytes(spec)
            return spec
        return None

    # ------------------------------------------------------------------
    # Worker leases: the owner-direct task path's only head involvement
    # (reference: NodeManager::HandleRequestWorkerLease
    # node_manager.cc:1794 grants a worker binding; the owner then
    # pushes tasks peer-to-peer, direct_task_transport.h:75).
    def _op_request_lease(self, conn, msg):
        owner_hex = conn.meta.get("worker_hex", "")
        count = max(1, min(int(msg.get("count", 1)),
                           self.config.max_lease_workers_per_request))
        resources = msg.get("resources") or {}
        renv = msg.get("runtime_env")
        token = msg.get("token")
        granted: List[dict] = []
        denied = 0
        error = ""
        with self.lock:
            env_key = self._env_key_for(resources, renv)
            broken = self.broken_envs.get(env_key)
            if broken is not None and \
                    time.time() - broken[1] <= self.broken_env_ttl_s:
                denied, error = count, f"runtime_env setup failed: " \
                    f"{broken[0]}"
                count = 0
            need = ResourceSet(resources)
            # Virtual availability across the grant loop, so N spawn
            # decisions spread over nodes instead of all landing on the
            # first pick (mirrors the schedule pass's virtual view).
            avail_virtual: Dict[str, ResourceSet] = {}

            def virt(nid: str) -> ResourceSet:
                if nid not in avail_virtual:
                    node = self.nodes.get(nid)
                    av = (node.available if node is not None
                          and node.alive else ResourceSet())
                    # Earlier queued lease demand already spoken for on
                    # this node reduces what THIS request can plan with.
                    # Indexed by node: O(demand on nid), not O(all
                    # pending) — the scan that made lease admission
                    # quadratic under many-owner contention.
                    for pl in self.pending_leases.node_demand(nid):
                        pneed = ResourceSet(pl["resources"])
                        av = av.subtract(pneed) \
                            if pneed.is_subset_of(av) else ResourceSet()
                    avail_virtual[nid] = av
                return avail_virtual[nid]

            node_workers: Dict[str, int] = {}
            starting_total = 0
            for w in self.workers.values():
                if w.kind == "pool" and w.state != "dead":
                    node_workers[w.node_id] = node_workers.get(
                        w.node_id, 0) + 1
                    if w.state == "starting" and w.env_key == env_key:
                        starting_total += 1
            # Spawns already claimed by earlier queued lease requests
            # must not dedupe THIS request's spawns.
            unclaimed = starting_total \
                - self.pending_leases.env_count(env_key)
            # Fair-share clamp under competition: with other owners
            # holding leases or queued demand, one burst's ask must not
            # swallow the whole free pool first-come-take-all — the
            # losers would crawl on a single worker while the winner
            # hoards, and concurrent-submitter throughput is gated by
            # the slowest owner.  Denied remainders retry after backoff
            # and pick up whatever share frees.
            others = {w.leased_to for w in self.workers.values()
                      if w.kind == "pool" and w.state == "leased"
                      and w.leased_to and w.leased_to != owner_hex}
            others.update(self.pending_leases.owners_except(owner_hex))
            if others and count > 1:
                free_fit = sum(virt(n.node_id).fit_count(need)
                               for n in self.nodes.values()
                               if n.schedulable)
                share = max(1, free_fit // (len(others) + 1))
                if count > share:
                    denied += count - share
                    clamped_from, count = count, share
                    if self._m_lease_clamps is not None:
                        try:
                            self._m_lease_clamps.inc()
                        except Exception:
                            pass
                    try:
                        from ray_tpu_torch.util import flight_recorder

                        flight_recorder.record(
                            "scheduler", "fair_share_clamp",
                            owner=owner_hex, asked=clamped_from,
                            share=share, competitors=len(others))
                    except Exception:
                        pass
            for i in range(count):
                w = self._idle_lease_worker_locked(env_key, need, virt)
                if w is not None:
                    charge = ("node", w.node_id)
                    avail_virtual[w.node_id] = virt(
                        w.node_id).subtract(need)
                    self._charge_target_subtract(charge, need)
                    w.acquired = need
                    w.charge = charge
                    w.state = "leased"
                    w.leased_to = owner_hex
                    granted.append({"worker": w.worker_hex,
                                    "address": w.address})
                    continue
                # No idle worker: place a spawn (virtual accounting) or
                # deny the remainder fast — the owner pipelines onto
                # what it has and retries after a backoff.
                feasible = [n for n in self.nodes.values()
                            if n.schedulable and need.is_subset_of(
                                virt(n.node_id))]
                if not feasible:
                    # Workers granted THIS call count as "have": the
                    # owner sent have= before any grant arrived, and an
                    # infeasible remainder queued behind a partial grant
                    # would pin the owner's requested counter (and its
                    # pipeline depth) until capacity frees — which never
                    # happens while the owner itself holds it.
                    if int(msg.get("have", 0)) + len(granted) > 0:
                        # Owner has workers to pipeline onto: deny the
                        # excess fast (it backs off and retries).
                        denied += count - i
                    else:
                        # Nothing to pipeline onto: queue the demand —
                        # it must stay visible to the autoscaler
                        # (get_load) and grants when capacity appears.
                        for _ in range(count - i):
                            self.pending_leases.append({
                                "owner": owner_hex, "env_key": env_key,
                                "resources": dict(resources),
                                "token": token, "node_id": "",
                                "created": time.time()})
                    break
                node = max(feasible, key=lambda n: (
                    self._utilization(n, virt(n.node_id)), n.is_head))
                nid = node.node_id
                avail_virtual[nid] = virt(nid).subtract(need)
                if unclaimed > 0:
                    unclaimed -= 1  # one already on the way
                elif node_workers.get(nid, 0) < \
                        self.config.max_workers_per_node:
                    self._spawn_worker(env_key=env_key, kind="pool",
                                       node_id=nid)
                    node_workers[nid] = node_workers.get(nid, 0) + 1
                self.pending_leases.append({
                    "owner": owner_hex, "env_key": env_key,
                    "resources": dict(resources), "token": token,
                    "node_id": nid, "created": time.time()})
        self._push_lease_grants([(conn, token, granted, denied, error)])

    def _idle_lease_worker_locked(self, env_key: str, need: "ResourceSet",
                                  avail_of=None):
        """Lock held.  Any idle pool worker with the right env whose
        node can hold the lease's resources."""
        for x in self.workers.values():
            if (x.kind == "pool" and x.state == "idle"
                    and x.conn is not None and x.env_key == env_key
                    and x.address):
                node = self.nodes.get(x.node_id)
                if node is None or not node.alive:
                    continue
                avail = avail_of(x.node_id) if avail_of is not None \
                    else node.available
                if need.is_subset_of(avail):
                    return x
        return None

    def _op_release_lease(self, conn, msg):
        owner_hex = conn.meta.get("worker_hex", "")
        with self.lock:
            for whex in msg.get("workers", ()):
                w = self.workers.get(whex)
                if w is not None and w.state == "leased" and \
                        (not owner_hex or w.leased_to == owner_hex):
                    self._release(w)
                    w.state = "idle"
                    w.leased_to = ""
        self._wake.set()

    def _op_kill_worker(self, conn, msg):
        """Owner-initiated kill of a leased worker (force-cancel of a
        lease-path task; reference: CancelTask with force_kill kills
        the executing worker)."""
        whex = msg.get("worker")
        owner_hex = conn.meta.get("worker_hex", "")
        with self.lock:
            w = self.workers.get(whex)
            if w is None or w.state == "dead":
                return False
            if w.state == "leased" and owner_hex and \
                    w.leased_to != owner_hex:
                return False  # only the lease holder may kill
            node = self.nodes.get(w.node_id)
            if w.proc is not None:
                try:
                    w.proc.kill()
                except OSError:
                    pass
            elif node is not None and node.conn is not None:
                try:
                    node.conn.push({"op": "kill_worker",
                                    "worker_hex": whex})
                except Exception:
                    pass
            else:
                return False
            self._mark_worker_dead(w, "killed by owner (task cancelled)")
        self._wake.set()
        return True

    def _try_grant_leases_locked(self) -> List[tuple]:
        """Lock held.  Match queued lease requests against idle workers
        / freed resources; expired ones are denied so the owner's pump
        re-requests.  Returns (conn, token, workers, denied) tuples to
        push outside the lock."""
        if not self.pending_leases:
            return []
        out: List[tuple] = []
        still: List[dict] = []
        now = time.time()
        # Per-pass spawn accounting: queued demand may target nodes
        # that joined AFTER the request (autoscaler growth) — spawn
        # there, deduped against already-starting workers.
        node_workers: Dict[str, int] = {}
        starting: Dict[str, int] = {}
        leased_by: Dict[tuple, int] = {}
        for w in self.workers.values():
            if w.kind == "pool" and w.state != "dead":
                node_workers[w.node_id] = node_workers.get(
                    w.node_id, 0) + 1
                if w.state == "starting":
                    starting[w.env_key] = starting.get(w.env_key, 0) + 1
                if w.state == "leased":
                    key = (w.leased_to, w.env_key)
                    leased_by[key] = leased_by.get(key, 0) + 1
        for pl in self.pending_leases:
            owner = self.workers.get(pl["owner"])
            if owner is None or owner.state == "dead" or owner.conn is None:
                continue  # owner gone: drop the demand
            need = ResourceSet(pl["resources"])
            w = self._idle_lease_worker_locked(pl["env_key"], need)
            if w is None:
                broken = self.broken_envs.get(pl["env_key"])
                if broken is not None and \
                        now - broken[1] <= self.broken_env_ttl_s:
                    # Env poisoned AFTER this request was queued (its
                    # own spawn usually revealed the poison) and no
                    # healthy idle worker can serve it: deny with the
                    # setup error so the owner fast-fails its queued
                    # specs — without this the loop would re-spawn
                    # doomed workers forever while the owner waits.
                    # (With healthy idle workers — an earlier setup of
                    # the same env succeeded — the demand is served,
                    # not failed.)
                    out.append((owner.conn, pl["token"], [], 1,
                                f"runtime_env setup failed: {broken[0]}"))
                    continue
            if w is not None:
                charge = ("node", w.node_id)
                self._charge_target_subtract(charge, need)
                w.acquired = need
                w.charge = charge
                w.state = "leased"
                w.leased_to = pl["owner"]
                out.append((owner.conn, pl["token"],
                            [{"worker": w.worker_hex,
                              "address": w.address}], 0, ""))
                continue
            if starting.get(pl["env_key"], 0) > 0:
                starting[pl["env_key"]] -= 1  # a spawn is on the way
                still.append(pl)
                continue
            feasible = [n for n in self.nodes.values()
                        if n.schedulable and need.is_subset_of(n.available)
                        and node_workers.get(n.node_id, 0)
                        < self.config.max_workers_per_node]
            if feasible:
                node = max(feasible, key=lambda n: (
                    self._utilization(n), n.is_head))
                self._spawn_worker(env_key=pl["env_key"], kind="pool",
                                   node_id=node.node_id)
                node_workers[node.node_id] = node_workers.get(
                    node.node_id, 0) + 1
                still.append(pl)
            elif leased_by.get((pl["owner"], pl["env_key"]), 0) > 0:
                # Cluster-infeasible remainder of a request whose owner
                # now holds same-shaped workers: deny now, exactly as
                # _op_request_lease does for have>0 askers.  Keeping it
                # queued would pin the owner's requested counter — and
                # with it the owner's pipeline depth — on capacity the
                # owner itself occupies.
                out.append((owner.conn, pl["token"], [], 1, ""))
            elif now - pl["created"] > (10.0 if pl.get("node_id")
                                        else 15.0):
                # Spawn never materialized (10s), or cluster-infeasible
                # demand went stale (15s): deny so the owner's pump
                # re-requests — a still-wanting owner refreshes the
                # entry within its backoff, keeping the demand visible
                # to the autoscaler without leaking dead entries.
                out.append((owner.conn, pl["token"], [], 1, ""))
            else:
                still.append(pl)
        self.pending_leases.reset(still)
        return out

    def _push_lease_grants(self, grants: List[tuple]):
        for oconn, token, workers, denied, error in grants:
            if not workers and not denied:
                continue
            # Single choke point for both grant paths (request-time and
            # scheduler-loop): count the decision and drop it in the
            # flight-recorder ring for the timeline's scheduler lane.
            try:
                if workers and self._m_lease_grants is not None:
                    self._m_lease_grants.inc(len(workers))
                if denied and self._m_lease_denials is not None:
                    self._m_lease_denials.inc(denied)
            except Exception:
                pass
            try:
                from ray_tpu_torch.util import flight_recorder

                flight_recorder.record(
                    "scheduler", "lease_grant",
                    granted=len(workers), denied=denied,
                    workers=[wi["worker"][:8] for wi in workers],
                    error=error or "")
            except Exception:
                pass
            try:
                oconn.push({"op": "lease_granted", "token": token,
                            "workers": workers, "denied": denied,
                            "error": error})
            except Exception:
                # Owner unreachable: reclaim the workers.
                with self.lock:
                    for wi in workers:
                        x = self.workers.get(wi["worker"])
                        if x is not None and x.state == "leased":
                            self._release(x)
                            x.state = "idle"
                            x.leased_to = ""

    def _op_task_events(self, conn, msg):
        """Batched execution events from workers running lease-path
        tasks (reference TaskEventBuffer → GcsTaskManager,
        task_event_buffer.h:206): keeps the state API and timeline
        complete for tasks the head never scheduled."""
        now = time.time()
        worker_hex = conn.meta.get("worker_hex", "")
        events = msg.get("events", ())
        try:
            if self._m_task_event_frames is not None:
                self._m_task_event_frames.inc()
                self._m_task_events.inc(len(events))
        except Exception:
            pass
        # GLOBAL-LOCK-FREE completion drain: task records live in the
        # sharded table (insert/pop are shard-locked internally), each
        # task's events come from its single executing worker, and the
        # merged fields are telemetry the scheduler never branches on
        # for head-path liveness (the direct/PENDING-RUNNING guard
        # below keeps retry state authoritative).  The highest-volume
        # op on a loaded head no longer serializes behind the
        # scheduler's lock.
        w = self.workers.get(worker_hex)
        for ev in events:
            rec = self.tasks.get(ev["task_id"])
            if rec is None:
                spec = TaskSpec(
                    task_id=TaskID.from_hex(ev["task_id"]),
                    func_id="", func_blob=None, args=[],
                    num_returns=1, return_ids=[], resources={},
                    max_retries=int(ev.get("retries_left", 0)),
                    name=ev.get("name", ""),
                    owner=ev.get("owner", ""), direct=True)
                rec = self.tasks[ev["task_id"]] = TaskRecord(
                    spec=spec, submitted_at=ev.get("start")
                    or ev.get("received") or now)
            elif not rec.spec.direct and rec.state in ("PENDING",
                                                       "RUNNING"):
                # A live head-path record (the task was fallback-
                # resubmitted through the scheduler after its lease
                # worker was presumed lost): a stale event from the
                # old worker must not clobber the retry's state or
                # its death-detection worker binding.
                continue
            state = ev.get("state", "FINISHED")
            # Arrival-only deltas map into the head's state
            # vocabulary (PENDING|RUNNING|FINISHED|FAILED).
            rec.state = "PENDING" if state == "RECEIVED" else state
            rec.worker_hex = worker_hex
            # Deltas carry only what changed since the last event for
            # this task (an arrival-only RECEIVED has no start/end):
            # merge, never clobber with zeros.
            rec.started_at = ev.get("start", 0.0) or rec.started_at
            rec.finished_at = ev.get("end", 0.0) or rec.finished_at
            rec.received_at = ev.get("received", 0.0) or rec.received_at
            rec.retry_count = ev.get("retry_count", rec.retry_count)
            tr = ev.get("trace")
            if tr:
                rec.trace_id, rec.span_id, rec.parent_span_id = tr
            # Track the leased worker's current task so the OOM
            # victim policy can pick/kill it like a busy worker.
            if w is not None and w.state == "leased":
                if state == "RUNNING":
                    w.current_task = ev["task_id"]
                elif w.current_task == ev["task_id"]:
                    w.current_task = None
        cap = self.config.max_lineage_entries
        if cap > 0 and len(self.tasks) > cap:
            with self.lock:
                self._prune_lineage_locked()

    def _op_flight_recorder(self, conn, msg):
        """Dump the head's in-memory flight-recorder ring (recent wire
        flushes + scheduler decisions) — the dashboard merges this with
        the driver-side ring when the head is a separate process."""
        from ray_tpu_torch.util import flight_recorder

        return {"events": flight_recorder.dump(
                    int(msg.get("last", 0) or 0),
                    float(msg.get("since", 0) or 0.0)),
                "stats": flight_recorder.stats()}

    # ------------------------------------------------------------------
    # Actors
    def _op_create_actor(self, conn, msg):
        spec: ActorCreationSpec = msg["spec"]
        with self.lock:
            entry = ActorEntry(spec=spec)
            self.actors[spec.actor_id.hex()] = entry
            if spec.name:
                key = (spec.namespace, spec.name)
                if key in self.named_actors:
                    entry.state = A_DEAD
                    entry.death_reason = f"name {spec.name!r} already taken"
                    self._push_actor_update(entry, spec.actor_id.hex())
                    return
                self.named_actors[key] = spec.actor_id.hex()
            self.pending_actors.append(spec)
            self._journal_put(f"actor/{spec.actor_id.hex()}", spec)
        self._wake.set()

    def _op_actor_ready(self, conn, msg):
        actor_hex = msg["actor"]
        with self.lock:
            entry = self.actors.get(actor_hex)
            if entry is None:
                return
            if entry.state == A_DEAD:
                # Killed while the worker was still creating the instance —
                # don't resurrect; tell the worker to exit (zombie would
                # otherwise hold its resource allocation).
                try:
                    conn.push({"op": "exit"})
                except Exception:
                    pass
                return
            announcer = conn.meta.get("worker_hex")
            if entry.state == A_ALIVE and entry.worker_hex \
                    and entry.worker_hex != announcer:
                cur = self.workers.get(entry.worker_hex)
                if cur is not None and cur.state != "dead" \
                        and cur.conn is not None:
                    # Fencing: the actor was respawned (e.g. restart
                    # grace expired) and its ORIGINAL worker re-announced
                    # late — one instance must win, the late announcer
                    # exits (reference: GCS actor-registration fencing).
                    try:
                        conn.push({"op": "exit"})
                    except Exception:
                        pass
                    return
            entry.state = A_ALIVE
            entry.address = msg["address"]
            # Bind the announcing worker: after a head restart the actor
            # re-announces from a worker this head never spawned, and the
            # binding is what routes death-detection → actor restart.
            worker_hex = conn.meta.get("worker_hex")
            if worker_hex:
                entry.worker_hex = worker_hex
                w = self.workers.get(worker_hex)
                if w is not None:
                    w.actor_hex = actor_hex
                    w.kind = "actor"
            self._restored_actors.discard(actor_hex)
            self._push_actor_update(entry, actor_hex)

    def _op_actor_creation_failed(self, conn, msg):
        actor_hex = msg["actor"]
        with self.lock:
            entry = self.actors.get(actor_hex)
            if entry is None:
                return
            entry.state = A_DEAD
            entry.death_reason = msg.get("reason", "creation failed")
            self._push_actor_update(entry, actor_hex)

    def _op_subscribe_actor(self, conn, msg):
        actor_hex = msg["actor"]
        with self.lock:
            entry = self.actors.get(actor_hex)
            if entry is None:
                conn.push({"op": "actor_update", "actor": actor_hex,
                           "state": A_DEAD, "address": "",
                           "reason": "no such actor"})
                return
            conn.push(self._actor_update_msg(entry, actor_hex))
            if entry.state not in (A_DEAD,):
                entry.subscribers.append(conn)

    def _op_kill_actor(self, conn, msg):
        actor_hex = msg["actor"]
        no_restart = msg.get("no_restart", True)
        with self.lock:
            entry = self.actors.get(actor_hex)
            if entry is None:
                return
            if no_restart:
                entry.spec.max_restarts = entry.spec.restart_count
            w = self.workers.get(entry.worker_hex)
            if w is not None and w.conn is not None:
                try:
                    w.conn.push({"op": "exit"})
                except Exception:
                    pass
            if entry.state == A_PENDING or (w is None and entry.state != A_DEAD):
                entry.state = A_DEAD
                entry.death_reason = "killed"
                self.pending_actors = [
                    s for s in self.pending_actors
                    if s.actor_id.hex() != actor_hex
                ]
                self._fail_actor_inflight(actor_hex, "killed")
                self._push_actor_update(entry, actor_hex)

    def _actor_update_msg(self, entry: ActorEntry, actor_hex: str):
        return {
            "op": "actor_update",
            "actor": actor_hex,
            "state": entry.state,
            "address": entry.address,
            "reason": entry.death_reason,
            # Owners use this to resubmit delivered-but-unfinished
            # direct calls across a restart (runtime max_task_retries;
            # getattr: journal-replayed specs may predate the field).
            "max_task_retries": getattr(entry.spec, "max_task_retries",
                                        0),
        }

    def _push_actor_update(self, entry: ActorEntry, actor_hex: str):
        msg = self._actor_update_msg(entry, actor_hex)
        subs = list(entry.subscribers)
        if entry.state == A_DEAD:
            entry.subscribers = []
            self._journal_del(f"actor/{actor_hex}")
            # Release the actor's name so it can be reused (the reference
            # unregisters names on death, gcs_actor_manager.cc).  Guard on
            # ownership: an actor that died *because* the name was taken
            # must not free the live owner's registration.
            if entry.spec.name:
                key = (entry.spec.namespace, entry.spec.name)
                if self.named_actors.get(key) == actor_hex:
                    del self.named_actors[key]
        for c in subs:
            try:
                c.push(msg)
            except Exception:
                pass

    def _op_get_named_actor(self, conn, msg):
        key = (msg.get("namespace", ""), msg["name"])
        with self.lock:
            actor_hex = self.named_actors.get(key)
            if actor_hex is None:
                return None
            entry = self.actors.get(actor_hex)
            if entry is None or entry.state == A_DEAD:
                return None
            return {"actor": actor_hex, "class_id": entry.spec.class_id,
                    "state": entry.state, "address": entry.address}

    def _op_list_named_actors(self, conn, msg):
        with self.lock:
            out = []
            for (ns, name), actor_hex in self.named_actors.items():
                entry = self.actors.get(actor_hex)
                if entry is not None and entry.state != A_DEAD:
                    out.append({"name": name, "namespace": ns})
            return out

    # ------------------------------------------------------------------
    # State API (reference: util/state — ray list tasks/actors/...)
    def _op_cluster_resources(self, conn, msg):
        with self.lock:
            out = ResourceSet()
            for n in self.nodes.values():
                if n.alive:
                    out = out.add(n.total)
            return out.to_dict()

    def _op_available_resources(self, conn, msg):
        with self.lock:
            out = ResourceSet()
            for n in self.nodes.values():
                if n.alive:
                    out = out.add(n.available)
            # PG free reservations still count as available-to-PG-users
            return out.to_dict()

    def _op_list_tasks(self, conn, msg):
        with self.lock:
            self._drain_submit_ingress_locked()
            return [
                {"task_id": h, "name": r.spec.name, "state": r.state,
                 "worker": r.worker_hex,
                 "submitted_at": r.submitted_at or None,
                 "started_at": r.started_at or None,
                 "finished_at": r.finished_at or None,
                 "received_at": r.received_at or None,
                 "retry_count": r.retry_count,
                 "trace_id": r.trace_id or None,
                 "span_id": r.span_id or None,
                 "parent_span_id": r.parent_span_id or None,
                 "pid": (self.workers.get(r.worker_hex).pid
                         if r.worker_hex in self.workers else None),
                 "duration_s": (r.finished_at - r.started_at)
                 if r.finished_at else None}
                for h, r in self.tasks.items()
            ]

    def _op_list_actors(self, conn, msg):
        with self.lock:
            return [
                {"actor_id": h, "state": e.state, "name": e.spec.name,
                 "class": e.spec.class_id.split(":")[0],
                 "pid": (self.workers.get(e.worker_hex).pid
                         if e.worker_hex in self.workers else None)}
                for h, e in self.actors.items()
            ]

    def _op_list_objects(self, conn, msg):
        with self.lock:
            return [
                {"object_id": h, "state": e.state, "size": e.size,
                 "refcount": e.refcount, "in_shm": e.in_shm,
                 "spilled": e.spilled_uri is not None}
                for h, e in self.objects.items()
            ]

    def _op_list_workers(self, conn, msg):
        with self.lock:
            return [
                {"worker_id": h, "kind": w.kind, "state": w.state,
                 "pid": w.pid, "actor": w.actor_hex}
                for h, w in self.workers.items()
            ]

    def _op_ping(self, conn, msg):
        return "pong"

    # ------------------------------------------------------------------
    # Nodes (fake-cluster API, counterpart of cluster_utils.Cluster
    # add_node/remove_node, python/ray/cluster_utils.py:201/:279)
    def _op_add_node(self, conn, msg):
        res = ResourceSet(msg["resources"])
        node_id = msg.get("node_id")
        with self.lock:
            if not node_id:
                i = len(self.nodes)
                while f"node-{i}" in self.nodes:
                    i += 1
                node_id = f"node-{i}"
            if node_id in self.nodes:
                raise ValueError(f"node {node_id} already exists")
            self.nodes[node_id] = NodeState(
                node_id=node_id, total=res, available=res,
                labels=msg.get("labels") or {})
            self._index_touch(node_id)
            self._journal_put(f"node/{node_id}", {
                "resources": res.to_dict(),
                "labels": msg.get("labels") or {}})
        self._wake.set()
        return node_id

    # -- graceful node drain (reference DrainRaylet,
    # src/ray/protobuf/node_manager.proto:401, and autoscaler DrainNode,
    # autoscaler.proto:334) ---------------------------------------------
    def _op_drain_node(self, conn, msg):
        """Begin draining a node: it stops accepting leases/placements
        NOW; the drain sweep migrates sole-copy objects, reschedules
        idle PG bundles, waits for running work, then terminates it."""
        node_id = msg["node_id"]
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return {"accepted": False, "reason": "no such alive node"}
            if node.is_head:
                return {"accepted": False, "reason": "cannot drain head"}
            node.draining = True
            node.drain_reason = msg.get("reason", "")
            self._index_touch(node_id)
            self._drain_migrating.setdefault(node_id, set())
            # Journaled: a restarted head must keep draining (the
            # autoscalers are waiting on drain_status == "gone"; losing
            # the flag would wedge them in DRAINING forever).
            self._journal_put(f"drain/{node_id}",
                              {"reason": node.drain_reason})
        self._wake.set()
        return {"accepted": True}

    def _op_drain_status(self, conn, msg):
        node_id = msg["node_id"]
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return {"state": "gone"}
            if not node.draining:
                return {"state": "alive"}
            busy = sum(1 for w in self.workers.values()
                       if self._drain_blocking_locked(w, node_id))
            sole = sum(1 for e in self.objects.values()
                       if e.node_id == node_id and e.in_shm
                       and e.state == READY)
            bundles = sum(1 for pg in self.placement_groups.values()
                          if pg.state == "CREATED" and any(
                              b.node_id == node_id for b in pg.bundles))
            return {"state": "draining", "busy_workers": busy,
                    "sole_objects": sole, "pg_bundles": bundles}

    def _op_objects_migrated(self, conn, msg):
        """A draining node finished pushing objects to a survivor: move
        the primary-copy records so the upcoming node death triggers NO
        reconstruction for them."""
        node_id = msg["node_id"]
        dest_node = msg["dest_node"]
        with self.lock:
            migr = self._drain_migrating.get(node_id, set())
            dest = self.nodes.get(dest_node)
            for obj_hex, status in (msg.get("results") or {}).items():
                migr.discard(obj_hex)
                if status in ("ok", "have") and dest is not None \
                        and dest.alive:
                    e = self.objects.get(obj_hex)
                    if e is not None and e.node_id == node_id:
                        e.node_id = dest_node
        self._wake.set()
        return True

    def _drop_drain_state_locked(self, node_id: str):
        """Lock held.  A node leaving the cluster by ANY path (graceful
        finish, crash, removal) must shed its drain bookkeeping and
        journal record, or a head restart re-restores a phantom
        drain."""
        self._drain_migrating.pop(node_id, None)
        self._drain_issued_at.pop(node_id, None)
        self._journal_del(f"drain/{node_id}")

    @staticmethod
    def _drain_blocking_locked(w, node_id: str) -> bool:
        """Lock held.  Does this worker hold drain-blocking work on
        node_id?  (Single definition shared by drain_status and the
        drain sweep so the two can never disagree.)"""
        return (w.node_id == node_id and w.state != "dead"
                and bool(w.current_task or w.actor_hex
                         or w.state in ("leased", "busy", "starting")))

    def _reschedule_pg_locked(self, pg: "PlacementGroupEntry"):
        """Lock held.  Release a CREATED-but-idle PG's bundles and send
        it back to PENDING: the scheduler re-reserves it on schedulable
        nodes (the drain path's bundle migration; reference reschedules
        bundles off draining/dead nodes the same way)."""
        for b in pg.bundles:
            node = self.nodes.get(b.node_id)
            if node is not None and node.alive:
                node.available = node.available.add(b.available)
                self._index_touch(b.node_id)
        pg.bundles = []
        pg.state = "PENDING"

    def _check_drains(self):
        """Drain sweep (called from the scheduler loop): advance every
        draining node toward termination.  Order per node: wait for
        running work -> migrate sole-copy objects to a survivor arena ->
        reschedule idle PG bundles -> terminate via the normal removal
        path (object records already point at the survivor, so the
        death handler reconstructs nothing)."""
        migrations = []  # (node_conn, objects, dest_addr, dest_node)
        finished = []    # node_ids ready to terminate
        with self.lock:
            draining = [n for n in self.nodes.values()
                        if n.alive and n.draining]
            for node in draining:
                nid = node.node_id
                busy = any(self._drain_blocking_locked(w, nid)
                           for w in self.workers.values())
                if busy:
                    continue
                migr = self._drain_migrating.setdefault(nid, set())
                issued = self._drain_issued_at.get(nid, 0.0)
                if migr and time.monotonic() - issued > self._drain_retry_s:
                    # The report for this batch is presumed lost (or the
                    # node restarted mid-migration): re-issue.
                    migr.clear()
                sole = [(h, e) for h, e in self.objects.items()
                        if e.node_id == nid and e.in_shm
                        and e.state == READY]
                pending = [x for x in sole if x[0] in migr]
                fresh = [x for x in sole if x[0] not in migr]
                if fresh and node.conn is not None:
                    dest = next(
                        (n for n in self.nodes.values()
                         if n.schedulable and n.node_id != nid
                         and n.conn is not None and n.address),
                        None)
                    if dest is not None:
                        migr.update(h for h, _ in fresh)
                        self._drain_issued_at[nid] = time.monotonic()
                        migrations.append((
                            nid, node.conn,
                            [{"obj": h, "size": e.size}
                             for h, e in fresh],
                            dest.address, dest.node_id))
                        continue
                    # No survivor arena exists: nothing to migrate to —
                    # fall through and let lineage cover the loss.
                elif pending:
                    continue  # migration in flight; wait for the report
                pgs = [pg for pg in self.placement_groups.values()
                       if pg.state == "CREATED" and any(
                           b.node_id == nid for b in pg.bundles)]
                moved = False
                for pg in pgs:
                    in_use = any(
                        w.charge and w.charge[0] == "pg"
                        and w.charge[1] == pg.pg_hex
                        and w.state != "dead"
                        for w in self.workers.values())
                    if not in_use:
                        self._reschedule_pg_locked(pg)
                        moved = True
                if pgs and not moved:
                    continue  # occupied bundles: wait for their workers
                if moved:
                    continue  # let the scheduler re-reserve first
                finished.append(nid)
        for nid, conn, objects, dest_addr, dest_node in migrations:
            try:
                conn.push({"op": "migrate_objects", "objects": objects,
                           "dest": dest_addr, "dest_node": dest_node})
            except Exception:
                # Failed to even hand the node the migration list: take
                # the hexes back out of the in-flight set so the next
                # sweep retries instead of waiting forever on a report
                # that can never come.
                with self.lock:
                    migr = self._drain_migrating.get(nid)
                    if migr is not None:
                        for item in objects:
                            migr.discard(item["obj"])
        for nid in finished:
            with self.lock:
                self._drop_drain_state_locked(nid)
            self._op_remove_node(None, {"node_id": nid})

    def _op_remove_node(self, conn, msg):
        """Simulated node failure: kill its workers, fail/retry their work.

        The worker-death path handles task retry / actor restart exactly as
        a real crash would (chaos-testing hook, reference RayletKiller
        python/ray/_private/test_utils.py:1536)."""
        node_id = msg["node_id"]
        to_kill = []
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None:
                return False
            conn = node.conn
        if conn is not None:
            # Real node: ask its manager to exit and run the full
            # node-death path NOW (worker fail/retry, PG teardown, object
            # recovery) — the later disconnect then no-ops on the
            # already-dead node.
            try:
                conn.push({"op": "exit"})
            except Exception:
                pass
            self._handle_node_death(node_id)
            return True
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return False
            node.alive = False
            node.available = ResourceSet()
            self._index_touch(node_id)
            self._drop_drain_state_locked(node_id)
            self._journal_del(f"node/{node_id}")
            for w in list(self.workers.values()):
                if w.node_id == node_id and w.state != "dead":
                    to_kill.append(w)
                    if w.conn is None:
                        # Never registered: no disconnect event will ever
                        # fire, so observe the death here or its task/actor
                        # hangs forever.
                        self._mark_worker_dead(w, f"node {node_id} removed")
            # PGs with bundles on this node lose them
            for pg in self.placement_groups.values():
                if pg.state == "CREATED" and any(
                        b.node_id == node_id for b in pg.bundles):
                    self._teardown_pg(pg, reason=f"node {node_id} removed")
        for w in to_kill:
            if w.proc is not None:
                try:
                    w.proc.kill()
                except OSError:
                    pass
            # death is then observed via disconnect -> _mark_worker_dead
        self._wake.set()
        return True

    def _op_shutdown_cluster(self, conn, msg):
        """Remote shutdown (CLI `ray-tpu stop`). Stops off-thread so the
        reply can flush first."""
        threading.Thread(target=self.stop, daemon=True,
                         name="cluster-shutdown").start()
        return True

    def _op_get_load(self, conn, msg):
        """Cluster load snapshot for the autoscaler (counterpart of the
        GCS AutoscalerStateService GetClusterResourceState,
        autoscaler.proto:315 / gcs_autoscaler_state_manager.cc)."""
        with self.lock:
            self._drain_submit_ingress_locked()
            demands = [dict(s.resources) for s in self.pending_tasks]
            demands += [dict(s.resources) for s in self.pending_actors]
            # Unsatisfied worker-lease requests are task demand too
            # (owner-direct tasks never appear in pending_tasks).
            demands += [dict(pl["resources"])
                        for pl in self.pending_leases]
            pg_demands = [
                {"strategy": pg.strategy, "bundles": list(pg.bundle_specs)}
                for pg in self.placement_groups.values()
                if pg.state == "PENDING"
            ]
            nodes = [
                {"node_id": n.node_id, "is_head": n.is_head,
                 "alive": n.alive, "draining": n.draining,
                 "total": n.total.to_dict(),
                 "available": n.available.to_dict(),
                 "labels": dict(n.labels)}
                for n in self.nodes.values()
            ]
        return {"demands": demands, "pg_demands": pg_demands,
                "nodes": nodes}

    def _op_list_nodes(self, conn, msg):
        self._sample_head_stats()
        with self.lock:
            return [
                {"node_id": n.node_id, "alive": n.alive,
                 "draining": n.draining,
                 "is_head": n.is_head, "resources": n.total.to_dict(),
                 "available": n.available.to_dict(), "labels": n.labels,
                 "address": n.address, "stats": dict(n.stats)}
                for n in self.nodes.values()
            ]

    def _sample_head_stats(self):
        """The head has no reporter thread; sample its host stats on
        read (list_nodes is the only consumer) with the same helper the
        node reporters use."""
        sampler = getattr(self, "_head_stats_sampler", None)
        if sampler is None:
            from ray_tpu_torch.dashboard.reporter import HostStatsSampler

            sampler = self._head_stats_sampler = HostStatsSampler()
        try:
            with self.lock:
                # HEAD-LOCAL workers only: self.workers is the
                # cluster-wide registry (remote workers register with
                # their node_id), and the per-node gauge must not
                # attribute them to the head.
                nw = sum(1 for w in self.workers.values()
                         if w.state != "dead"
                         and w.node_id in ("", "head"))
            stats = sampler.sample(store=self.store, num_workers=nw)
            with self.lock:
                head = self.nodes.get("head")
                if head is not None:
                    head.stats = stats
        except Exception:
            pass

    # ------------------------------------------------------------------
    # Placement groups (counterpart of GcsPlacementGroupManager +
    # 2PC bundle reservation, gcs_placement_group_manager.h:230; bundle
    # policies scheduling/policy/bundle_scheduling_policy.h)
    def _try_reserve_pg(self, pg: PlacementGroupEntry) -> bool:
        """Lock held. Attempt to reserve all bundles atomically (the 2PC
        prepare/commit collapses to one step inside the control plane).
        SPREAD/STRICT_SPREAD walk the utilization-bucketed node index —
        O(bundles) amortized instead of O(nodes x bundles), the scan
        that collapsed create-ready throughput 3.6x at 1,000 PGs on the
        2,000-node sim.  Virtual availability is seeded lazily so a
        small PG on a huge cluster never materializes the full node
        table."""
        needs = [ResourceSet(b) for b in pg.bundle_specs]
        placement: List[str] = []
        # virtual availability during placement, seeded on first touch
        virt: Dict[str, ResourceSet] = {}

        def avail(node_id):
            v = virt.get(node_id)
            if v is None:
                v = virt[node_id] = self.nodes[node_id].available
            return v

        def fits(node_id, need):
            return need.is_subset_of(avail(node_id))

        strategy = pg.strategy
        idx = self._node_index
        if strategy in ("PACK", "STRICT_PACK"):
            alive = [n for n in self.nodes.values() if n.schedulable]
            # try to put everything on one node (best = most utilized that
            # fits all); PACK falls back to spreading the remainder.
            total = ResourceSet(_sum_bundles(pg.bundle_specs))
            for n in sorted(alive, key=self._utilization, reverse=True):
                if total.is_subset_of(n.available):
                    placement = [n.node_id] * len(needs)
                    break
            if not placement:
                if strategy == "STRICT_PACK":
                    return False
                placement = []
                for need in needs:
                    cand = next((n.node_id for n in sorted(
                        alive, key=self._utilization, reverse=True)
                        if fits(n.node_id, need)), None)
                    if cand is None:
                        return False
                    placement.append(cand)
                    virt[cand] = avail(cand).subtract(need)
        elif strategy in ("SPREAD", "STRICT_SPREAD"):
            used_nodes: Set[str] = set()
            placement = []
            if idx is not None:
                for bi, need in enumerate(needs):
                    def fresh_ok(nid, _n=need):
                        return (nid not in used_nodes
                                and _n.is_subset_of(avail(nid)))

                    pick = None
                    for bucket in idx.buckets_low_to_high():
                        pick = idx.probe(bucket, bi, fresh_ok)
                        if pick is not None:
                            break
                    if pick is None and strategy == "SPREAD":
                        # SPREAD tolerates reuse once fresh nodes run out
                        for bucket in idx.buckets_low_to_high():
                            pick = idx.probe(
                                bucket, bi,
                                lambda nid, _n=need:
                                _n.is_subset_of(avail(nid)))
                            if pick is not None:
                                break
                    if pick is None:
                        return False
                    placement.append(pick)
                    used_nodes.add(pick)
                    virt[pick] = avail(pick).subtract(need)
            else:
                alive = [n for n in self.nodes.values() if n.schedulable]
                for need in needs:
                    cands = [n for n in alive if fits(n.node_id, need)]
                    fresh = [n for n in cands
                             if n.node_id not in used_nodes]
                    pool = fresh if fresh else (
                        [] if strategy == "STRICT_SPREAD" else cands)
                    if not pool:
                        return False
                    node = min(pool, key=self._utilization)
                    placement.append(node.node_id)
                    used_nodes.add(node.node_id)
                    virt[node.node_id] = avail(node.node_id).subtract(need)
        else:
            raise ValueError(f"unknown PG strategy {strategy}")

        # commit
        pg.bundles = []
        for i, (need, node_id) in enumerate(zip(needs, placement)):
            node = self.nodes[node_id]
            node.available = node.available.subtract(need)
            self._index_touch(node_id)
            pg.bundles.append(Bundle(index=i, node_id=node_id,
                                     reserved=need, available=need))
        pg.state = "CREATED"
        if pg.ready_obj:
            self._store_object_locked(
                pg.ready_obj,
                inline=_serialized_true(), size=len(_serialized_true()),
                is_error=False)
        return True

    def _teardown_pg(self, pg: PlacementGroupEntry, reason: str):
        """Lock held. Return free bundle reservations; in-use portions come
        back via worker release. Kill actors placed in the PG."""
        for b in pg.bundles:
            node = self.nodes.get(b.node_id)
            if node is not None and node.alive:
                node.available = node.available.add(b.available)
                self._index_touch(b.node_id)
        pg.state = "REMOVED"
        pg.bundles = []
        self._journal_del(f"pg/{pg.pg_hex}")
        # exit workers charged against this PG
        for w in list(self.workers.values()):
            if w.charge and w.charge[0] == "pg" and w.charge[1] == pg.pg_hex:
                if w.conn is not None:
                    try:
                        w.conn.push({"op": "exit"})
                    except Exception:
                        pass
                elif w.state == "starting":
                    # Spawned but not yet registered: it can never receive
                    # the exit push, so mark dead now (releases the charge;
                    # an actor restart attempt then fails via
                    # _unschedulable_reason) and reap the process.  Should
                    # it still register, _op_worker_online sees state=dead
                    # and tells it to exit.
                    self._mark_worker_dead(w, reason)
                    if w.proc is not None:
                        try:
                            w.proc.terminate()
                        except Exception:
                            pass

    def _op_create_pg(self, conn, msg):
        pg = PlacementGroupEntry(
            pg_hex=msg["pg"], strategy=msg.get("strategy", "PACK"),
            bundle_specs=msg["bundles"], ready_obj=msg.get("ready_obj", ""),
            name=msg.get("name", ""))
        with self.lock:
            self.placement_groups[pg.pg_hex] = pg
            if pg.ready_obj:
                self.objects.setdefault(pg.ready_obj, ObjectEntry())
            self._try_reserve_pg(pg)
            self._journal_put(f"pg/{pg.pg_hex}", {
                "strategy": pg.strategy,
                "bundle_specs": pg.bundle_specs,
                "name": pg.name,
                "ready_obj": pg.ready_obj})
        self._wake.set()

    def _op_remove_pg(self, conn, msg):
        with self.lock:
            pg = self.placement_groups.get(msg["pg"])
            if pg is None:
                return False
            if pg.state == "CREATED":
                self._teardown_pg(pg, "removed")
            else:
                pg.state = "REMOVED"
                self._journal_del(f"pg/{pg.pg_hex}")
        self._wake.set()
        return True

    def _op_pg_state(self, conn, msg):
        with self.lock:
            pg = self.placement_groups.get(msg["pg"])
            if pg is None:
                return None
            return {
                "state": pg.state, "strategy": pg.strategy,
                "bundles": [
                    {"index": b.index, "node_id": b.node_id,
                     "reserved": b.reserved.to_dict(),
                     "available": b.available.to_dict()}
                    for b in pg.bundles],
            }

    def _op_list_placement_groups(self, conn, msg):
        with self.lock:
            return [
                {"pg_id": h, "state": pg.state, "strategy": pg.strategy,
                 "name": pg.name, "bundles": pg.bundle_specs}
                for h, pg in self.placement_groups.items()
            ]

    def _op_cancel_object(self, conn, msg):
        """Cancel the task producing this object (ray.cancel(ref))."""
        with self.lock:
            entry = self._object_entry_or_drain_locked(msg["obj"])
            task_hex = entry.producing_task if entry is not None else None
        if not task_hex:
            return False
        return self._op_cancel_task(conn, {"task_id": task_hex,
                                           "force": msg.get("force", False)})

    # ------------------------------------------------------------------
    # Task cancel (counterpart of CoreWorker::CancelTask semantics)
    def _op_cancel_task(self, conn, msg):
        task_hex = msg["task_id"]
        force = msg.get("force", False)
        with self.lock:
            if self._ingress_pending():
                self._drain_submit_ingress_locked()
            rec = self.tasks.get(task_hex)
            if rec is None:
                return False
            if rec.state == "PENDING":
                self.pending_tasks = [
                    s for s in self.pending_tasks
                    if s.task_id.hex() != task_hex]
                rec.state = "CANCELLED"
                self._fail_task_returns_with(
                    rec.spec, "task cancelled", kind="cancelled")
                return True
            if rec.state == "RUNNING" and force:
                w = self.workers.get(rec.worker_hex)
                node = self.nodes.get(w.node_id) if w is not None else None
                killable = w is not None and (
                    w.proc is not None
                    or (node is not None and node.conn is not None))
                if killable:
                    rec.spec.max_retries = rec.spec.retry_count  # no retry
                    rec.state = "CANCELLED"
                    self._fail_task_returns_with(
                        rec.spec, "task cancelled (force)", kind="cancelled")
                    # Kill + mark dead under the lock: releasing first would
                    # let the worker finish, grab another task, and eat the
                    # SIGKILL meant for this one.  kill() is non-blocking.
                    if w.proc is not None:
                        try:
                            w.proc.kill()
                        except OSError:
                            pass
                    else:
                        # Remote worker: its node manager owns the Popen.
                        try:
                            node.conn.push({"op": "kill_worker",
                                            "worker_hex": w.worker_hex})
                        except Exception:
                            pass
                    self._mark_worker_dead(w, "task cancelled")
                    return True
            return False  # running w/o force, or already finished

    def _fail_task_returns_with(self, spec: TaskSpec, reason: str,
                                kind: str = "crashed"):
        """Lock held. kind: crashed | cancelled | unschedulable."""
        from ray_tpu_torch.core.exceptions import (
            TaskCancelledError,
            TaskUnschedulableError,
            WorkerCrashedError,
        )
        from ray_tpu_torch.core.serialization import serialize

        cls = {"cancelled": TaskCancelledError,
               "unschedulable": TaskUnschedulableError}.get(
                   kind, WorkerCrashedError)
        data = serialize(cls(
            f"task {spec.name or spec.task_id.hex()}: {reason}")).to_bytes()
        for oid in spec.return_ids:
            entry = self.objects.get(oid.hex())
            if entry is None or entry.state == PENDING:
                self._store_object_locked(
                    oid.hex(), inline=data, size=len(data), is_error=True)
        if getattr(spec, "is_streaming", False):
            # Streaming tasks have no pre-registered returns: fail the
            # end-of-stream object so iterating generators surface the
            # error instead of waiting forever on the next item.
            from ray_tpu_torch.core.streaming import stream_eos_id

            eos_hex = stream_eos_id(spec.task_id).hex()
            entry = self.objects.get(eos_hex)
            if entry is None or entry.state == PENDING:
                self._store_object_locked(
                    eos_hex, inline=data, size=len(data), is_error=True)

    # ------------------------------------------------------------------
    # Scheduler (counterpart of ClusterTaskManager::ScheduleAndDispatchTasks)
    def _next_wake_timeout(self) -> float:
        """How long the scheduler may park with no explicit wake.
        Short (0.5 s) only while time-driven state machines are live —
        starting workers, node drains, queued actors/PGs, deferred
        tasks; the watchdog interval when enabled; else the idle
        ceiling (RAY_TPU_SCHED_IDLE_WAIT_S).  Queued-lease expiry is
        armed on the timer wheel, so wakeups are O(pending timers)
        rather than O(polls)."""
        if self._ingress_pending():
            return 0.0  # submissions already staged: pass immediately
        with self.lock:
            busy = bool(
                self.pending_tasks
                or self.pending_actors
                or self._drain_migrating
                or any(pg.state == "PENDING"
                       for pg in self.placement_groups.values())
                or any(w.state == "starting"
                       for w in self.workers.values()))
            lease_deadline = self.pending_leases.earliest_deadline()
        if lease_deadline is not None:
            self._arm_lease_timer(lease_deadline)
        if busy:
            return 0.5
        if self._watchdog is not None:
            return min(self._idle_wait_s,
                       max(0.5, self._watchdog.interval_s))
        return self._idle_wait_s

    def _arm_lease_timer(self, deadline: float):
        """One wheel timer covers the earliest queued-lease expiry;
        re-armed only when the deadline moves earlier or the old timer
        already fired."""
        t = self._lease_timer
        now = time.time()
        if t is not None and not t.cancelled and t.deadline > now \
                and t.deadline <= deadline + 0.05:
            return
        if t is not None:
            t.cancel()
        from ray_tpu_torch.util import timer_wheel

        self._lease_timer = timer_wheel.wheel().schedule(
            max(0.0, deadline - now) + 0.01, self._wake.set,
            label="lease_expiry")

    def _schedule_loop(self):
        while not self._stopped.is_set():
            self._wake.wait(timeout=self._next_wake_timeout())
            self._wake.clear()
            if self._stopped.is_set():
                return
            try:
                self._schedule_once()
            except Exception:
                import traceback

                traceback.print_exc()
            try:
                self._check_drains()
            except Exception:
                import traceback

                traceback.print_exc()
            try:
                self._sync_resource_view()
            except Exception:
                pass
            # Health watchdog: when disabled the object is None and
            # this gate is the hot path's ONLY trace of it; when
            # enabled, maybe_tick self-rate-limits to its interval.
            if self._watchdog is not None:
                self._watchdog.maybe_tick()

    # -- resource-view sync (N8; reference common/ray_syncer/ -----------
    # ray_syncer.h:88 RESOURCE_VIEW stream).  The head is the view's
    # source of truth (it charges/releases all resources), so the sync
    # is a debounced head -> node-manager broadcast of per-node
    # availability; node managers serve it locally (cluster_view /
    # available_resources ops) so colocated workers' resource queries
    # and future local decisions need not transit the head.
    def _sync_resource_view(self):
        now = time.monotonic()
        if now - getattr(self, "_view_last_sync", 0.0) < 0.2:
            return
        with self.lock:
            view = {
                nid: {"total": n.total.to_dict(),
                      "available": n.available.to_dict(),
                      "alive": n.alive, "is_head": n.is_head,
                      "labels": dict(n.labels)}
                for nid, n in self.nodes.items()
            }
            targets = [n.conn for n in self.nodes.values()
                       if n.conn is not None and n.alive]
        self._view_last_sync = now
        if not targets:
            # Nothing listening: do NOT record the view as sent — a
            # manager joining later must still get the first broadcast.
            return
        if view == getattr(self, "_view_last", None):
            return
        self._view_last = view
        seq = self._view_seq = getattr(self, "_view_seq", 0) + 1
        # Epoch disambiguates head restarts: a restarted head's seq
        # counter restarts, and managers must not reject it as stale.
        epoch = getattr(self, "_view_epoch", None)
        if epoch is None:
            epoch = self._view_epoch = uuid.uuid4().hex[:12]
        msg = {"op": "resource_view", "seq": seq, "epoch": epoch,
               "nodes": view}
        for conn in targets:
            try:
                conn.push(msg)
            except Exception:
                pass  # node death handled by its disconnect

    def _deps_ready(self, spec: TaskSpec) -> bool:
        for arg in spec.args:
            if arg.is_ref:
                entry = self.objects.get(arg.object_hex)
                if entry is None or entry.state == PENDING:
                    return False
        return True

    # -- resource charge/release (node- or bundle-scoped) ---------------
    def _release(self, w: WorkerInfo):
        """Lock held. Return a worker's acquired resources to where they
        were charged (PG bundle, else its node)."""
        if w.acquired.is_empty():
            w.charge = ()
            return
        ch = w.charge
        acquired, w.acquired = w.acquired, ResourceSet()
        w.charge = ()
        if ch and ch[0] == "pg":
            pg = self.placement_groups.get(ch[1])
            if (pg is not None and pg.state == "CREATED"
                    and ch[2] < len(pg.bundles)):
                b = pg.bundles[ch[2]]
                b.available = b.available.add(acquired)
                return
            # PG gone: its reservation was partially returned at removal;
            # the in-use remainder goes back to the node now.
        node = self.nodes.get(w.node_id)
        if node is not None and node.alive:
            node.available = node.available.add(acquired)
            self._index_touch(node.node_id)

    def _utilization(self, node: NodeState,
                     avail: Optional[ResourceSet] = None) -> float:
        tot = node.total.to_dict()
        av = (node.available if avail is None else avail).to_dict()
        utils = [1.0 - av.get(k, 0.0) / v for k, v in tot.items() if v > 0]
        return max(utils, default=0.0)

    def _task_arg_bytes(self, spec) -> int:
        """Lock held.  Total READY bytes of the spec's ref args (the
        watchdog's straggler size-bucket input).  Captured at dispatch
        while the running task still pins its args; inline and
        still-pending args contribute nothing."""
        total = 0
        for arg in getattr(spec, "args", ()):
            if not getattr(arg, "is_ref", False):
                continue
            entry = self.objects.get(arg.object_hex)
            if entry is not None and entry.state == READY:
                total += entry.size or 0
        return total

    def _locality_bytes(self, spec) -> Dict[str, int]:
        """Lock held.  Bytes of the spec's shm ref args already resident
        on each node — primary copy or pulled replica, straight from the
        object directory (the reference's locality-aware lease policy
        consults its object directory the same way,
        locality_data_provider in lease_policy.cc).  Inline and
        still-pending args contribute nothing."""
        out: Dict[str, int] = {}
        now = time.time()
        for arg in getattr(spec, "args", ()):
            if not getattr(arg, "is_ref", False):
                continue
            entry = self.objects.get(arg.object_hex)
            if entry is None or entry.state != READY or not entry.in_shm:
                continue
            locs = {entry.node_id, *entry.replicas}
            if entry.pulling:
                # Credit in-flight pull destinations too (the transfer
                # will land before or with the task); drop announces
                # older than the pull deadline — that pull failed.
                stale = [nid for nid, ts in entry.pulling.items()
                         if now - ts > 150.0]
                for nid in stale:
                    del entry.pulling[nid]
                locs.update(entry.pulling)
            for nid in locs:
                out[nid] = out.get(nid, 0) + entry.size
        return out

    @staticmethod
    def _locality_enabled() -> bool:
        return os.environ.get("RAY_TPU_NO_LOCALITY", "").strip().lower() \
            not in ("1", "true", "yes")

    def _pick_node(self, need: ResourceSet, spec,
                   avail_of=None) -> Optional[tuple]:
        """Lock held. Choose a node (or PG bundle) for this task/actor.

        Returns (node_id, charge_tuple) or None if nothing is feasible now.
        `avail_of(charge) -> ResourceSet` overrides the availability view —
        the task loop passes its *virtual* view (actual minus claims of
        still-pending tasks) so a saturated head spills work to other nodes
        instead of queueing everything on the packed node.
        Policy parity: hybrid pack-then-spread default
        (scheduling/policy/hybrid_scheduling_policy.h:50), SPREAD
        round-robin, node-affinity, PG bundles (bundle_pack/spread)."""
        if avail_of is None:
            avail_of = self._charge_avail
        # Placement-group bundle placement
        pg_hex = getattr(spec, "placement_group_hex", "")
        if pg_hex:
            pg = self.placement_groups.get(pg_hex)
            if pg is None or pg.state != "CREATED":
                return None
            indices = ([spec.bundle_index] if spec.bundle_index >= 0
                       else range(len(pg.bundles)))
            for i in indices:
                if i >= len(pg.bundles):
                    return None
                b = pg.bundles[i]
                node = self.nodes.get(b.node_id)
                if (node is not None and node.schedulable
                        and need.is_subset_of(avail_of(("pg", pg_hex, i)))):
                    return b.node_id, ("pg", pg_hex, i)
            return None

        def node_avail(n):
            return avail_of(("node", n.node_id))

        st = getattr(spec, "scheduling_strategy", None)
        if st is not None and type(st).__name__ == "NodeAffinitySchedulingStrategy":
            node = self.nodes.get(st.node_id)
            if (node is not None and node.schedulable
                    and need.is_subset_of(node_avail(node))):
                return node.node_id, ("node", node.node_id)
            if not st.soft:
                return None
            # soft: fall through to default policy
        idx = getattr(self, "_node_index", None)
        alive = [n for n in self.nodes.values() if n.schedulable] \
            if (idx is None
                or (st is not None
                    and type(st).__name__
                    == "NodeLabelSchedulingStrategy")) else []
        if st is not None and \
                type(st).__name__ == "NodeLabelSchedulingStrategy":
            hard = st.hard or {}
            soft = st.soft or {}

            def match(n, req):
                return all(n.labels.get(k) == v for k, v in req.items())

            labeled = [n for n in alive if match(n, hard)]
            pool = [n for n in labeled if match(n, soft)] if soft \
                else labeled
            feasible = [n for n in pool
                        if need.is_subset_of(node_avail(n))]
            if soft and not feasible:
                # Soft preference exhausted: any hard-matching node.
                feasible = [n for n in labeled
                            if need.is_subset_of(node_avail(n))]
            if not feasible:
                return None  # pending until a hard match has capacity
            node = min(feasible, key=lambda n: (
                self._utilization(n, node_avail(n)), n.node_id))
            return node.node_id, ("node", node.node_id)
        if idx is not None:
            # Utilization-bucketed candidate walk: O(1) amortized per
            # pick instead of an O(nodes) feasibility prefilter + sort.
            return self._pick_node_indexed(need, spec, st, node_avail)
        feasible = [n for n in alive if need.is_subset_of(node_avail(n))]
        if not feasible:
            return None

        def util(n):
            return self._utilization(n, node_avail(n))

        if st == "SPREAD":
            # least-utilized first; rotate among the tied minimum so
            # zero-resource tasks still fan out across nodes.  The tie-break
            # hashes the task id (not a global counter) so a task's target is
            # stable across scheduling passes while it waits for a worker.
            feasible.sort(key=lambda n: (util(n), n.node_id))
            lowest = util(feasible[0])
            ties = [n for n in feasible if util(n) == lowest]
            tid = getattr(spec, "task_id", None) or spec.actor_id
            # hash() (not a raw prefix slice): ids are counter-derived,
            # so any fixed byte slice can alias mod len(ties).
            node = ties[hash(tid.binary()) % len(ties)]
            return node.node_id, ("node", node.node_id)
        # hybrid default: pack onto the busiest node below the spread
        # threshold; above it, spread to the least utilized.  Utilization
        # ties break by bytes of this task's shm args already resident on
        # the candidate (locality-aware placement, reference
        # lease_policy.cc LocalityAwareLeasePolicy) — feasibility always
        # dominates, so locality never overrides resources.  Env
        # RAY_TPU_NO_LOCALITY=1 restores the legacy tie-break exactly
        # (with no locality data both keys collapse to the old ones).
        threshold = 0.5
        loc = (self._locality_bytes(spec) if self._locality_enabled()
               else {})
        below = [n for n in feasible if util(n) < threshold]
        if below:
            node = max(below, key=lambda n: (util(n),
                                             loc.get(n.node_id, 0),
                                             n.is_head))
        else:
            node = min(feasible, key=lambda n: (util(n),
                                                -loc.get(n.node_id, 0),
                                                not n.is_head))
        if loc.get(node.node_id, 0) > 0:
            if self._m_locality_hits is not None:
                self._m_locality_hits.inc()
        return node.node_id, ("node", node.node_id)

    def _pick_node_indexed(self, need: ResourceSet, spec, st,
                           node_avail) -> Optional[tuple]:
        """Lock held.  `_pick_node`'s SPREAD/hybrid tail over the
        utilization-bucketed index.  Bucket membership is computed from
        ACTUAL availability; feasibility is re-verified against the
        caller's (possibly virtual) view on every candidate, so a stale
        bucket can only cost placement optimality within one 1/8
        utilization slice, never correctness.  The PR-3 locality
        tie-break becomes an index consult: the nodes already holding
        this task's shm args are checked directly (O(arg locations))
        before the bucket walk."""
        idx = self._node_index
        nodes = self.nodes

        def fits(nid):
            n = nodes.get(nid)
            return (n is not None and n.schedulable
                    and need.is_subset_of(node_avail(n)))

        # Scarce-resource shortcut: when the ask names a resource only
        # a handful of nodes have free (GPU on a CPU-heavy cluster),
        # iterate that free set directly.
        res_names = [r for r, v in need.to_dict().items() if v > 0]
        scarce = idx.scarce_set(res_names) if res_names else None
        if scarce is not None:
            best, best_u = None, None
            for nid in scarce:
                if not fits(nid):
                    continue
                u = self._utilization(nodes[nid], node_avail(nodes[nid]))
                if best_u is None or u < best_u:
                    best, best_u = nid, u
            return (best, ("node", best)) if best is not None else None

        if st == "SPREAD":
            # Lowest non-empty utilization bucket = the tie set; the
            # task-id hash seeds the probe so a waiting task's target
            # is stable across passes while equal-utilization nodes
            # still fan out.
            tid = getattr(spec, "task_id", None) or spec.actor_id
            seed = hash(tid.binary())
            for bucket in idx.buckets_low_to_high():
                nid = idx.probe(bucket, seed, fits)
                if nid is not None:
                    return nid, ("node", nid)
            return None

        # hybrid pack-then-spread (threshold 0.5), locality consult
        # first: a fitting below-threshold node already holding the
        # most arg bytes wins outright.
        loc = (self._locality_bytes(spec) if self._locality_enabled()
               else {})
        if loc:
            best, best_bytes = None, 0
            for nid, nbytes in sorted(loc.items(),
                                      key=lambda kv: -kv[1]):
                if nbytes <= best_bytes or not fits(nid):
                    continue
                n = nodes[nid]
                if self._utilization(n, node_avail(n)) < 0.5:
                    best, best_bytes = nid, nbytes
            if best is not None:
                if self._m_locality_hits is not None:
                    try:
                        self._m_locality_hits.inc()
                    except Exception:  # raylint: allow-swallow(telemetry only)
                        pass
                return best, ("node", best)
        # pack: most-utilized bucket below the spread threshold first
        for bucket in idx.buckets_high_to_low(below=0.5):
            nid = idx.probe(bucket, 0, fits)
            if nid is not None:
                return nid, ("node", nid)
        # nothing below threshold fits: spread to the least utilized
        for bucket in idx.buckets_low_to_high():
            nid = idx.probe(bucket, 0, fits)
            if nid is not None:
                return nid, ("node", nid)
        return None

    def _unschedulable_reason(self, spec) -> Optional[str]:
        """Lock held. Non-None if the spec can NEVER schedule — removed PG,
        out-of-range bundle index, or hard node affinity to a dead/missing
        node.  The reference fails these fast with a scheduling error
        (TaskUnschedulableError) rather than pending forever."""
        pg_hex = getattr(spec, "placement_group_hex", "")
        if pg_hex:
            pg = self.placement_groups.get(pg_hex)
            if pg is None or pg.state == "REMOVED":
                return "placement group removed"
            bi = getattr(spec, "bundle_index", -1)
            if bi >= len(pg.bundle_specs):
                return (f"bundle index {bi} out of range "
                        f"(placement group has {len(pg.bundle_specs)})")
            return None
        st = getattr(spec, "scheduling_strategy", None)
        if (st is not None
                and type(st).__name__ == "NodeAffinitySchedulingStrategy"
                and not st.soft):
            node = self.nodes.get(st.node_id)
            if node is None or not node.alive:
                return f"node {st.node_id} is dead or does not exist"
        renv = getattr(spec, "runtime_env", None)
        if renv:
            key = self._env_key_for(spec.resources, renv)
            entry = self.broken_envs.get(key)
            if entry is not None:
                err, poisoned_at = entry
                if time.time() - poisoned_at <= self.broken_env_ttl_s:
                    return f"runtime_env setup failed: {err}"
                del self.broken_envs[key]  # expired: allow a fresh try
        return None

    def _index_touch(self, node_id: str):
        if self._node_index is not None:
            self._node_index.touch(node_id)

    def _index_rebuild(self):
        if self._node_index is not None:
            self._node_index.rebuild()

    def _charge_avail(self, charge: tuple) -> ResourceSet:
        """Lock held. Resolve a charge tuple to its current availability."""
        if charge[0] == "pg":
            pg = self.placement_groups.get(charge[1])
            return (pg.bundles[charge[2]].available
                    if pg is not None and charge[2] < len(pg.bundles)
                    else ResourceSet())
        node = self.nodes.get(charge[1])
        return node.available if node is not None else ResourceSet()

    def _charge_target_subtract(self, charge: tuple, need: ResourceSet):
        """Lock held."""
        if charge[0] == "pg":
            b = self.placement_groups[charge[1]].bundles[charge[2]]
            b.available = b.available.subtract(need)
        else:
            node = self.nodes[charge[1]]
            node.available = node.available.subtract(need)
            self._index_touch(charge[1])

    def _schedule_once(self):
        self._reap_unregistered_workers()
        with self.lock:
            self._drain_submit_ingress_locked()
            # 0. retry pending placement groups (resources may have freed or
            # nodes joined — reference GcsPlacementGroupManager retry loop)
            for pg in self.placement_groups.values():
                if pg.state == "PENDING":
                    self._try_reserve_pg(pg)

            # 1. actors first (they need fresh workers)
            still_pending_actors = []
            to_spawn = []
            for spec in self.pending_actors:
                need = ResourceSet(spec.resources)
                why = self._unschedulable_reason(spec)
                if why is not None:
                    entry = self.actors.get(spec.actor_id.hex())
                    if entry is not None:
                        entry.state = A_DEAD
                        entry.death_reason = why
                        self._push_actor_update(entry, spec.actor_id.hex())
                        self._fail_actor_inflight(spec.actor_id.hex(), why)
                    continue
                pick = self._pick_node(need, spec)
                if pick is None:
                    still_pending_actors.append(spec)
                    continue
                node_id, charge = pick
                self._charge_target_subtract(charge, need)
                to_spawn.append((spec, need, node_id, charge))
            self.pending_actors = still_pending_actors

            # 2. normal tasks to idle pool workers on their chosen node
            dispatches = []
            still_pending = []
            idle = {
                h: w for h, w in self.workers.items()
                if w.kind == "pool" and w.state == "idle" and w.conn is not None
            }
            # Per-node worker counts: max_workers_per_node caps each node's
            # pool, not the cluster (a full head must not starve new nodes).
            node_workers: Dict[str, int] = {}
            # Workers already starting, per (node, env_key): spawn only the
            # deficit (reference WorkerPool prestart accounting,
            # worker_pool.h:159).
            starting: Dict[tuple, int] = {}
            for w in self.workers.values():
                if w.kind == "pool" and w.state != "dead":
                    node_workers[w.node_id] = node_workers.get(
                        w.node_id, 0) + 1
                    if w.state == "starting":
                        key = (w.node_id, w.env_key)
                        starting[key] = starting.get(key, 0) + 1
            # Virtual availability per charge target (node or PG bundle):
            # resources that would be in use if every
            # dispatchable-but-workerless task had its worker.
            avail_virtual: Dict[tuple, ResourceSet] = {}

            def virt_get(charge):
                if charge not in avail_virtual:
                    avail_virtual[charge] = self._charge_avail(charge)
                return avail_virtual[charge]
            # A pass can place at most len(idle) tasks plus whatever new
            # workers could still spawn; once that budget is spent, the
            # rest of the queue cannot make progress THIS pass — bulk-
            # defer it instead of rescanning (keeps each wake O(capacity)
            # rather than O(pending), which made big async batches
            # quadratic: every task_done re-scanned the whole queue).
            spawn_headroom = sum(
                max(0, self.config.max_workers_per_node
                    - node_workers.get(nid, 0))
                for nid, node in self.nodes.items() if node.alive)
            budget = len(idle) + spawn_headroom
            progress = 0
            # Per-pass infeasibility memo: once a (resources, placement)
            # shape fails to place, identical later requests are skipped
            # in O(1). A saturated homogeneous queue (the common case:
            # thousands of same-shaped tasks) costs one real placement
            # attempt per pass instead of one per task — this is what
            # keeps big async batches from going quadratic.
            infeasible: set = set()

            def _shape_key(s):
                return (tuple(sorted(s.resources.items())),
                        s.placement_group_hex, s.bundle_index,
                        repr(s.scheduling_strategy))

            for spec in self.pending_tasks:
                if not self._deps_ready(spec):
                    still_pending.append(spec)
                    continue
                # The unschedulable fast-fail must run for EVERY ready
                # spec, even when the pass's placement budget is spent —
                # a removed-PG/dead-node task that merely stays pending
                # on a saturated cluster would deadlock its waiters.
                why = self._unschedulable_reason(spec)
                if why is not None:
                    rec = self.tasks.get(spec.task_id.hex())
                    if rec is not None:
                        rec.state = "FAILED"
                    self._fail_task_returns_with(
                        spec, why, kind="unschedulable")
                    continue
                shape = _shape_key(spec)
                if progress >= budget or shape in infeasible:
                    still_pending.append(spec)
                    continue
                need = ResourceSet(spec.resources)
                pick = self._pick_node(need, spec, avail_of=virt_get)
                if pick is None:
                    infeasible.add(shape)
                    still_pending.append(spec)
                    continue
                node_id, charge = pick
                env_key = self._env_key_for(spec.resources, spec.runtime_env)
                worker = next(
                    (w for w in idle.values()
                     if w.env_key == env_key and w.node_id == node_id), None)
                if worker is None:
                    virt = virt_get(charge)
                    if need.is_subset_of(virt):
                        avail_virtual[charge] = virt.subtract(need)
                        key = (node_id, env_key)
                        if starting.get(key, 0) > 0:
                            starting[key] -= 1  # one already on the way
                            progress += 1  # a worker really is incoming
                        elif (node_workers.get(node_id, 0)
                                < self.config.max_workers_per_node):
                            self._spawn_worker(env_key=env_key, kind="pool",
                                               node_id=node_id)
                            node_workers[node_id] = node_workers.get(
                                node_id, 0) + 1
                            progress += 1
                    still_pending.append(spec)
                    continue
                del idle[worker.worker_hex]
                virt = virt_get(charge)  # snapshot BEFORE charging
                self._charge_target_subtract(charge, need)
                if need.is_subset_of(virt):
                    avail_virtual[charge] = virt.subtract(need)
                worker.acquired = need
                worker.charge = charge
                worker.state = "busy"
                worker.current_task = spec.task_id.hex()
                rec = self.tasks.get(spec.task_id.hex())
                if rec is not None:
                    rec.state = "RUNNING"
                    rec.worker_hex = worker.worker_hex
                    rec.started_at = time.time()
                    rec.arg_bytes = self._task_arg_bytes(spec)
                dispatches.append((worker, spec))
                progress += 1
            self.pending_tasks = still_pending

            for spec, need, node_id, charge in to_spawn:
                w = self._spawn_worker(
                    env_key=self._env_key_for(spec.resources, spec.runtime_env),
                    kind="actor", node_id=node_id)
                w.acquired = need
                w.charge = charge
                w.actor_hex = spec.actor_id.hex()
                entry = self.actors.get(spec.actor_id.hex())
                if entry is not None:
                    entry.worker_hex = w.worker_hex
                # queue the creation spec; delivered when the worker registers
                w.pending_create = spec  # type: ignore[attr-defined]

            # 3. queued lease requests take what's left (tasks/actors
            # queued at the head go first — they were already waiting).
            lease_grants = self._try_grant_leases_locked()

        if lease_grants:
            self._push_lease_grants(lease_grants)
        for worker, spec in dispatches:
            try:
                worker.conn.push({"op": "execute_task", "spec": spec})
            except Exception:
                with self.lock:
                    self._mark_worker_dead(worker, "push failed")

    def _env_key_for(self, resources: Dict[str, float],
                     runtime_env: Optional[dict]) -> str:
        gpu = resources.get(GPU, 0) if resources else 0
        env_part = ""
        if runtime_env:
            import hashlib
            import json

            env_part = hashlib.sha1(
                json.dumps(runtime_env, sort_keys=True).encode()).hexdigest()[:8]
        # The share as asked ("gpu0.5-"), not int(share): a fractional
        # lease of a card needs a GPU-class worker (the reference's
        # int() makes a 0.5-chip worker chip-less).
        key = f"gpu{gpu:g}-{env_part}"
        if runtime_env:
            self.runtime_envs.setdefault(key, dict(runtime_env))
        return key

    def _op_free_stream(self, conn, msg):
        """Release a dropped ObjectRefGenerator's unconsumed items (and
        its eos object if the consumer never read it). Only acts on
        finished streams — a live one still needs its slots."""
        from ray_tpu_torch.core.serialization import deserialize
        from ray_tpu_torch.core.streaming import stream_eos_id, stream_item_id
        from ray_tpu_torch.core.ids import TaskID

        task_id = TaskID.from_hex(msg["task"])
        eos_hex = stream_eos_id(task_id).hex()
        start = int(msg.get("from_index", 0))
        known_count = msg.get("count")
        if known_count is not None:
            # The consumer read the EOS (whose decref may already have
            # deleted it here): free directly from the count it learned
            # — no EOS lookup, no parking.
            targets = [stream_item_id(task_id, i).hex()
                       for i in range(start, int(known_count))]
            if not msg.get("eos_consumed", False):
                targets.append(eos_hex)
            for obj_hex in targets:
                self._op_decref(conn, {"obj": obj_hex})
            return
        with self.lock:
            eos = self.objects.get(eos_hex)
            if eos is None or eos.state == PENDING:
                # Stream still running (or its EOS put is still in
                # flight — item puts and the EOS are separate frames, so
                # a consumer can observe the tail item and drop the
                # generator before the EOS lands): park the free and
                # apply it when the EOS stores (_store_object_locked).
                # A CONSUMED EOS (the normal fully-drained lifecycle)
                # was decref-deleted and will never store again — there
                # is nothing left to free, so parking it would leak one
                # entry per drained stream.
                if not msg.get("eos_consumed", False):
                    frees = getattr(self, "_pending_stream_frees", None)
                    if frees is None:
                        frees = self._pending_stream_frees = {}
                    if len(frees) >= 4096:  # bound pathological growth
                        frees.pop(next(iter(frees)))
                    frees[eos_hex] = dict(msg)
                return
            count = None
            if eos.state == READY and eos.inline is not None:
                try:
                    count = int(deserialize(eos.inline))
                except Exception:
                    count = None
            if count is None:
                # ERRORED EOS (producer died mid-stream) carries no item
                # count: probe a bounded id range — decref no-ops on
                # ids that were never stored.
                count = start + 4096
            targets = [stream_item_id(task_id, i).hex()
                       for i in range(start, count)]
            if not msg.get("eos_consumed", False):
                targets.append(eos_hex)
        for obj_hex in targets:
            self._op_decref(conn, {"obj": obj_hex})

    # -- cross-node object plane ---------------------------------------
    def _node_client(self, node_id: str) -> Optional[rpc.Client]:
        """Head-side rpc client to a node manager's object server."""
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None or not node.alive or not node.address:
                return None
            address = node.address
        clients = getattr(self, "_node_clients", None)
        if clients is None:
            clients = self._node_clients = {}
        client = clients.get(address)
        if client is None or client._closed:
            try:
                client = rpc.Client(address, connect_timeout=2.0)
            except Exception:
                return None
            racer = clients.setdefault(address, client)
            if racer is not client:  # another handler dialed first
                if racer._closed:
                    clients[address] = client
                else:
                    client.close()
                    client = racer
        return client

    def _pull_node_object(self, node_id: str, obj_hex: str,
                          size: int) -> Optional[bytes]:
        """Pull a whole object's bytes from its holding node (chunked,
        windowed like every other puller)."""
        client = self._node_client(node_id)
        if client is None:
            return None
        try:
            return rpc.pull_object_chunked(
                client, obj_hex, size, self.config.transfer_chunk_bytes,
                window=self.config.pull_window)
        except Exception:
            return None

    def _op_fetch_chunk(self, conn, msg):
        """Serve one chunk of a head-arena object to a remote puller
        (reference ObjectManager chunked Push/Pull,
        object_manager.h:206/:139).  The attach stays cached in the
        store until the object is deleted, so concurrent chunk reads of
        one object never race a release."""
        obj_hex = msg["obj"]
        with self.lock:
            entry = self.objects.get(obj_hex)
            node_loc = entry.node_id if entry is not None else "head"
        if entry is None:
            return None
        if node_loc != "head":
            # Rare proxy case (location moved between the client's info
            # snapshot and this request): pull-through from the real
            # node, caching the payload so the client's REMAINING chunk
            # requests for this object don't each re-pull the whole
            # thing (one-entry cache; the window is one transfer).
            with self.lock:
                cached = getattr(self, "_proxy_cache", None)
            if cached is None or cached[0] != obj_hex:
                data = self._pull_node_object(node_loc, obj_hex,
                                              msg["size"])
                if data is None:
                    return None
                with self.lock:
                    self._proxy_cache = (obj_hex, data)
                cached = (obj_hex, data)
            part = cached[1][msg["offset"]:msg["offset"] + msg["length"]]
            if msg["offset"] + msg["length"] >= msg["size"]:
                # Final chunk served: drop the (potentially 100s-of-MB)
                # payload instead of pinning it in head memory until the
                # next proxy pull happens to evict it.
                with self.lock:
                    if getattr(self, "_proxy_cache", None) is not None \
                            and self._proxy_cache[0] == obj_hex:
                        self._proxy_cache = None
            object_plane.OBJ._inc("bytes_pushed", len(part))
            return part
        seg = self.store.attach(ObjectID.from_hex(obj_hex), msg["size"])
        off, n = msg["offset"], msg["length"]
        part = bytes(seg.buf[off:off + n])
        object_plane.OBJ._inc("bytes_pushed", len(part))
        return part

    def _op_report_object_lost(self, conn, msg):
        """A client's pull from a remote node failed (the node's arena
        evicted/lost the copy while the node itself stays alive): verify
        with the node and fall back to lineage reconstruction — the
        remote-arena counterpart of the head's _shm_value_lost probe."""
        obj_hex = msg["obj"]
        with self.lock:
            entry = self.objects.get(obj_hex)
            if entry is None or not entry.in_shm or entry.restoring \
                    or entry.node_id == "head" or entry.state != READY:
                return False
            node_loc = entry.node_id
        client = self._node_client(node_loc)
        if client is not None:
            try:
                if client.call({"op": "has_object", "obj": obj_hex},
                               timeout=5.0):
                    return False  # still there; the pull failure was racy
            except Exception:
                pass  # node unreachable: treat as lost
        with self.lock:
            entry = self.objects.get(obj_hex)
            if entry is None or not entry.in_shm \
                    or entry.node_id != node_loc or entry.state != READY:
                return False
            entry.in_shm = False
            if not self._try_reconstruct_locked(obj_hex):
                self._store_lost_error_locked(
                    obj_hex, f"copy on node {node_loc} is gone and "
                    "lineage reconstruction was not possible")
        self._wake.set()
        return True

    def _op_object_shm_info(self, conn, msg):
        """Where a same-host native client can map an object zero-copy
        (the reference's plasma C++ client attach path: cpp frontends
        read sealed objects straight from the arena instead of proxying
        payloads through the server — object_manager/plasma/).  Replies
        with the head arena + store library paths only when the object's
        authoritative copy lives in the head arena; everything else is
        "not mappable here" and callers fall back to fetch_object."""
        obj_hex = msg["obj"]
        with self.lock:
            entry = self.objects.get(obj_hex)
            if entry is None or entry.state not in (READY, ERRORED) \
                    or not entry.in_shm or entry.spilled_uri is not None \
                    or entry.node_id != "head":
                return {"in_shm": False}
            size = entry.size
            is_error = entry.is_error
        arena = getattr(self.store, "_arena", None)
        if arena is None:
            return {"in_shm": False}  # file-per-object fallback store
        try:
            from ray_tpu_torch.native.store import library_path

            lib = library_path()
        except Exception:
            # No loadable store library -> the client cannot attach;
            # answer "not mappable" so it falls back to fetch_object.
            return {"in_shm": False}
        return {"in_shm": True, "arena": arena.path, "lib": lib,
                "size": size, "is_error": is_error}

    def _op_fetch_object(self, conn, msg):
        """Read an object's payload server-side for thin clients (no shm
        attachment — reference Ray Client server proxy role). Shm reads
        and spilled-object restores happen outside the lock."""
        obj_hex = msg["obj"]
        # with_meta callers get {"data", "is_error"} so they never rely on
        # a stale error flag cached before a reconstruction/lost event.
        with_meta = bool(msg.get("with_meta"))

        def reply(data, is_error):
            return {"data": data, "is_error": is_error} if with_meta \
                else data

        # Retry loop: the object can migrate between shm and external
        # storage (spill / concurrent restore) between the snapshot and
        # the read; re-reading the entry makes the race benign.
        for attempt in range(4):
            with self.lock:
                entry = self._object_entry_or_drain_locked(obj_hex)
                if entry is None or entry.state not in (READY, ERRORED):
                    return None
                if entry.inline is not None:
                    return reply(entry.inline, entry.is_error)
                size = entry.size
                spilled_uri = entry.spilled_uri
                is_error = entry.is_error
                node_loc = entry.node_id
            if spilled_uri is None and node_loc != "head":
                # Copy lives in a remote node's arena: pull it over the
                # object plane.  A failed pull means the node just died —
                # _handle_node_death kicks reconstruction; wait and retry.
                data = self._pull_node_object(node_loc, obj_hex, size)
                if data is not None:
                    return reply(data, is_error)
                self._await_object_settled(obj_hex, 30.0)
                continue
            if spilled_uri is not None:
                try:
                    return reply(self.external_storage.restore(spilled_uri),
                                 is_error)
                except Exception:
                    # Restored+deleted meanwhile (benign race) — or the
                    # spilled copy itself is gone; mirror
                    # _restore_and_publish: reconstruct from lineage or
                    # materialize the lost error, then wait it out.
                    with self.lock:
                        entry = self.objects.get(obj_hex)
                        if entry is not None \
                                and entry.spilled_uri == spilled_uri \
                                and not entry.restoring:
                            entry.spilled_uri = None
                            if not self._try_reconstruct_locked(obj_hex):
                                self._store_lost_error_locked(
                                    obj_hex, "spilled copy unreadable and "
                                    "lineage reconstruction not possible")
                    self._await_object_settled(obj_hex, 30.0)
                    continue
            try:
                oid = ObjectID.from_hex(obj_hex)
                seg = self.store.attach(oid, size)
                data = bytes(seg.buf[:size])
                self.store.release(oid)
                return reply(data, is_error)
            except Exception:
                # Spilled meanwhile (re-snapshot) — or the copy is gone,
                # in which case kick lineage reconstruction and wait for
                # the re-run to store the value; when reconstruction is
                # impossible, materialize ObjectLostError so this (and
                # every later) read returns the same error the subscribe
                # path serves.
                with self.lock:
                    entry = self.objects.get(obj_hex)
                    if entry is not None and \
                            self._shm_value_lost(obj_hex, entry):
                        if not self._try_reconstruct_locked(obj_hex):
                            self._store_lost_error_locked(
                                obj_hex, "shm copy gone and lineage "
                                "reconstruction not possible")
                self._await_object_settled(obj_hex, 30.0)
        return None

    def _await_object_settled(self, obj_hex: str, timeout: float) -> None:
        """Block until an object is READY/ERRORED and not mid-restore —
        i.e. until a kicked reconstruction/restore lands.  Event-driven:
        _store_object_locked and restore completion notify the settle
        condition, so waiters wake on the transition itself (the 1 s
        re-check only guards entry deletion, which doesn't notify)."""
        deadline = time.time() + timeout
        with self._obj_settled:
            while True:
                entry = self.objects.get(obj_hex)
                if entry is None:
                    return
                if entry.state in (READY, ERRORED) and \
                        not entry.restoring:
                    return
                remaining = deadline - time.time()
                if remaining <= 0:
                    return
                self._obj_settled.wait(min(remaining, 1.0))

    # ------------------------------------------------------------------
    # On-demand worker profiling (reference: dashboard reporter
    # profile_manager.py py-spy/memray drivers; plus torch.profiler
    # traces of live workers)
    def _op_profile_worker(self, conn, msg):
        """Ask a live worker for a profile; the reply resolves a
        Deferred so the CALLER's connection thread is never blocked (its
        other in-flight control calls proceed during a long trace).
        kind: 'stack' (all-thread dump) | 'torch_trace' (Chrome trace path).
        By default the wait outlasts a torch_trace's own bound (the
        window, a start and a stop of PROFILE_BOUND_S each, the export)."""
        from ray_tpu_torch.core.runtime import PROFILE_BOUND_S

        worker_hex = msg["worker_hex"]
        timeout = float(msg.get("timeout_s", 0) or
                        (float(msg.get("duration_s", 2.0))
                         + 2 * PROFILE_BOUND_S + 30.0))
        with self.lock:
            w = self.workers.get(worker_hex)
            if w is None or w.conn is None or w.state == "dead":
                raise ValueError(f"no live worker {worker_hex}")
            if w.conn is conn:
                # The reply would arrive on THIS connection, inside the
                # request the target would have to answer. Callers
                # profile themselves locally (state/api.py shortcut).
                raise ValueError(
                    "cannot profile the requesting process through the "
                    "control plane; take the dump locally")
            token = uuid.uuid4().hex
            deferred = rpc.Deferred()

            def on_timeout():
                entry = self._profile_waiters.pop(token, None)
                if entry is not None:
                    entry[0].reject(TimeoutError(
                        f"worker {worker_hex} did not reply to profile "
                        f"request within {timeout:.0f}s"))

            timer = threading.Timer(timeout, on_timeout)
            timer.daemon = True
            if not hasattr(self, "_profile_waiters"):
                self._profile_waiters = {}
            # Register BEFORE the push: a fast worker's reply must find
            # the waiter.
            self._profile_waiters[token] = (deferred, timer)
            w.conn.push({"op": "profile", "token": token,
                         "kind": msg.get("kind", "stack"),
                         "duration_s": float(msg.get("duration_s", 2.0))})
        timer.start()
        return deferred

    def _op_profile_result(self, conn, msg):
        entry = getattr(self, "_profile_waiters", {}).pop(
            msg.get("token"), None)
        if entry is not None:
            deferred, timer = entry
            timer.cancel()  # don't park a thread for the full timeout
            deferred.resolve(msg.get("data"))

    # ------------------------------------------------------------------
    # Cluster-wide span harvest (collect_spans wire op): the head pulls
    # each worker's bounded span ring incrementally — per-worker cursors
    # persist across harvests, each reply is capped so a 100k ring
    # streams out as many small frames — and accumulates the result in
    # a bounded trace_id-queryable store (the /api/spans and /api/trace
    # backing data).
    def _op_harvest_spans(self, conn, msg):
        """Harvest every live worker's ring, then return matching spans.
        Runs on its own thread behind a Deferred: the multi-round
        pull protocol must not park the caller's connection thread."""
        deferred = rpc.Deferred()

        def run():
            try:
                deferred.resolve(self._harvest_spans_sync(msg))
            except Exception as e:  # noqa: BLE001
                deferred.reject(e)

        threading.Thread(target=run, name="span-harvest",
                         daemon=True).start()
        return deferred

    def _harvest_spans_sync(self, msg) -> Dict[str, Any]:
        timeout_s = float(msg.get("timeout_s", 0) or 10.0)
        deadline = time.monotonic() + timeout_s
        since = float(msg.get("since", 0) or 0.0)
        # poll=False answers from the store alone (no worker round
        # trips) — the restart-replay read path, where the store was
        # rehydrated from the journal and the old workers are gone.
        do_poll = msg.get("poll")
        do_poll = True if do_poll is None else bool(do_poll)
        if do_poll:
            with self._harvest_lock:  # serialize: cursors shared state
                polled = self._harvest_all_workers(deadline)
        else:
            polled = 0
        trace_id = msg.get("trace_id") or ""
        max_spans = int(msg.get("max_spans", 0) or 0)
        with self._span_lock:
            missed = self._span_missed
            if not trace_id and not since and max_spans > 0:
                # Bounded tail without copying the whole store — the
                # 1 Hz-poller shape, where reply size is the cost.
                start = max(0, len(self._span_store) - max_spans)
                rows = list(itertools.islice(
                    self._span_store, start, len(self._span_store)))
            else:
                rows = list(self._span_store)
        if trace_id:
            rows = [r for r in rows if r[2] == trace_id]
        if since:
            # Time window: keep spans still running at `since` or ended
            # after it (row[5] is the span end timestamp).
            rows = [r for r in rows if r[5] >= since]
        if max_spans > 0:
            rows = rows[-max_spans:]
        # The store keeps compact collect_spans rows; only the reply —
        # already bounded — pays for dict expansion.
        from ray_tpu_torch.util.tracing import span_row_to_dict

        spans = [span_row_to_dict(r) for r in rows]
        return {"spans": spans, "workers_polled": polled,
                "missed": missed}

    def _harvest_all_workers(self, deadline: float) -> int:
        limit = _env_int("RAY_TPU_SPAN_HARVEST_CHUNK", 2048, 16)
        with self.lock:
            targets = [(wh, w.conn) for wh, w in self.workers.items()
                       if w.conn is not None and w.state != "dead"]
        polled = 0
        for worker_hex, wconn in targets:
            try:
                if self._harvest_one_worker(worker_hex, wconn, limit,
                                            deadline):
                    polled += 1
            except Exception:
                continue  # worker died mid-harvest; others still count
        return polled

    def _harvest_one_worker(self, worker_hex: str, wconn, limit: int,
                            deadline: float) -> bool:
        cursor = self._span_cursors.get(worker_hex, 0)
        replied = False
        # Per-sweep work bound: a worker emitting spans faster than the
        # sweep cadence can drain them must not turn one harvest into an
        # unbounded pull — the cursor persists, the next sweep continues
        # where this one stopped, and if the ring laps the cursor in the
        # meantime the worker reports it as `missed` (graceful data loss
        # over unbounded harvest CPU).
        max_chunks = _env_int("RAY_TPU_SPAN_HARVEST_MAX_CHUNKS", 8, 1)
        rounds = 0
        while rounds < max_chunks:
            rounds += 1
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            token = uuid.uuid4().hex
            ev = threading.Event()
            slot: Dict[str, Any] = {}
            # Register BEFORE the push (profile-waiter discipline).
            self._span_waiters[token] = (ev, slot)
            try:
                wconn.push({"op": "collect_spans", "token": token,
                            "cursor": cursor, "limit": limit})
            except Exception:
                self._span_waiters.pop(token, None)
                break
            if not ev.wait(timeout=min(remaining, 5.0)):
                self._span_waiters.pop(token, None)
                break
            reply = slot.get("msg") or {}
            replied = True
            cursor = int(reply.get("cursor", cursor) or 0)
            rows = reply.get("rows") or []
            self._ingest_spans(worker_hex, reply, rows)
            if len(rows) < limit:
                break  # ring drained
        self._span_cursors[worker_hex] = cursor
        return replied

    def _ingest_spans(self, worker_hex: str, reply: dict,
                      rows: List[list]) -> None:
        """Fold one collect_spans reply into the store, keeping the
        compact row form — (span_id, parent_id, trace_id, name, start,
        end, attrs, worker, pid) — so a high-rate harvest costs list
        appends, not 7-key dict builds per span (expansion is deferred
        to the bounded _harvest_spans_sync reply)."""
        pid = int(reply.get("pid") or 0)
        missed = int(reply.get("missed") or 0)
        added: List[list] = []
        with self._span_lock:
            for r in rows:
                sid = r[0]
                if sid in self._span_seen:
                    continue
                r.append(worker_hex)
                r.append(pid)
                if len(self._span_store) == self._span_store.maxlen \
                        and self._span_store:
                    self._span_seen.discard(self._span_store[0][0])
                self._span_seen.add(sid)
                self._span_store.append(r)
                added.append(r)
            if missed:
                self._span_missed += missed
        # Durable spill (outside the lock; append is an enqueue — the
        # journal's writer thread owns all disk IO).  The _span_seen
        # dedup above also keeps a post-restart re-harvest from
        # re-journaling rows the journal already holds.
        if added:
            from ray_tpu_torch.util import journal as ops_journal

            j = ops_journal.stream("spans")
            if j is not None:
                for r in added:
                    j.append(r)

    def _op_collect_spans_result(self, conn, msg):
        """One-way reply from a worker's collect_spans push: hand the
        payload to the waiting harvest round by token."""
        entry = self._span_waiters.pop(msg.get("token"), None)
        if entry is not None:
            ev, slot = entry
            slot["msg"] = msg
            ev.set()

    # ------------------------------------------------------------------
    # Per-worker resource profiling (profile_report deltas riding the
    # coalescing flusher) + watchdog introspection.
    def _op_profile_report(self, conn, msg):
        sample = msg.get("sample") or {}
        whex = sample.get("worker") or \
            getattr(conn, "meta", {}).get("worker_hex", "")
        if whex:
            with self.lock:
                self._profiles[whex] = sample
                ring = self._profile_hist.get(whex)
                if ring is None:
                    ring = self._profile_hist[whex] = deque(
                        maxlen=self._profile_hist_cap)
                ring.append(sample)

    def _op_get_profile(self, conn, msg):
        with self.lock:
            live = {wh for wh in self._profiles
                    if wh in self.workers
                    and self.workers[wh].state != "dead"}
            profiles = {wh: s for wh, s in self._profiles.items()
                        if wh in live}
            rings = {wh: list(ring)
                     for wh, ring in self._profile_hist.items()
                     if wh in live}
        history = {wh: _profile_history_summary(samples)
                   for wh, samples in rings.items()}
        if msg.get("samples"):
            for wh, summary in history.items():
                summary["raw"] = rings[wh]
        wd = (self._watchdog.snapshot() if self._watchdog is not None
              else {"enabled": False})
        return {"workers": profiles, "history": history,
                "history_capacity": self._profile_hist_cap,
                "watchdog": wd}

    def _op_set_profile_config(self, conn, msg):
        """Retune every live worker's resource sampler at runtime (the
        bench's A/B switch; also an operator knob for incident-time
        high-frequency sampling)."""
        cfg: Dict[str, Any] = {"op": "profile_config"}
        if msg.get("enabled") is not None:
            cfg["enabled"] = bool(msg["enabled"])
        if msg.get("interval_s") is not None:
            cfg["interval_s"] = float(msg["interval_s"])
        with self.lock:
            conns = [w.conn for w in self.workers.values()
                     if w.conn is not None and w.state != "dead"]
        notified = 0
        for c in conns:
            try:
                c.push(dict(cfg))
                notified += 1
            except Exception:
                pass
        return {"notified": notified}

    def _op_get_runtime_env(self, conn, msg):
        with self.lock:
            return self.runtime_envs.get(msg.get("env_key", ""))

    def _op_worker_setup_failed(self, conn, msg):
        """A worker's runtime-env setup raised: poison the env so pending
        and future work needing it fails fast (the worker exits itself)."""
        env_key = msg.get("env_key", "")
        error = msg.get("error", "runtime_env setup failed")
        with self.lock:
            self.broken_envs[env_key] = (error, time.time())
        self._wake.set()
        return True

    # ------------------------------------------------------------------
    # Worker pool (counterpart of raylet WorkerPool::StartWorkerProcess)
    def _spawn_worker(self, env_key: str, kind: str,
                      node_id: str = "head") -> WorkerInfo:
        """Lock held.  Local nodes fork the process here; remote nodes
        get a spawn_worker push to their manager (reference: the raylet
        owns worker processes on its host, worker_pool.h:159)."""
        from ray_tpu_torch.core.node_manager import spawn_worker_process

        worker_id = WorkerID.from_random()
        w = WorkerInfo(worker_hex=worker_id.hex(), kind=kind, env_key=env_key,
                       state="starting", node_id=node_id,
                       spawned_at=time.time())
        self.workers[worker_id.hex()] = w
        renv = self.runtime_envs.get(env_key)
        node = self.nodes.get(node_id)
        if node is not None and node.conn is not None:
            try:
                node.conn.push({
                    "op": "spawn_worker", "worker_hex": worker_id.hex(),
                    "kind": kind, "env_key": env_key,
                    "namespace": self.namespace,
                    # The container wrapper applies at SPAWN on the
                    # worker's own host (runtime_env/container.py).
                    "runtime_env": renv})
            except Exception:
                self._mark_worker_dead(w, "node manager unreachable")
            return w
        proc = spawn_worker_process(
            control_addr=self.address, worker_hex=worker_id.hex(),
            kind=kind, env_key=env_key, namespace=self.namespace,
            node_id=node_id,
            log_dir=os.path.join(self.session_dir, "logs"),
            session_id=self.session_id, runtime_env=renv)
        w.proc = proc
        w.pid = proc.pid
        return w

    def _reap_unregistered_workers(self):
        """A spawned worker that never registered within the timeout
        (its process died pre-registration, or its node crashed
        mid-spawn) will produce no disconnect event — observe the death
        here so its task/actor is retried instead of hanging.  Takes
        and releases the lock itself (remote liveness probes must not
        run under it)."""
        timeout = self.config.worker_register_timeout_s
        if timeout <= 0:
            return
        now = time.time()
        remote_suspects = []
        with self.lock:
            for w in list(self.workers.values()):
                if w.state != "starting" or w.conn is not None:
                    continue
                if not w.spawned_at or now - w.spawned_at < timeout:
                    continue
                if w.proc is not None:
                    if w.proc.poll() is None:
                        continue  # local process still alive (slow import)
                    self._mark_worker_dead(w, "worker never registered")
                else:
                    remote_suspects.append(w)
        # Remote workers get the same tolerance as slow local imports:
        # ask their node manager whether the process is still alive.
        for w in remote_suspects:
            alive = False
            client = self._node_client(w.node_id)
            if client is not None:
                try:
                    alive = bool(client.call(
                        {"op": "worker_alive", "worker_hex": w.worker_hex},
                        timeout=5.0))
                except Exception:
                    alive = False
            if alive:
                continue
            with self.lock:
                if w.state == "starting" and w.conn is None:
                    self._mark_worker_dead(w, "worker never registered")

    def deliver_pending_create(self, w: WorkerInfo):
        spec = getattr(w, "pending_create", None)
        if spec is not None and w.conn is not None:
            w.pending_create = None  # type: ignore[attr-defined]
            w.conn.push({"op": "create_actor_instance", "spec": spec})

    def _op_worker_online(self, conn, msg):
        """Worker is fully initialized: mark schedulable, deliver queued
        actor creation."""
        worker_hex = conn.meta.get("worker_hex")
        with self.lock:
            w = self.workers.get(worker_hex)
            if w is None:
                return
            if w.state == "dead":
                # Doomed while starting (e.g. its placement group was
                # removed before it registered): tell it to exit.
                try:
                    conn.push({"op": "exit"})
                except Exception:
                    pass
                return
            if w.kind == "pool" and w.state == "starting":
                w.state = "idle"
            self.deliver_pending_create(w)
        self._wake.set()
