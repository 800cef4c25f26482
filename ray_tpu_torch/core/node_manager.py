"""Per-node manager daemon: the raylet counterpart for worker hosts.

A NodeManager joins an existing cluster head (`ray-tpu start
--address=<head>`), registers this host's resources, and then:

  - spawns/supervises the local worker pool when the head's scheduler
    places work on this node (reference WorkerPool::StartWorkerProcess,
    src/ray/raylet/worker_pool.h:159),
  - owns the node-local shared-memory arena (the embedded plasma store of
    a raylet, src/ray/object_manager/plasma/store_runner.h) that this
    node's workers read/write,
  - serves chunked object fetches to other nodes/the head over the frame
    protocol (reference ObjectManager::Push/HandlePull,
    src/ray/object_manager/object_manager.h:206/:139),
  - sweeps dead-process pins from its arena (plasma client-disconnect
    accounting).

The head keeps the cluster-wide object *directory* (who has what) and
does location lookup; the bulk bytes move node-to-node without transiting
the head (reference OwnershipBasedObjectDirectory + direct raylet-to-
raylet transfer).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import uuid
from typing import Dict, Optional

from ray_tpu_torch.core import object_plane, rpc
from ray_tpu_torch.core.config import (
    get_config, reset_config, session_dir_for)
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store import ShmObjectStore
from ray_tpu_torch.core.resources import node_resources_from_env


def zygote_enabled() -> bool:
    return os.environ.get("RAY_TPU_DISABLE_ZYGOTE", "") != "1"


def is_cpu_class(env_key: str) -> bool:
    """Env keys are `gpu<share>-<env hash>` (gcs._env_key_for): a worker
    that asked for no GPU ("gpu0-") is of the CPU class and sees no card;
    any share of one ("gpu0.5-", "gpu1-") makes a GPU-class worker, which
    keeps the node's visibility."""
    return env_key.startswith("gpu0-") or not env_key.startswith("gpu")


def cpu_worker_env(env: dict) -> dict:
    """CPU-class worker environment, shared by exec spawns and the zygote
    template so fork spawns stay environment-identical to exec spawns:
    no visible card (CUDA_VISIBLE_DEVICES="", so a CPU task never opens a
    CUDA context on it), line-visible output, and the pyarrow jemalloc
    guard (bundled jemalloc segfaults on this kernel).

    Unlike the JAX package, the port starts workers without `-S` and so
    needs no site-packages repair: the reference skips site init because
    a TPU VM's sitecustomize grabs the chip.  Nothing of the kind needs
    skipping for a GPU; a CUDA Python environment may rely on .pth files
    that `-S` skips (editable installs, CUDA binding redirectors)."""
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONUNBUFFERED"] = "1"
    env.setdefault("ARROW_DEFAULT_MEMORY_POOL", "system")
    return env


def gpu_worker_env(env: dict) -> dict:
    """GPU-class worker environment: the node's cards stay visible, and
    Kineto (torch.profiler's tracer) keeps CUPTI set up between profiler
    sessions (TEARDOWN_CUPTI=0, unless the caller set it).  In the trace
    probe on an H100 (torch 2.11+cu128; PERF.md) a first session taken
    from a thread of its own while another thread replays CUDA graphs
    hung with the teardown on and recorded kernels with it off; the
    runtime's torch_trace also starts and stops its sessions on the
    thread that replays, where one is named (runtime.set_profile_runner;
    a worker that runs its tasks on one thread names it by default), and
    bounds both (runtime.PROFILE_BOUND_S).  PyTorch turns the teardown
    off itself when it knows of CUDA graphs (torch.compile's), for the
    same reason."""
    env.setdefault("TEARDOWN_CUPTI", "0")
    return env


def prewarm_zygote() -> None:
    """Start warming this process's worker template (no-op when disabled)."""
    if not zygote_enabled():
        return
    try:
        from ray_tpu_torch.core.zygote import get_zygote

        get_zygote().prewarm()
    except Exception:
        pass


def _has_exec_only_env_vars(runtime_env: Optional[dict]) -> bool:
    """True when a runtime_env's env_vars only take effect at exec time —
    dynamic-loader paths, interpreter flags, native thread-pool init —
    and so would be silently inert in a forked zygote child whose
    interpreter and native libs are already loaded.  Such spawns keep the
    Popen path (mirroring the CUDA_VISIBLE_DEVICES special case below) so the
    same runtime_env behaves identically warm or cold."""
    if not runtime_env:
        return False
    env_vars = runtime_env.get("env_vars") or {}
    for k in env_vars:
        if k.startswith(("LD_", "PYTHON", "OMP_", "OPENBLAS_", "MKL_",
                         "MALLOC_", "GOMP_", "XLA_FLAGS")):
            return True
    return False


def spawn_worker_process(*, control_addr: str, worker_hex: str, kind: str,
                         env_key: str, namespace: str, node_id: str,
                         log_dir: str, session_id: str,
                         extra_env: Optional[dict] = None,
                         runtime_env: Optional[dict] = None
                         ) -> subprocess.Popen:
    """Start one worker process (shared by the head's in-process pool and
    remote node managers — reference worker_pool.h StartWorkerProcess).

    A runtime_env carrying a `container` spec wraps the command so the
    worker boots chrooted into the image rootfs inside a private
    user+mount namespace (runtime_env/container.py — the reference
    applies its podman prefix at the same point, worker_pool / image_uri)."""
    env = dict(os.environ)
    env["RAY_TPU_CONTROL_ADDR"] = control_addr
    env["RAY_TPU_WORKER_ID"] = worker_hex
    env["RAY_TPU_WORKER_KIND"] = kind
    env["RAY_TPU_ENV_KEY"] = env_key
    env["RAY_TPU_NAMESPACE"] = namespace
    env["RAY_TPU_NODE_ID"] = node_id
    # Line-visible worker output (see gcs.py _spawn_worker).
    env["PYTHONUNBUFFERED"] = "1"
    # pyarrow's bundled jemalloc segfaults under this kernel.
    env.setdefault("ARROW_DEFAULT_MEMORY_POOL", "system")
    if extra_env:
        env.update(extra_env)
    cmd = [sys.executable, "-m", "ray_tpu_torch.core.worker"]
    cpu_class = is_cpu_class(env_key)
    if cpu_class:
        cpu_worker_env(env)
    else:
        gpu_worker_env(env)
    os.makedirs(log_dir, exist_ok=True)
    log_base = os.path.join(log_dir, f"worker-{worker_hex[:8]}")
    # Fork-from-warm-template fast path (core/zygote.py): the common CPU
    # worker class skips interpreter startup + imports entirely.  Exec
    # paths remain for container envs (chroot wrapper), envs that swap
    # package resolution (pip/conda/py_modules pins would be shadowed by
    # the template's pre-imported modules in sys.modules), GPU workers
    # (the template has no visible card), and as the fallback whenever
    # the template is cold
    # (spawn() raises until the template answers a ping — a warming
    # zygote must never add latency to a worker the scheduler waits on)
    # or broken.
    _zygote_safe_env_keys = {"env_vars", "working_dir", "excludes"}
    if (cpu_class
            and not (runtime_env
                     and set(runtime_env) - _zygote_safe_env_keys)
            and not (extra_env and "CUDA_VISIBLE_DEVICES" in extra_env)
            and not _has_exec_only_env_vars(runtime_env)
            and zygote_enabled()):
        try:
            from ray_tpu_torch.core.zygote import get_zygote

            return get_zygote().spawn(env=env, log_base=log_base,
                                      cwd=os.getcwd())
        except Exception:
            pass
    if runtime_env and runtime_env.get("container"):
        # Submission refuses it first (runtime.check_runtime_env).
        raise NotImplementedError(
            "container runtime_env (runtime_env/container.py) is not "
            "ported yet: ROADMAP Queue A item 10")
    stdout = open(log_base + ".out", "ab")
    stderr = open(log_base + ".err", "ab")
    # raylint: allow-blocking(fork+exec IS the lease-grant op's work; latency accepted by design)
    return subprocess.Popen(cmd, env=env, stdout=stdout, stderr=stderr,
                            cwd=os.getcwd())


class NodeManager:
    """One per worker host; dies with the cluster (or when the head asks)."""

    def __init__(self, head_address: str, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[dict] = None, node_id: str = "",
                 labels: Optional[Dict[str, str]] = None):
        reset_config()
        self.config = get_config()
        self.head_address = head_address
        # The arena name must be unique per NODE, not per session: two
        # node managers simulated on one machine (tests) must not share
        # /dev/shm segments, or "remote" fetches silently read locally.
        self.store_key = f"node-{uuid.uuid4().hex[:12]}"
        self._stopped = threading.Event()
        # Head pushes (spawn_worker) and peer fetches can arrive the
        # moment register_node returns — before __init__ finishes
        # assigning session_dir/store below.  Handlers gate on this.
        self._ready = threading.Event()
        self._lock = threading.Lock()
        self._procs: Dict[str, subprocess.Popen] = {}
        # In-progress push-broadcast receptions: obj_hex -> [segment,
        # size, received_bytes, last_activity] (reaped by age in the
        # sweep loop so aborted senders don't leak arena memory).
        self._incoming: Dict[str, list] = {}
        # Synced cluster resource view (head broadcast; gcs.py
        # _sync_resource_view).
        self._view: Dict[str, dict] = {}
        self._view_seq = -1
        self._view_epoch = ""
        self._view_at = 0.0
        prewarm_zygote()  # template warms while the node registers
        self.server = rpc.Server(self._handle,
                                 host=self.config.node_ip_address)
        # Advertised (not bind) address: a 0.0.0.0 bind must not hand
        # peers an unroutable wildcard.
        self.address = (f"{self.config.advertised_host()}:"
                        f"{self.server.port}")
        node_res = node_resources_from_env(num_cpus, num_gpus, resources)
        self._register_msg = {
            "op": "register_node",
            "node_id": node_id,
            "resources": node_res.to_dict(),
            "address": self.address,
            "labels": labels or {},
            "store_key": self.store_key,
            "shm_dir": self.config.shm_dir,
        }
        self.head = rpc.Client(head_address, on_push=self._on_push)
        reply = self.head.call(self._register_msg)
        self.node_id = reply["node_id"]
        self.session_id = reply["session_id"]
        self.namespace = reply.get("namespace", "")
        self.session_dir = os.path.join(
            session_dir_for(self.session_id), f"node-{self.node_id}")
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self.store = ShmObjectStore(self.store_key, self.config.shm_dir,
                                    owner=True)
        # Node-level pull single-flight (op "pull_object"): all workers
        # on this host route remote fetches here, so N co-located
        # consumers of one object cost ONE wire transfer into the
        # shared arena (reference PullManager request coalescing at the
        # raylet, not the worker).
        self._pull_mgr = object_plane.PullManager()
        self._peer_conns: Dict[str, rpc.Client] = {}
        self._peer_lock = threading.Lock()
        self._ready.set()
        self._sweeper = threading.Thread(target=self._sweep_loop,
                                         name="node-sweep", daemon=True)
        self._sweeper.start()

    # -- head → node pushes --------------------------------------------
    def _on_push(self, msg: dict):
        self._ready.wait(timeout=60.0)
        op = msg.get("op")
        if op == "spawn_worker":
            try:
                proc = spawn_worker_process(
                    control_addr=self.head_address,
                    worker_hex=msg["worker_hex"], kind=msg["kind"],
                    env_key=msg["env_key"],
                    namespace=msg.get("namespace", self.namespace),
                    node_id=self.node_id,
                    log_dir=os.path.join(self.session_dir, "logs"),
                    session_id=self.session_id,
                    runtime_env=msg.get("runtime_env"),
                    # Local workers answer resource queries from this
                    # manager's synced view instead of dialing the head.
                    extra_env={"RAY_TPU_LOCAL_NM": self.address})
                with self._lock:
                    self._procs[msg["worker_hex"]] = proc
            except Exception as e:  # noqa: BLE001
                try:
                    self.head.send({"op": "worker_spawn_failed",
                                    "worker_hex": msg["worker_hex"],
                                    "error": f"{type(e).__name__}: {e}"})
                except Exception:
                    pass
        elif op == "kill_worker":
            with self._lock:
                proc = self._procs.pop(msg["worker_hex"], None)
            if proc is not None:
                try:
                    proc.kill()
                except OSError:
                    pass
        elif op == "resource_view":
            # Synced cluster resource view (N8, reference ray_syncer
            # RESOURCE_VIEW): newest seq per head epoch wins — a
            # restarted head's counter restarts, so a new epoch always
            # supersedes the old view.
            with self._lock:
                epoch = msg.get("epoch", "")
                if epoch != self._view_epoch:
                    self._view_epoch = epoch
                    self._view_seq = -1
                if msg["seq"] > self._view_seq:
                    self._view_seq = msg["seq"]
                    self._view = msg["nodes"]
                    self._view_at = time.time()
        elif op == "delete_object":
            # Cluster-wide refcount hit 0 (head decref/free): release the
            # local arena copy.
            try:
                self.store.delete(ObjectID.from_hex(msg["obj"]))
            except Exception:
                pass
        elif op == "migrate_objects":
            # Drain protocol (gcs.py _check_drains): push the listed
            # local arena objects to the survivor node's arena, then
            # report per-object results so the head can move the
            # primary-copy records before terminating this node.
            threading.Thread(target=self._migrate_and_report,
                             args=(msg,), daemon=True,
                             name="drain-migrate").start()
        elif op == "exit":
            self._stopped.set()

    def _migrate_and_report(self, msg: dict):
        from ray_tpu_torch.core.object_plane import PushManager

        class _PushHost:
            """Adapter giving PushManager the runtime surface it needs
            (local store + cached peer connections + config)."""

            def __init__(self, nm):
                self.store = nm.store
                self.config = nm.config
                self._conns: Dict[str, rpc.Client] = {}

            def _node_conn(self, addr: str) -> rpc.Client:
                c = self._conns.get(addr)
                if c is None or c._closed:
                    c = self._conns[addr] = rpc.Client(
                        addr, connect_timeout=5.0)
                return c

        dest = msg["dest"]
        pm = PushManager(_PushHost(self))
        results: Dict[str, str] = {}
        for item in msg.get("objects", []):
            obj_hex, size = item["obj"], item["size"]
            try:
                res = pm.broadcast(obj_hex, size, [dest], timeout=300.0)
                results[obj_hex] = res.get(dest, "error: missing")
            except Exception as e:  # noqa: BLE001 — report, don't die
                results[obj_hex] = f"error: {type(e).__name__}: {e}"
        try:
            self.head.send({"op": "objects_migrated",
                            "node_id": self.node_id,
                            "dest_node": msg.get("dest_node", ""),
                            "results": results})
        except Exception:
            pass

    # -- peer/head → node requests (object plane) ----------------------
    def _handle(self, conn: rpc.Connection, msg: dict):
        self._ready.wait(timeout=60.0)
        op = msg.get("op")
        if op == "fetch_chunk":
            # Chunked pull of a locally stored object.  The segment stays
            # attached (cached in the store) until the object is deleted,
            # so concurrent chunk reads never race a release.
            oid = ObjectID.from_hex(msg["obj"])
            seg = self.store.attach(oid, msg["size"])
            off, n = msg["offset"], msg["length"]
            part = bytes(seg.buf[off:off + n])
            object_plane.OBJ._inc("bytes_pushed", len(part))
            return part
        if op == "has_object":
            return self.store.contains(ObjectID.from_hex(msg["obj"]))
        if op == "push_begin":
            # Push-broadcast receiver (core/object_plane.py PushManager;
            # reference ObjectManager::Push + HandlePush).  The whole
            # object is claimed up front: arena if it fits, the store's
            # file-backed overflow path otherwise (consumers still read
            # one mmap); a size the store cannot place at all REJECTS
            # so the sender fails fast instead of wedging mid-stream.
            oid = ObjectID.from_hex(msg["obj"])
            with self._lock:
                # The in-progress check comes BEFORE store.contains: a
                # file-spilled partial allocation already "exists" on
                # disk, and answering "have" for it would strand a
                # restarted sender with a truncated object forever.
                ent = self._incoming.get(msg["obj"])
                if ent is not None:
                    # Restarted sender (or a concurrent duplicate):
                    # chunk writes are idempotent rewrites of the same
                    # immutable bytes, and progress is a HIGH-WATER
                    # MARK (not a byte count), so re-streaming from
                    # offset 0 converges instead of double-counting.
                    ent[3] = time.monotonic()
                    return {"ok": True}
                if self.store.contains(oid):
                    return {"have": True}
                # Claim the slot BEFORE the (lock-free) create so a
                # concurrent duplicate can't double-create and orphan
                # the first segment; [segment, size, high-water mark,
                # last_activity, writes-in-progress].
                ent = self._incoming[msg["obj"]] = [
                    None, msg["size"], 0, time.monotonic(), 0]
            try:
                seg = self.store.create(oid, msg["size"])
            except Exception as e:  # noqa: BLE001 — nowhere to put it
                with self._lock:
                    self._incoming.pop(msg["obj"], None)
                return {"reject": f"{type(e).__name__}: {e}"}
            with self._lock:
                ent[0] = seg
            return {"ok": True}
        if op == "push_chunk":
            with self._lock:
                ent = self._incoming.get(msg["obj"])
                if ent is not None:
                    if ent[0] is None:
                        # Concurrent duplicate raced the creator's
                        # allocation window; this stream fails, the
                        # sender's retry converges.
                        raise ValueError(
                            f"push of {msg['obj']} not ready")
                    ent[4] += 1  # sweep must not reap mid-write
            if ent is None:
                raise ValueError(f"no push in progress for {msg['obj']}")
            try:
                data = msg["data"]
                off = msg["offset"]
                ent[0].buf[off:off + len(data)] = data
            finally:
                with self._lock:
                    # TCP orders a connection's chunks, so the high
                    # water mark equals contiguous bytes received.
                    ent[2] = max(ent[2], off + len(data))
                    ent[3] = time.monotonic()
                    ent[4] -= 1
            return {"ok": True}
        if op == "push_end":
            oid = ObjectID.from_hex(msg["obj"])
            with self._lock:
                ent = self._incoming.get(msg["obj"])
                if ent is not None and ent[2] == ent[1]:
                    del self._incoming[msg["obj"]]
            if ent is None:
                # A concurrent duplicate push already finalized it.
                return {"ok": True} if self.store.contains(oid) \
                    else {"error": "no push in progress"}
            if ent[2] != ent[1]:
                # Short stream: drop the partial allocation (under the
                # lock the entry stays for a restarted sender; this
                # sender's stream simply failed).
                return {"error": f"short push: {ent[2]}/{ent[1]} bytes"}
            self.store.seal(oid)
            # Register the replica so a cluster-wide free deletes this
            # copy too (same contract as pull-side caching).
            try:
                self.head.send({"op": "object_replica",
                                "obj": msg["obj"]})
            except Exception:
                pass
            return {"ok": True}
        if op == "pull_object":
            # Single-flight remote fetch into this node's arena on
            # behalf of a local worker ({obj, size, addr}).  Runs on a
            # side thread via Deferred so slow transfers never
            # head-of-line block this connection's other ops.
            obj_hex, size = msg["obj"], msg["size"]
            addr = msg.get("addr", "")
            d = rpc.Deferred()

            def _pull():
                oid = ObjectID.from_hex(obj_hex)

                def _do():
                    if self.store.contains(oid):
                        return True
                    client = (self._peer_conn(addr) if addr
                              else self.head)
                    _, cached = object_plane.pull_into_store(
                        client, self.store, obj_hex, size,
                        self.config.transfer_chunk_bytes,
                        window=self.config.pull_window, timeout=120.0)
                    if cached:
                        try:
                            self.head.send({"op": "object_replica",
                                            "obj": obj_hex})
                        except Exception:  # raylint: allow-swallow(replica hint is advisory; head rediscovers on demand)
                            pass
                    return cached

                try:
                    cached = self._pull_mgr.pull(obj_hex, _do,
                                                 timeout=150.0)
                    d.resolve({"ok": True, "cached": bool(cached)})
                except BaseException as e:  # noqa: BLE001
                    d.reject(e)

            threading.Thread(target=_pull, daemon=True,
                             name="nm-pull").start()
            return d
        if op == "cluster_view":
            with self._lock:
                return {"seq": self._view_seq, "at": self._view_at,
                        "nodes": self._view}
        if op == "available_resources":
            # Node-local answer from the synced view (no head hop).
            with self._lock:
                nodes = self._view
            out: Dict[str, float] = {}
            for n in nodes.values():
                if n.get("alive"):
                    for k, v in n["available"].items():
                        out[k] = out.get(k, 0.0) + v
            return out
        if op == "cluster_resources":
            with self._lock:
                nodes = self._view
            out = {}
            for n in nodes.values():
                if n.get("alive"):
                    for k, v in n["total"].items():
                        out[k] = out.get(k, 0.0) + v
            return out
        if op == "worker_alive":
            with self._lock:
                proc = self._procs.get(msg["worker_hex"])
            return proc is not None and proc.poll() is None
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown node op {op}")

    def _peer_conn(self, addr: str) -> rpc.Client:
        """Cached connection to another node's object server."""
        with self._peer_lock:
            c = self._peer_conns.get(addr)
        if c is not None and not c._closed:
            return c
        c = rpc.Client(addr, connect_timeout=5.0)
        with self._peer_lock:
            existing = self._peer_conns.get(addr)
            if existing is not None and not existing._closed:
                c.close()
                return existing
            self._peer_conns[addr] = c
        return c

    # -- lifecycle ------------------------------------------------------
    def _sweep_loop(self):
        """Reap exited worker processes and drop their arena pins; age
        out abandoned push-broadcast receptions; report host stats to
        the head on an interval (dashboard/reporter.py — the per-node
        reporter agent role)."""
        from ray_tpu_torch.dashboard.reporter import HostStatsSampler

        sampler = HostStatsSampler()
        last_report = 0.0
        while not self._stopped.wait(1.0):
            if time.monotonic() - last_report >= 5.0:
                last_report = time.monotonic()
                try:
                    with self._lock:
                        nw = len(self._procs)
                    self.head.send({
                        "op": "node_stats",
                        "stats": sampler.sample(store=self.store,
                                                num_workers=nw)})
                except Exception:
                    pass
            stale = []
            with self._lock:
                for hex_, p in list(self._procs.items()):
                    if p.poll() is not None:
                        del self._procs[hex_]
                alive = [p.pid for p in self._procs.values()]
                now = time.monotonic()
                for obj_hex, ent in list(self._incoming.items()):
                    # Reap only senders that are provably gone: a long
                    # idle window (budget-contended broadcasts can gap
                    # minutes between chunks) AND no write in progress
                    # (deleting the segment under an active write would
                    # free an arena block mid-memcpy).
                    if now - ent[3] > 300.0 and ent[4] == 0:
                        del self._incoming[obj_hex]
                        stale.append(obj_hex)
            for obj_hex in stale:
                try:
                    self.store.delete(ObjectID.from_hex(obj_hex))
                except Exception:
                    pass
            alive.append(os.getpid())
            try:
                self.store.sweep(alive)
            except Exception:
                pass
            # The head going away (without a clean exit push): try to
            # redial — a restarted head accepts node re-registration
            # (gcs.py _op_register_node revival).  Only give up (and
            # reap the workers) when the reconnect window expires.
            if self.head._closed and not self._reconnect_head():
                self._stopped.set()

    def _reconnect_head(self) -> bool:
        timeout = self.config.gcs_reconnect_timeout_s
        if timeout <= 0:
            return False
        deadline = time.monotonic() + timeout
        self._register_msg["node_id"] = self.node_id  # keep identity
        while not self._stopped.is_set() and time.monotonic() < deadline:
            try:
                head = rpc.Client(self.head_address, on_push=self._on_push,
                                  connect_timeout=1.0)
                head.call(self._register_msg, timeout=10.0)
            except Exception:
                time.sleep(0.5)
                continue
            self.head = head
            return True
        return False

    def run_forever(self):
        try:
            self._stopped.wait()
        except KeyboardInterrupt:
            pass
        self.shutdown()

    def shutdown(self):
        self._stopped.set()
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        # Event-driven reap: each wait() blocks in the kernel until
        # that child exits or the shared deadline budget runs out — no
        # poll/sleep spin (late children are still killed below).
        deadline = time.monotonic() + 1.0
        still = []
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.001))
            except subprocess.TimeoutExpired:
                still.append(p)
        procs = still
        for p in procs:
            try:
                p.kill()
            except OSError:
                pass
        try:
            self.server.stop()
        except Exception:
            pass
        try:
            self.head.close()
        except Exception:
            pass
        self.store.cleanup()


def main(argv=None) -> int:
    import argparse

    from ray_tpu_torch.core import knobs

    knobs.apply_interpreter_tuning()
    p = argparse.ArgumentParser("ray_tpu_torch.core.node_manager")
    p.add_argument("--address", required=True, help="head control address")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    p.add_argument("--node-id", default="")
    p.add_argument("--label", action="append", default=[],
                   help="k=v node label (repeatable)")
    args = p.parse_args(argv)
    labels = dict(kv.split("=", 1) for kv in args.label)
    nm = NodeManager(args.address, num_cpus=args.num_cpus,
                     num_gpus=args.num_gpus, node_id=args.node_id,
                     labels=labels)
    print(f"node {nm.node_id} joined {args.address} "
          f"(object server {nm.server.address})", flush=True)
    nm.run_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
