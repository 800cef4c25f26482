"""Runtime configuration flags.

Counterpart of the reference's RAY_CONFIG flag system
(src/ray/common/ray_config_def.h): every knob has a typed default and can be
overridden by an ``RAY_TPU_<NAME>`` environment variable or via
``init(_system_config={...})``.  Kept deliberately small; grow as subsystems
land.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, fields

# The port's own places on a host.  A cluster of the JAX package and one of
# the port may run side by side (the test suite starts both under xdist), so
# they share no address file, session directory or arena: the reference
# keeps /tmp/ray_tpu/{cluster_address,session-*} and /dev/shm/raytpu-*.
ARENA_PREFIX = "raytputorch"
# What the head's registration reply names itself: a client of the port
# refuses a head whose reply does not (the JAX package's names nothing).
HEAD_RUNTIME = "ray_tpu_torch"


def tmp_root() -> str:
    """Root of the port's address file and session directories
    (`<tmpdir>/ray_tpu_torch`, under the process's TMPDIR)."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch")


def address_file() -> str:
    return os.path.join(tmp_root(), "cluster_address")


def session_dir_for(session_id: str) -> str:
    return os.path.join(tmp_root(), f"session-{session_id}")


def _env_override(name: str, default):
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    t = type(default)
    if t is bool:
        return raw.lower() in ("1", "true", "yes")
    return t(raw)


@dataclass
class Config:
    # -- object store ---------------------------------------------------
    # Objects at or below this size are stored inline in the object
    # directory instead of a shared-memory segment (reference:
    # max_direct_call_object_size, ray_config_def.h).
    max_inline_object_size: int = 100 * 1024
    # Owner-direct actor results at or below this size ride the direct
    # actor connection back to the submitter (runtime.py); larger ones
    # fall back to the shared-memory store via the head.
    max_direct_result_bytes: int = 1024 * 1024
    # Shared-memory store capacity (bytes). 0 = unlimited (bounded by /dev/shm).
    object_store_memory: int = 0
    # Directory backing the shared-memory store.
    shm_dir: str = "/dev/shm"
    # Spill shm objects to external storage once the arena passes this
    # usage fraction (reference: object_spilling_threshold). 0 disables.
    object_spilling_threshold: float = 0.8
    # External storage spec: '' = <session_dir>/spilled, a path, or a
    # smart_open URI prefix (s3://...). See core/external_storage.py.
    spill_storage: str = ""
    # Objects younger than this are not spilled (bounds the window where
    # a client could hold a stale in-shm location).
    spill_min_age_s: float = 1.0

    # -- lineage reconstruction -----------------------------------------
    # Re-execute the producing task when an object's only copy is lost
    # (reference: enable_object_reconstruction flag ray_config_def.h,
    # ObjectRecoveryManager object_recovery_manager.h, lineage
    # resubmission task_manager.h:208).
    enable_object_reconstruction: bool = True
    # Per-object cap on reconstruction re-executions (reference:
    # task_retries consumed by reconstruction).
    object_reconstruction_max_attempts: int = 3
    # Cap on retained task records + lineage links; oldest finished
    # records are evicted past this (reference: bounded lineage
    # max_lineage_bytes + RAY_task_events_max_num_task_in_gcs).
    max_lineage_entries: int = 100_000

    # -- memory monitor (reference memory_monitor.h + OOM killer) -------
    # Kill-and-retry the newest retriable task when host memory usage
    # crosses this fraction. 0 disables the monitor.
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_s: float = 1.0
    # Minimum seconds between OOM kills, so reclaim from one kill lands
    # before the next is considered (prevents cascade-killing the pool).
    oom_kill_cooldown_s: float = 10.0
    # Above this usage, non-retriable tasks become eligible too (last
    # resort before the kernel OOM-kills the node).
    memory_usage_threshold_critical: float = 0.98

    # -- scheduling -----------------------------------------------------
    # Max worker processes started eagerly at init.
    prestart_workers: int = 0
    # Hard cap on worker processes per node.
    max_workers_per_node: int = 64
    # Seconds a leased idle worker is kept before being returned to pool.
    worker_lease_timeout_s: float = 0.0
    # Top-k random choice among feasible nodes (reference hybrid policy
    # scheduling/policy/hybrid_scheduling_policy.h).
    scheduler_top_k_fraction: float = 0.2
    # Owner-direct task leases (reference: the lease protocol of
    # CoreWorkerDirectTaskSubmitter, direct_task_transport.h:75/:353 —
    # the owner leases workers from the scheduler once, then pushes
    # task specs peer-to-peer and reuses the lease while same-shaped
    # work remains).  Off = every task transits the head.
    direct_task_leases: bool = True
    # In-flight pipeline depth per leased worker (reference pipelines
    # via max_tasks_in_flight_per_worker).
    lease_pipeline_depth: int = 4
    # Owner returns an idle lease after this long without queued work.
    lease_idle_timeout_s: float = 0.25
    # Cap on workers one lease request asks for.
    max_lease_workers_per_request: int = 16
    # How long an unanswered lease ask holds pipeline depth at 1 (so
    # early tasks spread across incoming workers).  Past this, the ask
    # is treated as queued-for-capacity and full-depth pipelining
    # resumes on the workers already held.
    lease_scaleup_clamp_s: float = 1.0

    # -- fault tolerance ------------------------------------------------
    task_max_retries: int = 3
    actor_max_restarts: int = 0
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 10.0

    # -- rpc ------------------------------------------------------------
    rpc_connect_timeout_s: float = 10.0
    rpc_max_message_bytes: int = 512 * 1024 * 1024
    # Address this host's rpc servers BIND. 127.0.0.1 keeps single-host
    # setups private; set to the host's reachable IP or 0.0.0.0 for real
    # multi-host clusters.
    node_ip_address: str = "127.0.0.1"
    # Address ADVERTISED to peers (actor transport, node object plane).
    # '' = node_ip_address, except 0.0.0.0/:: resolves to the hostname's
    # IP (an advertised wildcard would point peers at themselves).
    node_advertise_ip: str = ""

    def advertised_host(self) -> str:
        host = self.node_advertise_ip or self.node_ip_address
        if host in ("0.0.0.0", "::"):
            import socket

            try:
                host = socket.gethostbyname(socket.gethostname())
            except OSError:
                host = "127.0.0.1"
        return host
    # Chunk size for cross-node object pulls (reference
    # object_manager_default_chunk_size, ray_config_def.h).
    transfer_chunk_bytes: int = 8 * 1024 * 1024
    # In-flight fetch_chunk requests per object pull (reference
    # object_manager_max_bytes_in_flight, as a chunk-count window).
    # 1 restores the legacy one-chunk-at-a-time ping-pong.
    pull_window: int = 4
    # A spawned worker that hasn't registered within this window is
    # presumed dead (its node crashed mid-spawn) and its work is retried.
    worker_register_timeout_s: float = 60.0

    # -- control-plane persistence (reference: GCS StoreClient / Redis) --
    # Path for the control server's KV journal; '' = in-memory only.
    # With a path set, the cluster KV (user KV, runtime-env packages,
    # named-function registrations AND their blobs) PLUS cluster
    # metadata (session id, named actors, placement groups, logical
    # nodes) survive a head restart.
    gcs_store_path: str = ""
    # Fixed control-server port (0 = ephemeral). A restartable head
    # needs a stable port so workers/drivers/nodes can redial it.
    control_port: int = 0
    # How long clients (workers, drivers, node managers) retry redialing
    # a lost head before giving up (reference: raylet reconnect backoff
    # after NotifyGCSRestart, node_manager.proto:383). 0 disables
    # reconnection (a lost head kills the client, the old behavior).
    gcs_reconnect_timeout_s: float = 30.0
    # After a head restart, how long a restored-but-unclaimed entity
    # (RESTARTING actor nobody re-announced, re-subscribed object whose
    # producer never reported) waits before being failed/respawned.
    head_restart_grace_s: float = 15.0

    # -- logging --------------------------------------------------------
    log_dir: str = ""

    def __post_init__(self):
        for f in fields(self):
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))

    def apply_overrides(self, overrides: dict | None):
        if not overrides:
            return self
        valid = {f.name for f in fields(self)}
        for k, v in overrides.items():
            if k not in valid:
                raise ValueError(f"Unknown system config key: {k}")
            setattr(self, k, v)
        return self


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config


def reset_config():
    global _global_config
    _global_config = None
