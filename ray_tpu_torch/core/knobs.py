"""Copy of ray_tpu/core/knobs.py: the port reads the JAX package's
environment variables under their names and defaults, and adds none.

Central registry of every ``RAY_TPU_*`` environment knob.

Counterpart of the reference's generated flag table
(``ray_config_def.h``): one declaration per knob — name, typed default,
scope, one-line doc.  Two kinds of knob exist:

  * **explicit knobs** — read directly via ``os.environ`` somewhere in
    the tree; declared below as literal ``Knob(...)`` entries (literal
    so raylint's knob pass can extract them without importing).
  * **Config-derived knobs** — every field of ``core/config.py``'s
    ``Config`` dataclass is an implicit ``RAY_TPU_<FIELD>`` override
    via ``_env_override``; their docs live in ``_CONFIG_DOCS`` and the
    defaults/types come from the dataclass itself.

Conformance is enforced by ``python -m ray_tpu.analysis`` (the
``knobs`` pass), bidirectionally: a ``RAY_TPU_*`` name used anywhere in
ray_tpu/, scripts/ or tests/ must be declared here AND documented in
README's "Configuration knobs" table; a knob declared here must be
read somewhere (dead knobs fail).  README's table is generated —
regenerate with ``python -m ray_tpu.analysis --print-knob-table``.

Scopes: ``user`` (operator-facing tuning/feature gates), ``internal``
(set by the system for child processes; not meant for operators),
``bench`` (benchmark scripts only), ``test`` (test harness only).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str          # full env-var name (RAY_TPU_...)
    default: str       # default as the env string ("" = unset)
    type: str          # "str" | "int" | "float" | "bool" | "flag"
    scope: str         # "user" | "internal" | "bench" | "test"
    doc: str           # one line


KNOBS: List[Knob] = [
    # -- cluster / process identity (mostly set by the spawner) ----------
    Knob("RAY_TPU_ADDRESS", "", "str", "user",
         "Cluster address for init() when no address argument is given."),
    Knob("RAY_TPU_NAMESPACE", "", "str", "internal",
         "Namespace a spawned worker joins (set by the node manager)."),
    Knob("RAY_TPU_NODE_ID", "head", "str", "internal",
         "Node id of this process (exported to workers and node managers)."),
    Knob("RAY_TPU_JOB_ID", "", "str", "internal",
         "Job id exported to workers for runtime_context.get_job_id()."),
    Knob("RAY_TPU_WORKER_ID", "", "str", "internal",
         "Worker id (hex) assigned to a spawned worker process."),
    Knob("RAY_TPU_WORKER_KIND", "pool", "str", "internal",
         "Spawned worker flavor: pool (stateless tasks) or actor."),
    Knob("RAY_TPU_CONTROL_ADDR", "", "str", "internal",
         "Head control-server address handed to spawned workers."),
    Knob("RAY_TPU_LOCAL_NM", "", "str", "internal",
         "Local node-manager address a worker dials for the object plane."),
    Knob("RAY_TPU_ENV_KEY", "", "str", "internal",
         "Runtime-env key assigned to a spawned worker."),
    Knob("RAY_TPU_ACTOR_RESTARTED", "0", "bool", "internal",
         "Set on restarted actor workers; read by "
         "was_current_actor_restarted()."),
    Knob("RAY_TPU_CONTAINER_IMAGE", "", "str", "internal",
         "Exported into container runtime-envs so user code can learn "
         "its image."),

    # -- accelerators ----------------------------------------------------
    Knob("RAY_TPU_CHIPS", "", "str", "user",
         "Comma-separated TPU chip ids visible to this process "
         "(fallback for TPU_VISIBLE_CHIPS)."),
    Knob("RAY_TPU_ACCELERATOR_TYPE", "", "str", "user",
         "Pod type override (v4-16, ...) when TPU metadata is "
         "unavailable."),
    Knob("RAY_TPU_NO_METADATA", "0", "bool", "user",
         "1 skips GCE metadata-server queries during TPU detection."),
    Knob("RAY_TPU_PALLAS_INTERPRET", "", "flag", "user",
         "Run Pallas kernels in interpret mode (CPU-only testing)."),
    Knob("RAY_TPU_PREFILL_DENSE", "", "flag", "user",
         "1 forces the dense prefill path in models/decoding."),
    Knob("RAY_TPU_PA_SB", "", "int", "bench",
         "Paged-attention sub-batch override (perf experiments only)."),
    Knob("RAY_TPU_NATIVE_SANITIZE", "", "str", "user",
         "Build the native extension with this sanitizer (asan/tsan)."),
    Knob("RAY_TPU_NATIVE_STORE", "1", "bool", "user",
         "0 disables the C++ shared-memory object-store fast path."),

    # -- rpc / wire ------------------------------------------------------
    Knob("RAY_TPU_RPC_NO_BATCH", "", "flag", "user",
         "1 disables control-plane frame coalescing (legacy protocol)."),
    Knob("RAY_TPU_RPC_BATCH_MAX_MSGS", "512", "int", "user",
         "Max sub-messages per coalesced control-plane batch frame."),
    Knob("RAY_TPU_RPC_BATCH_MAX_BYTES", "4194304", "int", "user",
         "Flush threshold (bytes) for the control-plane coalescing "
         "buffer."),
    Knob("RAY_TPU_RPC_FLUSH_US", "0", "int", "user",
         "Microseconds the coalescing sender lingers before flushing so "
         "ping-pong request/ack chains batch; 0 keeps first-message-"
         "immediate."),

    # -- serve -----------------------------------------------------------
    Knob("RAY_TPU_SERVE_MAX_QUEUE", "1024", "int", "user",
         "Engine admission cap: add_request raises QueueFull once this "
         "many requests wait (0 = unbounded)."),
    Knob("RAY_TPU_SERVE_QUEUE_TIMEOUT_S", "60", "float", "user",
         "Default queueing deadline; requests still waiting past it are "
         "shed at the next engine step (0 = never)."),
    Knob("RAY_TPU_SERVE_PREFILL_BUDGET", "8192", "int", "user",
         "Per-step prefill token budget the continuous-batching "
         "scheduler may spend while decode slots are live (0 = "
         "unlimited)."),
    Knob("RAY_TPU_SERVE_FEEDBACK_STALE_S", "5", "float", "user",
         "Age past which a replica's piggybacked load report is ignored "
         "and routing falls back to local inflight counts."),
    Knob("RAY_TPU_SERVE_LOAD_REPORT_S", "1", "float", "user",
         "Interval between controller load-report probes of serve "
         "replicas."),
    Knob("RAY_TPU_GRPC_WORKERS", "16", "int", "user",
         "Thread-pool size of the serve gRPC proxy's request executor."),
    Knob("RAY_TPU_SERVE_ROLE_STRICT", "0", "bool", "user",
         "1 makes phase-tagged requests WAIT for a replica of their "
         "role instead of degrading to mixed routing on an empty pool."),
    Knob("RAY_TPU_SERVE_HANDOFF_TIMEOUT_S", "30", "float", "user",
         "Timeout for pulling a prefill->decode KV bundle off the "
         "object plane (and the disagg client's per-leg timeout) "
         "before falling back to re-prefill."),
    Knob("RAY_TPU_SERVE_DIGEST_K", "16", "int", "user",
         "Top-K hot prefix keys a serve replica advertises in its "
         "load-report digest for prefix-locality routing."),
    Knob("RAY_TPU_SERVE_TRACE", "1", "bool", "user",
         "0 disables request-journey tracing at the serve ingress "
         "proxies (no trace minting, no per-request phase spans)."),
    Knob("RAY_TPU_SERVE_SLO_SAMPLES", "256", "int", "user",
         "Capacity of the per-engine SLO sample ring (TTFT/TPOT/queue-"
         "wait) drained by load reports between controller probes."),
    Knob("RAY_TPU_SERVE_STEP_SAMPLE_EVERY", "8", "int", "user",
         "Engine step-sampler cadence: every Nth step snapshots batch "
         "occupancy, queue depth, free KV pages and prefill token "
         "spend (0 disables)."),
    Knob("RAY_TPU_SERVE_SLO_WINDOW_S", "300", "float", "user",
         "Sliding-window width of the controller's per-deployment SLO "
         "percentiles (serve_slo / /api/serve_slo)."),

    # -- scheduling / placement -----------------------------------------
    Knob("RAY_TPU_NO_LOCALITY", "", "flag", "user",
         "Truthy disables locality-aware task placement on the head."),
    Knob("RAY_TPU_GCS_SHARDS", "8", "int", "user",
         "Owner-keyed submit-ingress shards on the head (0 = legacy "
         "single-lock ingress)."),
    Knob("RAY_TPU_NODE_INDEX", "1", "bool", "user",
         "0 disables the utilization-bucketed node index and falls back "
         "to full node-table scans in _pick_node/placement."),
    Knob("RAY_TPU_SCHED_IDLE_WAIT_S", "30.0", "float", "user",
         "Scheduler wakeup ceiling when no time-based work is pending "
         "(timer-wheel deadlines cover lease expiry below this)."),
    Knob("RAY_TPU_ZEROCOPY_MIN_BYTES", "524288", "int", "user",
         "Payloads at/above this ride the scatter-gather wire path "
         "(no header+payload concat copy); 0 disables."),
    Knob("RAY_TPU_NM_PULL", "1", "bool", "user",
         "0 disables node-manager-level single-flight object pulls; "
         "workers pull remote objects directly."),
    Knob("RAY_TPU_GIL_SWITCH_S", "0", "float", "user",
         "sys.setswitchinterval applied at process start (0 = keep the "
         "interpreter default, 5ms); opt-in tuning for hosts running "
         "many ray_tpu processes per core."),
    Knob("RAY_TPU_DISABLE_ZYGOTE", "0", "bool", "user",
         "1 disables the zygote prefork path; workers spawn directly."),
    Knob("RAY_TPU_WHEEL_DIR", "", "str", "user",
         "Directory of pre-built wheels for runtime-env pip installs."),

    # -- observability ---------------------------------------------------
    Knob("RAY_TPU_LOGGING_CONFIG", "", "str", "user",
         "JSON logging config applied at process start "
         "(core/logging_config.py)."),
    Knob("RAY_TPU_METRICS_TTL_S", "60", "float", "user",
         "Staleness window for per-worker metric snapshots in /metrics "
         "aggregation."),
    Knob("RAY_TPU_TRACE_MAX_SPANS", "100000", "int", "user",
         "Per-process cap on buffered trace spans."),
    Knob("RAY_TPU_FLIGHT_RECORDER", "1", "bool", "user",
         "0 disables the in-process flight-recorder event ring."),
    Knob("RAY_TPU_FLIGHT_RECORDER_MAX_EVENTS", "4096", "int", "user",
         "Flight-recorder ring capacity (events)."),
    Knob("RAY_TPU_USAGE_STATS_ENABLED", "1", "bool", "user",
         "0 disables anonymous usage-stats collection."),
    Knob("RAY_TPU_PROFILE_SAMPLER", "1", "bool", "user",
         "0 disables the worker's background profile sampler."),
    Knob("RAY_TPU_PROFILE_SAMPLE_INTERVAL_S", "5", "float", "user",
         "Interval between worker profile-sampler snapshots."),
    Knob("RAY_TPU_SPAN_HARVEST_CHUNK", "2048", "int", "user",
         "Spans per chunk when the head harvests worker span buffers."),
    Knob("RAY_TPU_SPAN_HARVEST_MAX_CHUNKS", "8", "int", "user",
         "Max chunks pulled from one worker per harvest round."),
    Knob("RAY_TPU_SPAN_STORE_MAX", "200000", "int", "user",
         "Head-side cap on retained harvested spans."),
    Knob("RAY_TPU_OPS_JOURNAL_DIR", "", "str", "user",
         "Directory for the durable ops journal (spans/flight/metrics "
         "streams); unset disables journaling."),
    Knob("RAY_TPU_OPS_JOURNAL_MAX_BYTES", "67108864", "int", "user",
         "Per-stream on-disk retention budget; oldest journal segments "
         "are deleted past it."),
    Knob("RAY_TPU_OPS_JOURNAL_ROTATE_S", "600", "float", "user",
         "Max age of one journal segment before it rotates."),
    Knob("RAY_TPU_OPS_JOURNAL_FSYNC_S", "0.2", "float", "user",
         "Journal writer batch interval: queued records are written "
         "and fsynced at most this often."),
    Knob("RAY_TPU_PROFILE_HISTORY", "120", "int", "user",
         "Per-worker profile samples retained in the head's history "
         "ring for /api/profile percentiles."),

    # -- straggler / health watchdog (core/gcs.py) -----------------------
    Knob("RAY_TPU_WATCHDOG", "1", "bool", "user",
         "0 disables the head's straggler/health watchdog."),
    Knob("RAY_TPU_WATCHDOG_INTERVAL_S", "5.0", "float", "user",
         "Watchdog tick period (floor 0.05)."),
    Knob("RAY_TPU_WATCHDOG_MIN_SAMPLES", "5", "int", "user",
         "Completed-task samples required before straggler scoring."),
    Knob("RAY_TPU_WATCHDOG_PERCENTILE", "95.0", "float", "user",
         "Percentile of past durations used as the straggler baseline."),
    Knob("RAY_TPU_WATCHDOG_MULTIPLIER", "3.0", "float", "user",
         "A task is a straggler past baseline x this multiplier."),
    Knob("RAY_TPU_WATCHDOG_MIN_AGE_S", "1.0", "float", "user",
         "Tasks younger than this are never flagged as stragglers."),
    Knob("RAY_TPU_WATCHDOG_HEARTBEAT_TIMEOUT_S", "30.0", "float", "user",
         "Worker heartbeat silence before it is marked unhealthy."),

    # -- device-plane telemetry (util/device_stats.py) -------------------
    Knob("RAY_TPU_DEVICE_STATS", "1", "bool", "user",
         "0 disables device-plane telemetry (compile-event hook, "
         "roofline/MFU step accounting)."),
    Knob("RAY_TPU_DEVICE_RECOMPILE_WARMUP", "2", "int", "user",
         "Compilations of one jitted function tolerated as warmup "
         "before counting toward recompile churn."),
    Knob("RAY_TPU_DEVICE_RECOMPILE_MAX", "8", "int", "user",
         "Post-warmup compiles of one function on one worker past "
         "which the watchdog flags a recompile storm."),
    Knob("RAY_TPU_DEVICE_HBM_WATERMARK", "0.9", "float", "user",
         "Device-memory occupancy watermark fraction at/over which "
         "the watchdog raises an HBM health alert."),
    Knob("RAY_TPU_DEVICE_HBM_GBPS", "0", "float", "user",
         "HBM bandwidth override (GB/s) for the roofline model; 0 "
         "selects the built-in per-device-kind table."),
    Knob("RAY_TPU_DEVICE_PEAK_TFLOPS", "0", "float", "user",
         "Peak dense TFLOP/s override for MFU; 0 selects the built-in "
         "per-device-kind table."),
    Knob("RAY_TPU_DEVICE_HBM_BYTES", "0", "int", "user",
         "Device-memory capacity override (bytes) for the HBM ledger "
         "on backends without memory_stats (e.g. CPU)."),

    # -- libraries -------------------------------------------------------
    Knob("RAY_TPU_DATA_BLOCK_FORMAT", "arrow", "str", "user",
         "Default block format for ray_tpu.data datasets."),
    Knob("RAY_TPU_WORKFLOW_STORAGE", "", "str", "user",
         "Workflow checkpoint root (default: <tmpdir>/ray_tpu/"
         "workflows)."),
    Knob("RAY_TPU_COPY_DESER_BUFFERS", "0", "bool", "user",
         "1 copies deserialized buffers out of shm instead of zero-copy "
         "views."),

    # -- benchmarks (scripts/) -------------------------------------------
    Knob("RAY_TPU_BENCH_SCALE", "1.0", "float", "bench",
         "Scales microbenchmark workload sizes."),
    Knob("RAY_TPU_BENCH_HARVEST", "1", "bool", "bench",
         "0 disables span harvest during bench_profiling runs."),
    Knob("RAY_TPU_BENCH_SAMPLER", "1", "bool", "bench",
         "0 disables the profile sampler during bench_profiling runs."),
    Knob("RAY_TPU_BENCH_LATENCY_MS", "15", "float", "bench",
         "Simulated cross-node link latency in bench_object_plane."),
    Knob("RAY_TPU_BENCH_PG_NODES", "2000", "int", "bench",
         "Simulated-cluster node count for bench_head_scale's "
         "placement-group section."),

    # -- test harness (tests/conftest.py) --------------------------------
    Knob("RAY_TPU_TEST_WATCHDOG", "420", "int", "test",
         "Per-test hang watchdog (seconds); 0 disables."),
    Knob("RAY_TPU_TEST_WATCHDOG_LOG", "/tmp/ray_tpu_test_watchdog.log",
         "str", "test",
         "Where the test watchdog dumps stacks on a hang."),
]

# One-line docs for the Config-derived knobs (RAY_TPU_<FIELD> via
# config._env_override).  Keys MUST mirror the Config dataclass fields
# — raylint's knobs pass fails on drift in either direction.
_CONFIG_DOCS: Dict[str, str] = {
    "max_inline_object_size":
        "Objects at/below this size are inlined in the object directory.",
    "max_direct_result_bytes":
        "Actor results at/below this ride the direct connection back.",
    "object_store_memory":
        "Shared-memory store capacity in bytes (0 = bounded by /dev/shm).",
    "shm_dir": "Directory backing the shared-memory store.",
    "object_spilling_threshold":
        "Spill shm objects past this usage fraction (0 disables).",
    "spill_storage":
        "Spill target: '' = <session>/spilled, a path, or an URI prefix.",
    "spill_min_age_s": "Objects younger than this are not spilled.",
    "enable_object_reconstruction":
        "Re-execute the producing task when an object's only copy is "
        "lost.",
    "object_reconstruction_max_attempts":
        "Per-object cap on reconstruction re-executions.",
    "max_lineage_entries":
        "Cap on retained task records + lineage links before eviction.",
    "memory_usage_threshold":
        "OOM-kill retriable tasks past this host-memory fraction "
        "(0 disables).",
    "memory_monitor_refresh_s": "Memory-monitor poll period.",
    "oom_kill_cooldown_s": "Minimum seconds between OOM kills.",
    "memory_usage_threshold_critical":
        "Past this fraction, non-retriable tasks become kill-eligible "
        "too.",
    "prestart_workers": "Worker processes started eagerly at init.",
    "max_workers_per_node": "Hard cap on worker processes per node.",
    "worker_lease_timeout_s":
        "Seconds a leased idle worker is kept before returning to the "
        "pool.",
    "scheduler_top_k_fraction":
        "Top-k random choice fraction among feasible nodes.",
    "direct_task_leases":
        "Owner-direct task leases; off = every task transits the head.",
    "lease_pipeline_depth": "In-flight pipeline depth per leased worker.",
    "lease_idle_timeout_s":
        "Owner returns an idle lease after this long without queued "
        "work.",
    "max_lease_workers_per_request":
        "Cap on workers one lease request asks for.",
    "lease_scaleup_clamp_s":
        "How long an unanswered lease ask clamps pipeline depth to 1.",
    "task_max_retries": "Default retry budget for failed tasks.",
    "actor_max_restarts": "Default restart budget for crashed actors.",
    "health_check_period_s": "Node health-check probe period.",
    "health_check_timeout_s": "Node health-check failure timeout.",
    "rpc_connect_timeout_s": "Control-plane dial timeout.",
    "rpc_max_message_bytes": "Hard cap on one control-plane frame.",
    "node_ip_address": "Address this host's rpc servers bind.",
    "node_advertise_ip":
        "Address advertised to peers ('' = node_ip_address).",
    "transfer_chunk_bytes": "Chunk size for cross-node object pulls.",
    "pull_window": "In-flight fetch_chunk requests per object pull.",
    "worker_register_timeout_s":
        "A spawned worker silent past this is presumed dead and its "
        "work retried.",
    "gcs_store_path":
        "Path for the control server's KV journal ('' = in-memory "
        "only).",
    "control_port": "Fixed control-server port (0 = ephemeral).",
    "gcs_reconnect_timeout_s":
        "How long clients retry redialing a lost head (0 disables).",
    "head_restart_grace_s":
        "Grace for restored-but-unclaimed entities after a head "
        "restart.",
    "log_dir": "Per-session log directory ('' = session default).",
}


def apply_interpreter_tuning() -> None:
    """Per-process interpreter tuning, called from every bootstrap path
    (driver init, worker main, node-manager main).

    RAY_TPU_GIL_SWITCH_S shortens the GIL switch interval: an op on the
    hot path crosses several processes (owner -> head -> worker ->
    owner), and on an oversubscribed host each hop's recv-thread wakeup
    can wait out the full default 5 ms interval before the bytecode
    holder yields — a latency tax that bounds end-to-end throughput
    even when every process profiles as idle."""
    import os
    import sys

    try:
        si = float(os.environ.get("RAY_TPU_GIL_SWITCH_S", "0") or 0)
    except ValueError:
        si = 0.0
    if si > 0:
        sys.setswitchinterval(si)


def config_knobs() -> List[Knob]:
    """The Config-derived knobs, materialized with the dataclass
    defaults (import-time cheap: config has no heavy deps)."""
    from ray_tpu_torch.core import config as _config

    out = []
    for f in dataclasses.fields(_config.Config):
        doc = _CONFIG_DOCS.get(f.name, "")
        default = f.default
        tname = type(default).__name__
        out.append(Knob(
            name=f"RAY_TPU_{f.name.upper()}",
            default=str(default),
            type=tname if tname in ("int", "float", "bool", "str")
            else "str",
            scope="user",
            doc=doc))
    return out


def all_knobs() -> List[Knob]:
    seen = set()
    out = []
    for k in list(KNOBS) + config_knobs():
        if k.name not in seen:
            seen.add(k.name)
            out.append(k)
    return sorted(out, key=lambda k: (k.scope, k.name))


def get(name: str) -> Optional[Knob]:
    for k in all_knobs():
        if k.name == name:
            return k
    return None


def render_readme_table() -> str:
    """The README 'Configuration knobs' section body, generated so docs
    cannot drift from the registry (raylint checks both directions)."""
    lines = [
        "",
        "All runtime tuning rides `RAY_TPU_*` environment variables, "
        "declared centrally in",
        "`ray_tpu/core/knobs.py` (`Config` fields in "
        "`ray_tpu/core/config.py` are implicit",
        "`RAY_TPU_<FIELD>` overrides).  Generated by "
        "`python -m ray_tpu.analysis --print-knob-table`;",
        "the `knobs` lint pass fails on any drift between code, "
        "registry, and this table.",
        "",
    ]
    titles = {"user": "Operator knobs",
              "internal": "Internal (set by the system)",
              "bench": "Benchmark scripts",
              "test": "Test harness"}
    by_scope: Dict[str, List[Knob]] = {}
    for k in all_knobs():
        by_scope.setdefault(k.scope, []).append(k)
    for scope in ("user", "internal", "bench", "test"):
        knobs = by_scope.get(scope)
        if not knobs:
            continue
        lines.append(f"### {titles[scope]}")
        lines.append("")
        lines.append("| Variable | Default | Type | Meaning |")
        lines.append("|---|---|---|---|")
        for k in knobs:
            default = k.default if k.default != "" else "*(unset)*"
            lines.append(
                f"| `{k.name}` | `{default}` | {k.type} | {k.doc} |")
        lines.append("")
    return "\n".join(lines) + "\n"
