"""Copy of ray_tpu/util/metrics.py (the port imports nothing of the JAX
package); metric names are the reference's.

Application metrics API: Counter / Gauge / Histogram + Prometheus export.

Counterpart of the reference's ray.util.metrics (python/ray/util/metrics.py
→ Cython includes/metric.pxi → the OpenCensus C++ stack N15) and the
per-node MetricsAgent (python/ray/_private/metrics_agent.py) that
re-exports Prometheus. The multi-hop OpenCensus pipeline collapses to:

  process-local registry  →  periodic pickled snapshot into the GCS KV
  (`__metrics__/<worker_hex>`)  →  the dashboard's /metrics endpoint (and
  `aggregate_prometheus_text()`) merges all live snapshots into one
  Prometheus text exposition.

Metrics are cheap host bookkeeping (a dict update behind a lock); nothing
here touches the device path.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.util import journal as _journal

_KV_PREFIX = "__metrics__/"
_PUBLISH_INTERVAL_S = 2.0

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}
_publisher_started = False
# Set once this process has successfully written its KV snapshot key, so
# clean shutdown knows whether there is anything to unpublish.
_published = False


def _metrics_ttl_s() -> float:
    """Snapshot freshness window (env RAY_TPU_METRICS_TTL_S, default 60):
    snapshots stamped older than this are skipped — and garbage-collected
    — during aggregation, so a crashed worker's last counters do not
    haunt /metrics forever."""
    try:
        return max(1.0, float(os.environ.get("RAY_TPU_METRICS_TTL_S",
                                             "60")))
    except ValueError:
        return 60.0


def _tags_key(tags: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(tags.items()))


class Metric:
    """Base class: a named metric with static default tags and per-tag-set
    series (reference util/metrics.py Metric)."""

    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name or any(c in name for c in " \n"):
            raise ValueError(f"invalid metric name: {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self.default_tags: Dict[str, str] = {}
        self._series: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            existing = _registry.get(name)
            if existing is not None:
                if existing.kind != self.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}")
                if (self.kind == "histogram"
                        and getattr(existing, "boundaries", None)
                        != getattr(self, "boundaries", None)):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"boundaries {existing.boundaries}")
                # Re-instantiation (e.g. the same task body running twice
                # in a reused worker) adopts the accumulated series rather
                # than silently resetting counters.
                self._series = existing._series
                self._lock = existing._lock
            _registry[name] = self
        _ensure_publisher()

    def set_default_tags(self, tags: Dict[str, str]):
        self.default_tags = dict(tags)
        return self

    def _resolve_tags(self, tags: Optional[Dict[str, str]]
                      ) -> Dict[str, str]:
        merged = dict(self.default_tags)
        if tags:
            merged.update(tags)
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(
                f"tags {sorted(extra)} not declared in tag_keys for "
                f"metric {self.name!r}")
        return merged

    # -- snapshot / exposition ---------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            series = dict(self._series)
        return {"name": self.name, "kind": self.kind,
                "description": self.description, "series": series}


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("Counter.inc() value must be >= 0")
        key = _tags_key(self._resolve_tags(tags))
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = _tags_key(self._resolve_tags(tags))
        with self._lock:
            self._series[key] = float(value)


class Histogram(Metric):
    """Fixed-boundary histogram (reference util/metrics.py Histogram).

    Series values are (bucket_counts, sum, count) per tag set; exposition
    follows the Prometheus cumulative-bucket convention.
    """

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        self.boundaries = sorted(boundaries or
                                 (0.001, 0.01, 0.1, 1.0, 10.0, 100.0))
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = _tags_key(self._resolve_tags(tags))
        with self._lock:
            entry = self._series.get(key)
            if entry is None:
                entry = [[0] * (len(self.boundaries) + 1), 0.0, 0]
                self._series[key] = entry
            buckets, _, _ = entry
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            entry[1] += float(value)
            entry[2] += 1

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["boundaries"] = list(self.boundaries)
        # Deep-copy mutable bucket lists so the publisher pickles a stable
        # view.
        snap["series"] = {k: [list(v[0]), v[1], v[2]]
                          for k, v in snap["series"].items()}
        return snap


# ---------------------------------------------------------------------------
# Exposition
# ---------------------------------------------------------------------------

def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_tags(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


def merge_snapshots(snapshots: List[dict]) -> List[dict]:
    """Merge same-name metrics from different processes into one snapshot
    per name so the exposition never carries duplicate samples (which
    would fail the whole Prometheus scrape): counters and histograms sum,
    gauges last-write-wins."""
    merged: Dict[str, dict] = {}
    for snap in snapshots:
        name = snap["name"]
        cur = merged.get(name)
        if cur is None:
            merged[name] = {**snap, "series": dict(snap["series"])}
            continue
        if cur["kind"] != snap["kind"]:
            continue  # conflicting registration; keep the first
        for key, val in snap["series"].items():
            if key not in cur["series"]:
                cur["series"][key] = val
            elif cur["kind"] == "counter":
                cur["series"][key] = cur["series"][key] + val
            elif cur["kind"] == "histogram" and \
                    cur.get("boundaries") == snap.get("boundaries"):
                a, b = cur["series"][key], val
                cur["series"][key] = [
                    [x + y for x, y in zip(a[0], b[0])],
                    a[1] + b[1], a[2] + b[2]]
            else:
                cur["series"][key] = val
    return list(merged.values())


def snapshots_to_prometheus_text(snapshots: List[dict]) -> str:
    """Render metric snapshots as Prometheus text exposition format."""
    lines: List[str] = []
    seen_help = set()
    for snap in merge_snapshots(snapshots):
        name, kind = snap["name"], snap["kind"]
        if name not in seen_help:
            if snap.get("description"):
                lines.append(f"# HELP {name} {snap['description']}")
            lines.append(f"# TYPE {name} "
                         f"{kind if kind != 'untyped' else 'gauge'}")
            seen_help.add(name)
        for key, val in snap["series"].items():
            tags = _fmt_tags(tuple(key))
            if kind == "histogram":
                buckets, total, count = val
                base = tags[1:-1] if tags else ""

                def bucket_label(le: str) -> str:
                    inner = (base + "," if base else "") + f'le="{le}"'
                    return "{" + inner + "}"

                cumulative = 0
                for b, c in zip(snap["boundaries"], buckets):
                    cumulative += c
                    lines.append(
                        f"{name}_bucket{bucket_label(str(b))} {cumulative}")
                lines.append(f"{name}_bucket{bucket_label('+Inf')} {count}")
                lines.append(f"{name}_sum{tags} {total}")
                lines.append(f"{name}_count{tags} {count}")
            else:
                lines.append(f"{name}{tags} {val}")
    return "\n".join(lines) + ("\n" if lines else "")


def local_snapshots() -> List[dict]:
    with _registry_lock:
        metrics = list(_registry.values())
    snaps = [m.snapshot() for m in metrics]
    # Wire-level telemetry (core/rpc.py) lives outside the registry —
    # rpc.py must not import this module at the frame layer — but
    # publishes through the same pipeline.
    try:
        from ray_tpu_torch.core import rpc

        snaps.extend(rpc.wire_metric_snapshots())
    except Exception:
        pass
    # Object-plane telemetry (core/object_plane.py) publishes the same
    # way: pulled/pushed bytes, dedup ratio, arena cache events.
    try:
        from ray_tpu_torch.core import object_plane

        snaps.extend(object_plane.object_metric_snapshots())
    except Exception:
        pass
    # Silent-drop visibility: the tracing ring and flight recorder both
    # evict oldest-first without logging — surface eviction counts and
    # ring occupancy so a truncated trace is diagnosable from /metrics
    # instead of a mystery.
    try:
        from ray_tpu_torch.util import tracing as _tr

        snaps.append({
            "name": "ray_tpu_trace_dropped_spans_total",
            "kind": "counter",
            "description": "Spans evicted from this process's bounded "
                           "trace ring",
            "series": {(): float(_tr.dropped_span_count())}})
    except Exception:
        pass
    try:
        from ray_tpu_torch.util import flight_recorder as _fr

        st = _fr.stats()
        snaps.append({
            "name": "ray_tpu_flight_recorder_events",
            "kind": "gauge",
            "description": "Events currently in the flight-recorder "
                           "ring",
            "series": {(): float(st["events"])}})
        snaps.append({
            "name": "ray_tpu_flight_recorder_capacity",
            "kind": "gauge",
            "description": "Flight-recorder ring capacity",
            "series": {(): float(st["capacity"])}})
        snaps.append({
            "name": "ray_tpu_flight_recorder_dropped_total",
            "kind": "counter",
            "description": "Events evicted from the flight-recorder "
                           "ring",
            "series": {(): float(st["dropped"])}})
    except Exception:
        pass
    return snaps


# ---------------------------------------------------------------------------
# Publishing (process → GCS KV) and aggregation (KV → Prometheus text)
# ---------------------------------------------------------------------------

def snapshots_json_safe(snapshots: List[dict]) -> List[dict]:
    """Snapshots with tuple series keys flattened to lists so they can
    ride a JSON journal record.  `series` becomes a list of
    ``[[ [tag, value], ... ], sample]`` pairs (histogram samples are
    already JSON-safe ``[buckets, sum, count]`` triples)."""
    out = []
    for snap in snapshots:
        safe = {k: v for k, v in snap.items() if k != "series"}
        safe["series"] = [[[list(kv) for kv in key], val]
                          for key, val in snap.get("series", {}).items()]
        out.append(safe)
    return out


def snapshots_from_json(objs: List[dict]) -> List[dict]:
    """Inverse of snapshots_json_safe (journal replay → the shapes
    merge_snapshots / snapshots_to_prometheus_text expect)."""
    out = []
    for obj in objs:
        snap = {k: v for k, v in obj.items() if k != "series"}
        snap["series"] = {
            tuple(tuple(kv) for kv in key): val
            for key, val in obj.get("series", [])}
        out.append(snap)
    return out


def _journal_snapshots(snaps: List[dict]) -> None:
    j = _journal.stream("metrics")
    if j is not None:
        j.append({"snapshots": snapshots_json_safe(snaps)})


def publish_now() -> bool:
    """Publish this process's snapshots to the cluster KV immediately."""
    global _published
    snaps = local_snapshots()
    if not snaps:
        return False
    _journal_snapshots(snaps)
    try:
        from ray_tpu_torch.core.runtime import get_runtime
        rt = get_runtime()
    except Exception:
        return False
    ident = rt.core.worker_hex if hasattr(rt, "core") else "driver"
    payload = pickle.dumps({"ts": time.time(), "snapshots": snaps})
    try:
        rt.kv().call({"op": "kv_put", "key": _KV_PREFIX + ident,
                      "value": payload, "overwrite": True})
        _published = True
        return True
    except Exception:
        return False


def unpublish(kv_call, ident: str) -> None:
    """Delete this process's snapshot key on clean shutdown so the
    aggregator never serves a dead worker's counters during the TTL
    window (no-op if this process never published)."""
    global _published
    if not _published:
        return
    _published = False
    try:
        kv_call({"op": "kv_del", "key": _KV_PREFIX + ident})
    except Exception:
        pass


def _publisher_loop():
    while True:
        time.sleep(_PUBLISH_INTERVAL_S)
        publish_now()


def _ensure_publisher():
    global _publisher_started
    with _registry_lock:
        if _publisher_started:
            return
        _publisher_started = True
    threading.Thread(target=_publisher_loop, daemon=True,
                     name="metrics-publisher").start()


def aggregate_snapshots(kv_call, max_age_s: Optional[float] = None,
                        skip_ident: Optional[str] = None) -> List[dict]:
    """Merge all processes' published snapshots (driver-side).

    `skip_ident` excludes one process's key — the aggregating process
    reads its own registry live via local_snapshots(), so its published
    copy would double-count.  Stale keys (older than the TTL) are
    best-effort deleted, not just skipped."""
    if max_age_s is None:
        max_age_s = _metrics_ttl_s()
    out: List[dict] = []
    try:
        keys = kv_call({"op": "kv_keys", "prefix": _KV_PREFIX}) or []
    except Exception:
        return out
    for key in keys:
        if skip_ident is not None and key == _KV_PREFIX + skip_ident:
            continue
        # Per-key isolation: one corrupt/raced snapshot must not hide the
        # rest of the fleet's metrics.
        try:
            raw = kv_call({"op": "kv_get", "key": key})
            if raw is None:
                continue
            payload = pickle.loads(raw)
            if time.time() - payload.get("ts", 0) > max_age_s:
                try:
                    kv_call({"op": "kv_del", "key": key})
                except Exception:
                    pass
                continue
            out.extend(payload["snapshots"])
        except Exception:
            continue
    return out


def builtin_snapshots(runtime) -> List[dict]:
    """Cluster-state gauges synthesized from the control plane (the
    counterpart of the reference's ~90 C++ metric_defs: tasks/actors/
    objects/nodes by state)."""
    snaps: List[dict] = []

    def gauge(name, desc, series):
        snaps.append({"name": name, "kind": "gauge", "description": desc,
                      "series": series})

    try:
        tasks = runtime.state_list("tasks")
        by_state: Dict[str, int] = {}
        for t in tasks:
            by_state[t["state"]] = by_state.get(t["state"], 0) + 1
        gauge("ray_tpu_tasks", "Tasks by state",
              {(("state", s),): n for s, n in by_state.items()})
        actors = runtime.state_list("actors")
        by_state = {}
        for a in actors:
            by_state[a["state"]] = by_state.get(a["state"], 0) + 1
        gauge("ray_tpu_actors", "Actors by state",
              {(("state", s),): n for s, n in by_state.items()})
        objs = runtime.state_list("objects")
        gauge("ray_tpu_objects", "Objects in the cluster store",
              {(): len(objs)})
        gauge("ray_tpu_object_store_bytes", "Bytes in the object store",
              {(): float(sum(o.get("size") or 0 for o in objs))})
        nodes = runtime.state_list("nodes")
        gauge("ray_tpu_nodes", "Alive nodes",
              {(): sum(1 for n in nodes if n.get("alive", True))})
        workers = runtime.state_list("workers")
        by_state = {}
        for w in workers:
            by_state[w["state"]] = by_state.get(w["state"], 0) + 1
        gauge("ray_tpu_workers", "Workers by state",
              {(("state", s),): n for s, n in by_state.items()})
        pgs = runtime.state_list("placement_groups")
        by_state = {}
        for p in pgs:
            by_state[p["state"]] = by_state.get(p["state"], 0) + 1
        gauge("ray_tpu_placement_groups", "Placement groups by state",
              {(("state", s),): n for s, n in by_state.items()})
        # Per-node host stats from the reporter agents
        # (dashboard/reporter.py; reference reporter_agent metrics).
        per_node = {
            "cpu_percent": ("ray_tpu_node_cpu_percent",
                            "Node CPU utilization %"),
            "mem_used_bytes": ("ray_tpu_node_mem_used_bytes",
                               "Node memory used"),
            "mem_total_bytes": ("ray_tpu_node_mem_total_bytes",
                                "Node memory total"),
            "load_avg_1m": ("ray_tpu_node_load_avg_1m",
                            "Node 1-minute load average"),
            "object_store_used_bytes": (
                "ray_tpu_node_object_store_used_bytes",
                "Node arena bytes used"),
            "object_store_capacity_bytes": (
                "ray_tpu_node_object_store_capacity_bytes",
                "Node arena capacity"),
            "num_workers": ("ray_tpu_node_workers",
                            "Worker processes on the node"),
        }
        for key, (mname, mdesc) in per_node.items():
            series = {}
            for n in nodes:
                v = (n.get("stats") or {}).get(key)
                if v is not None:
                    series[(("node", n["node_id"]),)] = float(v)
            if series:
                gauge(mname, mdesc, series)
    except Exception:
        pass
    return snaps


def aggregate_prometheus_text(runtime) -> str:
    """Everything the cluster knows, as one Prometheus exposition:
    built-in state gauges + this process's live registry (incl. wire
    counters) + every other process's published snapshots."""
    snaps = builtin_snapshots(runtime)
    snaps.extend(local_snapshots())
    ident = (runtime.core.worker_hex if hasattr(runtime, "core")
             else "driver")
    snaps.extend(aggregate_snapshots(lambda msg: runtime.kv().call(msg),
                                     skip_ident=ident))
    return snapshots_to_prometheus_text(snaps)
