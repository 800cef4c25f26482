"""Application metrics: Counter / Gauge / Histogram + Prometheus export.

Copy of the process-local half of ray_tpu/util/metrics.py: the registry,
the three metric kinds, snapshots, their merge and their Prometheus text
and journal (JSON) forms.  Metrics are cheap host bookkeeping (a dict
update behind a lock); nothing here touches the device path.

Not carried over yet: publishing snapshots into the cluster KV, their
aggregation across processes and the cluster-state gauges
(`publish_now` and what follows it in the reference), which need the
runtime the port does not have yet.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.util import flight_recorder as _fr
from ray_tpu_torch.util import journal as _journal
from ray_tpu_torch.util import tracing as _tr

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}


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
        # Deep-copy mutable bucket lists so a snapshot is a stable view.
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
    """This process's registry, plus the trace ring's and the flight
    recorder's own counters (the reference also folds in its wire and
    object-plane telemetry, which need the runtime the port lacks)."""
    with _registry_lock:
        metrics = list(_registry.values())
    snaps = [m.snapshot() for m in metrics]
    # Silent-drop visibility: the tracing ring and flight recorder both
    # evict oldest-first without logging — surface eviction counts and
    # ring occupancy so a truncated trace is diagnosable from /metrics
    # instead of a mystery.
    snaps.append({
        "name": "ray_tpu_trace_dropped_spans_total",
        "kind": "counter",
        "description": "Spans evicted from this process's bounded "
                       "trace ring",
        "series": {(): float(_tr.dropped_span_count())}})
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
    return snaps


# ---------------------------------------------------------------------------
# Journal form
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
    """Append snapshots to the "metrics" journal stream (no-op while
    journaling is off); the reference's publisher calls this per tick."""
    j = _journal.stream("metrics")
    if j is not None:
        j.append({"snapshots": snapshots_json_safe(snaps)})
