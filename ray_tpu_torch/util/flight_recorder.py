"""Flight recorder: a bounded in-memory ring of recent events (the serve
engine's queue_full / shed / abort / kv_export / kv_import decisions
among them), dumpable on demand.

Copy of ray_tpu/util/flight_recorder.py.  When a decision looks wrong,
the last few thousand events are enough to reconstruct what happened,
without logging anything on the hot path.  Recording is a deque append
behind a lock; the ring evicts oldest-first so memory stays constant
for the life of the process.

Env knobs:
  RAY_TPU_FLIGHT_RECORDER            "0" disables recording entirely
  RAY_TPU_FLIGHT_RECORDER_MAX_EVENTS ring capacity (default 4096)

Each process holds its own ring.  When ``RAY_TPU_OPS_JOURNAL_DIR`` is
set every recorded event also spills to the durable "flight" journal
stream (util/journal.py — append is an enqueue; disk IO happens on the
journal's writer thread), and ``rehydrate()`` reloads past events into
the ring after a restart.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List

from ray_tpu_torch.util import journal as _journal

_FALSY = ("0", "false", "no", "off")

_lock = threading.Lock()
_dropped = 0
_enabled = os.environ.get(
    "RAY_TPU_FLIGHT_RECORDER", "1").strip().lower() not in _FALSY


def _default_capacity() -> int:
    try:
        cap = int(os.environ.get(
            "RAY_TPU_FLIGHT_RECORDER_MAX_EVENTS", "4096"))
    except ValueError:
        cap = 4096
    return max(16, cap)


_ring: "deque[Dict[str, Any]]" = deque(maxlen=_default_capacity())


def enabled() -> bool:
    return _enabled


def configure(capacity: int = 0, enable: bool = True) -> None:
    """Reconfigure the ring (tests / explicit opt-out at runtime).
    capacity <= 0 re-reads the env default.  Existing events are kept
    up to the new capacity (newest win)."""
    global _ring, _enabled, _dropped
    with _lock:
        cap = capacity if capacity > 0 else _default_capacity()
        _ring = deque(_ring, maxlen=max(16, cap))
        _enabled = enable
        _dropped = 0


def record(category: str, event: str, **fields: Any) -> None:
    """Append one event (no-op when disabled).  `category` picks the
    timeline lane ("wire" | "scheduler" | "object" | "health" |
    "serve" | "sched" — object-plane transfers: pull_begin/pull_end,
    push_begin/push_end, dedup_join, each carrying obj/peer/bytes and,
    on *_end, duration_s; health: the gcs watchdog's straggler /
    node_unhealthy / node_recovered verdicts; serve: the data plane's
    route / queue_full / shed / abort / stream_cancel decisions;
    sched: the head-scale-out fast paths — shard_dispatch [n drained
    from a submit-ingress shard], timer_fire [timer-wheel callback ran,
    with its deadline], index_rebuild [utilization-bucketed node index
    rebuilt, with node count]);
    `fields` are free-form and must be JSON-representable (they ride
    the dashboard dump)."""
    if not _enabled:
        return
    global _dropped
    entry = {"ts": time.time(), "category": category, "event": event}
    if fields:
        entry.update(fields)
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(entry)
    j = _journal.stream("flight")
    if j is not None:
        j.append(entry)


def dump(last: int = 0, since: float = 0.0) -> List[Dict[str, Any]]:
    """Snapshot the ring, oldest first; `last` > 0 returns only the
    newest N events; `since` > 0 drops events older than that epoch
    timestamp."""
    with _lock:
        events = list(_ring)
    if since > 0.0:
        events = [e for e in events if e.get("ts", 0.0) >= since]
    return events[-last:] if last > 0 else events


def rehydrate(since: float = 0.0) -> int:
    """Reload past events from the "flight" journal stream into the
    ring (head restart).  Events go straight into the ring — they are
    NOT re-journaled.  Returns the number restored."""
    global _ring
    directory = _journal.journal_dir()
    if not directory or not _enabled:
        return 0
    restored = 0
    with _lock:
        capacity = _ring.maxlen or 0
    envs = _journal.replay(directory, "flight", since=since,
                           max_records=capacity)
    with _lock:
        have = {(e.get("ts"), e.get("category"), e.get("event"))
                for e in _ring}
        merged = list(_ring)
        for env in envs:
            event = env.get("d")
            if not isinstance(event, dict):
                continue
            key = (event.get("ts"), event.get("category"),
                   event.get("event"))
            if key in have:
                continue
            merged.append(event)
            restored += 1
        merged.sort(key=lambda e: e.get("ts", 0.0))
        _ring = deque(merged, maxlen=_ring.maxlen)
    return restored


def stats() -> Dict[str, Any]:
    with _lock:
        return {"events": len(_ring), "capacity": _ring.maxlen,
                "dropped": _dropped, "enabled": _enabled}


def clear() -> None:
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0
