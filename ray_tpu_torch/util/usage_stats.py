"""Copy of ray_tpu/util/usage_stats.py.

Feature-usage recording (local-only; no network).

Counterpart of the reference's usage-stats subsystem
(python/ray/_private/usage/usage_lib.py: opt-out telemetry pings +
feature-usage tags). This build never phones home — the same tag API
writes a JSON summary into the session dir instead, giving operators the
reference's "which features does this cluster actually use" view without
any egress. Opt out with RAY_TPU_USAGE_STATS_ENABLED=0.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict

_lock = threading.Lock()
_tags: Dict[str, str] = {}
_counters: Dict[str, int] = {}


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_USAGE_STATS_ENABLED", "1") != "0"


def record_library_usage(library: str) -> None:
    """Mark a library as used this session (reference:
    record_library_usage in usage_lib.py)."""
    if not usage_stats_enabled():
        return
    with _lock:
        _counters[f"library:{library}"] = \
            _counters.get(f"library:{library}", 0) + 1


def record_extra_usage_tag(key: str, value: str) -> None:
    if not usage_stats_enabled():
        return
    with _lock:
        _tags[key] = str(value)


def usage_summary() -> dict:
    with _lock:
        return {"tags": dict(_tags), "counters": dict(_counters),
                "ts": time.time()}


def write_usage_report(session_dir: str) -> str:
    """Persist the summary (called at shutdown); returns the path."""
    path = os.path.join(session_dir, "usage_stats.json")
    try:
        with open(path, "w") as f:
            json.dump(usage_summary(), f, indent=2)
    except OSError:
        pass
    return path
