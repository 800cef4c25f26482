"""Copy of ray_tpu/dashboard/reporter.py (the rest of dashboard/ is
ROADMAP Queue A item 10).

Per-node host stats reporter.

Counterpart of the reference's per-node dashboard agent + reporter
module (dashboard/modules/reporter/reporter_agent.py samples psutil
stats and ships them to the head): each node manager runs a sampler
thread that reads /proc directly (no psutil dependency) and pushes one
compact stats dict to the head on an interval; the head attaches it to
the node table, so `ray_tpu_torch.nodes()`, the dashboard, and the Prometheus
endpoint all see live per-node CPU / memory / load / arena figures.

The head process samples itself with the same helper on read
(gcs._op_list_nodes), so single-node sessions get stats without a
reporter thread.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple


def _read_proc_stat() -> Tuple[float, float]:
    """(busy_jiffies, total_jiffies) across all CPUs."""
    with open("/proc/stat") as f:
        parts = f.readline().split()[1:]
    vals = [float(p) for p in parts]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0.0)  # idle+iowait
    return sum(vals) - idle, sum(vals)


def _read_meminfo() -> Dict[str, int]:
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            out[key] = int(rest.split()[0]) * 1024
    return out


class HostStatsSampler:
    """Stateful sampler: cpu_percent needs a delta between reads."""

    def __init__(self):
        self._last: Optional[Tuple[float, float]] = None

    def sample(self, store=None, num_workers: Optional[int] = None
               ) -> Dict[str, object]:
        stats: Dict[str, object] = {"ts": time.time()}
        try:
            busy, total = _read_proc_stat()
            if self._last is not None:
                db = busy - self._last[0]
                dt = total - self._last[1]
                stats["cpu_percent"] = round(100.0 * db / dt, 1) \
                    if dt > 0 else 0.0
            else:
                # First sample has no delta window; 0.0 (psutil's
                # convention) keeps the metric family present from the
                # first scrape.
                stats["cpu_percent"] = 0.0
            self._last = (busy, total)
        except OSError:
            pass
        try:
            mem = _read_meminfo()
            stats["mem_total_bytes"] = mem.get("MemTotal", 0)
            stats["mem_available_bytes"] = mem.get("MemAvailable", 0)
            stats["mem_used_bytes"] = (mem.get("MemTotal", 0)
                                       - mem.get("MemAvailable", 0))
        except OSError:
            pass
        try:
            stats["load_avg_1m"] = round(os.getloadavg()[0], 2)
        except OSError:
            pass
        if store is not None:
            try:
                cap, used, n, evicted = store.stats()
                stats["object_store_capacity_bytes"] = cap
                stats["object_store_used_bytes"] = used
                stats["object_store_objects"] = n
                stats["object_store_evicted_bytes"] = evicted
            except Exception:  # noqa: BLE001 — file-backed store
                pass
        if num_workers is not None:
            stats["num_workers"] = num_workers
        return stats
