"""Host memory monitor + OOM worker-killing policy.

Counterparts: src/ray/common/memory_monitor.h:52 (periodic usage
sampling against a threshold) and the raylet's worker-killing policies
(src/ray/raylet/worker_killing_policy*.cc — kill retriable tasks first,
newest first, so long-running work survives and the killed task retries).
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional, Tuple


def system_memory() -> Tuple[int, int]:
    """(available_bytes, total_bytes) from /proc/meminfo; respects a
    cgroup v2 limit when one is set (containerized nodes)."""
    total = avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:
        return (0, 0)
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            raw = f.read().strip()
        if raw != "max":
            limit = int(raw)
            with open("/sys/fs/cgroup/memory.current") as f:
                used = int(f.read().strip())
            # memory.current counts reclaimable page cache; subtract
            # inactive_file so streaming IO (including our own spill
            # writes) doesn't read as pressure — matching the host
            # path's MemAvailable semantics (and the reference's
            # memory_monitor.cc, which does the same).
            try:
                with open("/sys/fs/cgroup/memory.stat") as f:
                    for line in f:
                        if line.startswith("inactive_file "):
                            used = max(0, used - int(line.split()[1]))
                            break
            except (OSError, ValueError):
                pass
            if limit < total:
                return (max(limit - used, 0), limit)
    except (OSError, ValueError):
        pass
    return (avail, total)


def memory_usage_fraction() -> float:
    avail, total = system_memory()
    if not total:
        return 0.0
    return 1.0 - avail / total


class MemoryMonitor:
    """Samples usage every `interval_s`; calls `on_high(fraction)` while
    above `threshold`."""

    def __init__(self, threshold: float = 0.95, interval_s: float = 1.0,
                 on_high: Optional[Callable[[float], None]] = None,
                 usage_fn: Callable[[], float] = memory_usage_fraction):
        self.threshold = threshold
        self.interval_s = interval_s
        self.on_high = on_high
        self.usage_fn = usage_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="memory-monitor")

    def start(self) -> "MemoryMonitor":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                frac = self.usage_fn()
            except Exception:
                continue
            if frac >= self.threshold and self.on_high is not None:
                try:
                    self.on_high(frac)
                except Exception:
                    pass


def pick_worker_to_kill(candidates: List[dict],
                        allow_nonretriable: bool = False
                        ) -> Optional[dict]:
    """Retriable-FIFO policy (worker_killing_policy.cc): kill the most
    recently started RETRIABLE task's worker (LIFO — oldest work is most
    expensive to lose). Candidates: dicts with `retriable` (bool) and
    `started_at` (float).

    Returns None when nothing is safe to kill. Only with
    `allow_nonretriable=True` (last-resort pressure, where the
    alternative is the kernel OOM-killing the whole node) will a
    non-retriable task's worker be chosen."""
    retriable = [c for c in candidates if c.get("retriable")]
    pool = retriable or (candidates if allow_nonretriable else [])
    if not pool:
        return None
    return max(pool, key=lambda c: c.get("started_at") or 0.0)
