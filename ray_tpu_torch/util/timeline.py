"""Copy of ray_tpu/util/timeline.py.

Task timeline: chrome-trace dump of task scheduling/execution.

Counterpart of the reference's `ray timeline` path: TaskEventBuffer
(src/ray/core_worker/task_event_buffer.h:206) → GcsTaskManager →
chrome-trace JSON (python/ray/_private/state.py:434,
profiling.py:124 chrome_tracing_dump). Here the control server already
timestamps every task state transition (gcs.py TaskRecord), so the dump
reads the state API and emits one chrome-trace row per worker process:
a "scheduling" slice (submitted→started) on the driver row and an
"execution" slice (started→finished) on the executing worker's row.
Flight-recorder events (util/flight_recorder.py) add "wire" and
"scheduler" instant-event lanes so batching decisions and lease grants
line up against the tasks they carried.

Row order in Perfetto is pinned with process_sort_index metadata:
driver scheduling first, then driver spans, wire, scheduler, workers.

Open the output in chrome://tracing or https://ui.perfetto.dev.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

# Synthetic chrome-trace pids for the non-worker lanes (workers use
# their real OS pids, which start well above these).
DRIVER_PID = 0
SPANS_PID = 1  # tracing.py spans_to_chrome_events
WIRE_PID = 2
SCHED_PID = 3


def _sample_uniform(tasks: List[dict], max_tasks: int) -> List[dict]:
    """Evenly sample by submit order, ALWAYS retaining the first and
    last task (a plain int(i*step) stride can drop the final task and
    truncate the visible end of the trace)."""
    n = len(tasks)
    if max_tasks <= 1:
        return [tasks[0], tasks[-1]][:max(1, max_tasks)]
    step = (n - 1) / (max_tasks - 1)
    idx = {round(i * step) for i in range(max_tasks)}
    idx.update((0, n - 1))
    return [tasks[i] for i in sorted(idx)][:max_tasks]


def flight_recorder_events() -> List[Dict[str, Any]]:
    """This process's flight-recorder ring as chrome-trace instant
    events on dedicated wire/scheduler lanes.  (Per-process ring: with
    a remote head, these lanes show the driver side only.)"""
    from ray_tpu_torch.util import flight_recorder

    events: List[Dict[str, Any]] = []
    lanes = set()
    for e in flight_recorder.dump():
        pid = WIRE_PID if e.get("category") == "wire" else SCHED_PID
        lanes.add(pid)
        args = {k: v for k, v in e.items()
                if k not in ("ts", "category", "event")}
        events.append({
            "cat": e.get("category", "event"), "name": e.get("event", "?"),
            "ph": "i", "s": "p", "pid": pid, "tid": 0,
            "ts": e["ts"] * 1e6, "args": args,
        })
    for pid in sorted(lanes):
        name = "wire (rpc)" if pid == WIRE_PID else "scheduler (gcs)"
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": name}})
        events.append({"ph": "M", "pid": pid,
                       "name": "process_sort_index",
                       "args": {"sort_index": pid}})
    return events


def timeline_events(runtime=None, max_tasks: int = 0,
                    include_flight: bool = True) -> List[Dict[str, Any]]:
    """Build chrome-trace event dicts from the cluster's task records.

    max_tasks > 0 UNIFORMLY SAMPLES the task records first (every k-th
    by submit order, first and last always kept): a million-task
    session produces a trace a browser can open instead of a multi-GB
    JSON (reference timeline at scale samples the same way)."""
    from ray_tpu_torch.core.runtime import get_runtime

    rt = runtime or get_runtime()
    tasks = rt.state_list("tasks")
    if max_tasks and len(tasks) > max_tasks:
        tasks.sort(key=lambda t: t.get("submitted_at") or 0)
        tasks = _sample_uniform(tasks, max_tasks)
    events: List[Dict[str, Any]] = []
    pids = set()
    for t in tasks:
        name = t.get("name") or t["task_id"][:8]
        pid = t.get("pid") or 0
        sub, start, fin = (t.get("submitted_at"), t.get("started_at"),
                           t.get("finished_at"))
        trace_args = {}
        if t.get("trace_id"):
            trace_args = {"trace_id": t["trace_id"],
                          "span_id": t.get("span_id") or "",
                          "parent_span_id": t.get("parent_span_id") or ""}
        if sub and start and start >= sub:
            events.append({
                "cat": "scheduling", "name": f"schedule:{name}",
                "ph": "X", "pid": DRIVER_PID, "tid": 0,
                "ts": sub * 1e6, "dur": (start - sub) * 1e6,
                "args": {"task_id": t["task_id"], "state": t["state"],
                         **trace_args},
            })
        if start and fin and fin >= start:
            pids.add(pid)
            events.append({
                "cat": "task", "name": name, "ph": "X",
                "pid": pid, "tid": 0,
                "ts": start * 1e6, "dur": (fin - start) * 1e6,
                "args": {"task_id": t["task_id"], "state": t["state"],
                         "worker": t.get("worker", ""),
                         **trace_args},
            })
    # Row labels (chrome-trace metadata events); sort_index pins the
    # driver scheduling row to the top of the Perfetto view.
    events.append({"ph": "M", "pid": DRIVER_PID, "name": "process_name",
                   "args": {"name": "driver (scheduling)"}})
    events.append({"ph": "M", "pid": DRIVER_PID,
                   "name": "process_sort_index",
                   "args": {"sort_index": -1}})
    for pid in sorted(pids):
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": f"worker pid={pid}"}})
    if include_flight:
        try:
            events.extend(flight_recorder_events())
        except Exception:
            pass
    return events


def timeline(filename: Optional[str] = None, runtime=None):
    """Dump the chrome-trace timeline; returns the events (and writes
    `filename` if given) — counterpart of ray.timeline()
    (python/ray/_private/state.py:434)."""
    events = timeline_events(runtime)
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events
