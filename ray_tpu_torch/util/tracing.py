"""Copy of ray_tpu/util/tracing.py (the port imports nothing of the JAX
package).

Opt-in application tracing: spans around task submission + user code.

Counterpart of the reference's ray.util.tracing.tracing_helper
(python/ray/util/tracing/tracing_helper.py: _OpenTelemetryProxy :34,
_DictPropagator :165, decorators wrapping _remote/execute). The reference
depends on the opentelemetry SDK and injects span context into task
metadata; here tracing is self-contained (zero extra deps, zero egress):

  - `enable_tracing()` flips a process-local flag (the reference's
    `ray.init(_tracing_startup_hook=...)` opt-in).
  - `trace_span(name)` is a context manager recording a span on a
    thread-local stack (parent/child nesting within a process).
  - Cross-process propagation (the reference's _DictPropagator): the
    task layer captures a compact (trace_id, parent span_id) context at
    submission — `make_trace_ctx()` — which rides the TaskSpec and is
    restored around execution on the worker (`begin_task_span` /
    `end_task_span`), so driver→worker→nested-task hops share one
    trace_id with correct parent links and no extra wire round-trips.
  - Spans live in a BOUNDED ring (env RAY_TPU_TRACE_MAX_SPANS, default
    100k): long-running drivers evict oldest spans instead of leaking;
    `dropped_span_count()` reports evictions.
  - `export_chrome_trace(path)` merges local spans with the cluster task
    timeline (util/timeline.py, including its wire/scheduler lanes)
    into one chrome-trace file Perfetto can open.
"""

from __future__ import annotations

import contextvars
import json
import os
import random
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

_enabled = False
_spans_lock = threading.Lock()
_dropped_spans = 0
# Monotonic count of spans EVER appended to the ring (never reset by
# eviction).  Gives every ring slot an implicit sequence number —
# slot i holds seq (_seq_end - len(_spans) + i) — which is what lets
# the cluster span harvest (gcs._op_harvest_spans) pull incrementally
# with a plain integer cursor instead of re-shipping the whole ring.
_seq_end = 0
_local = threading.local()

# Execution-side trace context restored from an incoming TaskSpec:
# (trace_id, current span_id).  A contextvar (not thread-local) so async
# actor tasks each see their own context on the shared event loop.
_task_ctx: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = \
    contextvars.ContextVar("ray_tpu_trace_ctx", default=None)


def _max_spans() -> int:
    try:
        cap = int(os.environ.get("RAY_TPU_TRACE_MAX_SPANS", "100000"))
    except ValueError:
        cap = 100000
    return max(16, cap)


_spans: "deque[tuple]" = deque(maxlen=_max_spans())


def enable_tracing() -> None:
    """Enable span recording in this process; re-reads
    RAY_TPU_TRACE_MAX_SPANS so tests/apps can resize the ring."""
    global _enabled, _spans
    cap = _max_spans()
    with _spans_lock:
        if cap != _spans.maxlen:
            _spans = deque(_spans, maxlen=cap)
    _enabled = True


def disable_tracing() -> None:
    global _enabled
    _enabled = False


def is_tracing_enabled() -> bool:
    return _enabled


def _stack() -> List[str]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


_rand = random.Random(uuid.uuid4().int)
_rand_pid = os.getpid()


def _new_id() -> str:
    # Not uuid4 per id: that is an os.urandom syscall on every task
    # submit/execute, measurable on the control-plane hot path.  One
    # urandom seed per process, then a process-local PRNG (reseeded
    # after fork — a child inheriting the parent's PRNG state would
    # mint the parent's exact id stream).
    global _rand, _rand_pid
    pid = os.getpid()
    if pid != _rand_pid:
        _rand = random.Random(uuid.uuid4().int)
        _rand_pid = pid
    return f"{_rand.getrandbits(64):016x}"


def current_trace_id() -> str:
    """The trace id new spans/submissions belong to: the restored task
    context's id inside a traced task, else a lazily minted per-thread
    id on the driver."""
    ctx = _task_ctx.get()
    if ctx is not None:
        return ctx[0]
    tid = getattr(_local, "trace_id", None)
    if tid is None:
        tid = _local.trace_id = _new_id()
    return tid


def current_span_id() -> Optional[str]:
    stack = _stack()
    if stack:
        return stack[-1]
    ctx = _task_ctx.get()
    return ctx[1] if ctx is not None else None


def make_trace_ctx() -> Optional[Tuple[str, str]]:
    """Compact context injected into TaskSpecs at submission: (trace_id,
    parent span_id).  Inside a traced task this returns the RESTORED
    context even when local tracing is off — nested submissions stay
    stitched to the driver's trace without enabling recording in
    workers.  Returns None (nothing rides the wire) when there is no
    trace to continue and tracing is off."""
    ctx = _task_ctx.get()
    if ctx is not None:
        return (ctx[0], current_span_id() or ctx[1])
    if not _enabled:
        return None
    return (current_trace_id(), current_span_id() or "")


# Ring slots are TUPLES (span_id, parent_id, trace_id, name, start,
# end, attributes-or-None), not dicts: a tuple of atomics is untracked
# by the cyclic GC after its first collection, so a full 100k-span ring
# adds nothing to gen2 scans — per-span dicts would tax every
# allocation-heavy burst in the recording process.  get_spans()
# materializes the dict view.
def _append_span(span: tuple) -> None:
    global _dropped_spans, _seq_end
    with _spans_lock:
        if len(_spans) == _spans.maxlen:
            _dropped_spans += 1
        _spans.append(span)
        _seq_end += 1


def record_span(name: str, start: float, end: float,
                attributes: Optional[Dict[str, Any]] = None,
                parent_id: Optional[str] = None,
                trace_id: Optional[str] = None,
                span_id: Optional[str] = None,
                force: bool = False) -> Optional[str]:
    """Record a completed span (no-op unless tracing is enabled or
    `force` — execution spans restored from a remote context record even
    in non-traced worker processes, so a worker-side export still shows
    them)."""
    if not (_enabled or force):
        return None
    span_id = span_id or _new_id()
    _append_span((span_id,
                  parent_id or current_span_id(),
                  trace_id or current_trace_id(),
                  name, start, end, attributes))
    return span_id


@contextmanager
def trace_span(name: str, attributes: Optional[Dict[str, Any]] = None):
    """Context manager for a nested span; cheap no-op when disabled.
    A caller-provided `attributes` dict is kept by identity, so fields
    added inside (or just after) the block land on the span."""
    if not _enabled:
        yield None
        return
    span_id = _new_id()
    parent = current_span_id()
    trace_id = current_trace_id()
    _stack().append(span_id)
    start = time.time()
    try:
        yield span_id
    finally:
        _stack().pop()
        _append_span((span_id, parent, trace_id, name, start,
                      time.time(), attributes))


# ---------------------------------------------------------------------------
# Execution-side propagation (worker.py): restore the spec's trace_ctx
# around task execution so nested submissions parent correctly.
# ---------------------------------------------------------------------------

def begin_task_span(trace_ctx: Tuple[str, str]):
    """Enter a task-execution span from a remote context; returns
    (reset token, execution span_id).  The span id becomes the parent
    of everything the task does — nested submissions, local
    trace_span()s — and of the task's lifecycle events."""
    span_id = _new_id()
    token = _task_ctx.set((trace_ctx[0], span_id))
    return token, span_id


def end_task_span(token, name: str, start: float, end: float,
                  trace_ctx: Tuple[str, str], span_id: str,
                  attributes: Optional[Dict[str, Any]] = None) -> None:
    """Close a task-execution span: restore the previous context and
    record the span locally (forced — the executing process need not
    have tracing enabled)."""
    _task_ctx.reset(token)
    record_span(name, start, end, attributes=attributes,
                parent_id=trace_ctx[1] or None, trace_id=trace_ctx[0],
                span_id=span_id, force=True)


def set_task_ctx(trace_ctx: Tuple[str, str]) -> str:
    """Async-task variant of begin_task_span: installs the context in
    the CURRENT contextvars context (each asyncio task runs in its own
    copy, so no reset is needed) and returns the execution span id."""
    span_id = _new_id()
    _task_ctx.set((trace_ctx[0], span_id))
    return span_id


# ---------------------------------------------------------------------------
# Serve request-journey support: wall/monotonic alignment + trace gate
# ---------------------------------------------------------------------------

# Captured ONCE at import: adding this to a time.monotonic() reading
# yields the epoch time the reading corresponds to in THIS process.
# Recomputing per call would jitter by scheduler noise; a fixed offset
# keeps one request's spans self-consistent even if NTP steps the wall
# clock mid-run.
_CLOCK_OFFSET = time.time() - time.monotonic()


def clock_offset() -> float:
    """This process's monotonic→epoch offset (epoch = monotonic +
    offset).  Stamped into serve span/timeline records so lanes from
    two replicas (two processes, two monotonic origins) line up when a
    trace is reassembled offline (scripts/opsdump.py, Perfetto)."""
    return _CLOCK_OFFSET


def mono_to_epoch(t_mono: float) -> float:
    """Convert a time.monotonic() reading from THIS process to epoch
    seconds (comparable across processes, same basis as span times)."""
    return t_mono + _CLOCK_OFFSET


def serve_trace_enabled() -> bool:
    """Request-journey tracing gate for the serve data plane
    (RAY_TPU_SERVE_TRACE, default on).  Read per request — an env read
    is nanoseconds next to a model step — so the paired overhead bench
    (scripts/bench_serve.py tracing phase) can flip it between arms
    without rebuilding the serving stack."""
    return os.environ.get("RAY_TPU_SERVE_TRACE", "1").strip().lower() \
        not in ("0", "false", "no", "off")


def parse_serve_trace(header: str) -> Optional[Tuple[str, str]]:
    """Parse an X-Serve-Trace header value — ``<trace_id>`` or
    ``<trace_id>:<span_id>`` (16 hex chars each) — into a
    (trace_id, parent_span_id) context; malformed values are ignored
    (the proxy mints a fresh trace instead of propagating garbage)."""
    if not header or not isinstance(header, str):
        return None
    trace_id, _, span_id = header.strip().partition(":")
    if not _is_hex_id(trace_id):
        return None
    if span_id and not _is_hex_id(span_id):
        span_id = ""
    return (trace_id.lower(), span_id.lower())


def _is_hex_id(s: str) -> bool:
    if len(s) != 16:
        return False
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


def mint_serve_trace(header: str = "") -> Tuple[str, str]:
    """Adopt the incoming X-Serve-Trace context or mint a fresh one.
    Returns (trace_id, parent_span_id); parent is "" for a new trace."""
    ctx = parse_serve_trace(header)
    if ctx is not None:
        return ctx
    return (_new_id(), "")


def new_span_id() -> str:
    """A fresh 16-hex span id (public alias of the internal minting —
    serve layers pre-allocate ids so children can parent under a span
    that is recorded later, when it completes)."""
    return _new_id()


# ---------------------------------------------------------------------------
# Introspection / export
# ---------------------------------------------------------------------------

def get_spans() -> List[Dict[str, Any]]:
    with _spans_lock:
        rows = list(_spans)
    return [{"span_id": s, "parent_id": p, "trace_id": t, "name": n,
             "start": st, "end": en,
             "attributes": {} if a is None else a}
            for s, p, t, n, st, en, a in rows]


def clear_spans() -> None:
    global _dropped_spans, _seq_end
    with _spans_lock:
        _spans.clear()
        _dropped_spans = 0
        _seq_end = 0


def span_cursor() -> int:
    """The cursor one past the newest recorded span (total spans ever
    appended).  A harvester holding this value and calling
    collect_spans_since(cursor) later gets exactly the spans recorded
    in between."""
    with _spans_lock:
        return _seq_end


def collect_spans_since(cursor: int, max_spans: int = 2048
                        ) -> Dict[str, Any]:
    """Incremental, bounded read of the span ring for the cluster-wide
    harvest (the collect_spans wire op).

    Returns {"rows": [...], "cursor": next_cursor, "missed": n} where
    `missed` counts spans that were evicted from the ring before this
    read could see them (cursor fell behind by more than the ring
    capacity).  Rows are the raw ring tuples — (span_id, parent_id,
    trace_id, name, start, end, attributes|None) — NOT expanded into
    keyed dicts: at harvest rates the dict keys dominate the JSON frame
    (7 key strings per span), so the wire carries the compact form and
    only query replies (gcs._harvest_spans_sync) pay for dict
    expansion.  At most `max_spans` rows are returned per call so a
    full 100k-span ring streams out as many small frames, never one
    giant reply; callers loop until len(rows) < max_spans."""
    max_spans = max(1, int(max_spans))
    with _spans_lock:
        start_seq = _seq_end - len(_spans)
        cursor = max(0, int(cursor))
        missed = max(0, start_seq - cursor)
        skip = max(0, cursor - start_seq)
        avail = len(_spans) - skip
        if avail <= 0:
            return {"rows": [], "cursor": _seq_end, "missed": missed}
        n = min(avail, max_spans)
        # deque slicing via itertools-free index walk: islice would be
        # O(skip) anyway; a list() copy of the window keeps the lock
        # window short for typical (small) harvest chunks.
        rows = [list(_spans[skip + i]) for i in range(n)]
        new_cursor = start_seq + skip + n
    return {"rows": rows, "cursor": new_cursor, "missed": missed}


def span_row_to_dict(row) -> Dict[str, Any]:
    """Expand a collect_spans_since row (optionally extended with
    worker/pid by the head's ingest) into the keyed span dict the
    /api/spans and /api/trace surfaces serve."""
    s = {"span_id": row[0], "parent_id": row[1], "trace_id": row[2],
         "name": row[3], "start": row[4], "end": row[5],
         "attributes": {} if row[6] is None else row[6]}
    if len(row) > 7 and row[7]:
        s["worker"] = row[7]
    if len(row) > 8 and row[8]:
        s["pid"] = row[8]
    return s


def dropped_span_count() -> int:
    """Spans evicted from the bounded ring since the last clear."""
    with _spans_lock:
        return _dropped_spans


def spans_to_chrome_events(spans: List[Dict[str, Any]], pid: int = 1,
                           process_name: str = "driver spans",
                           sort_index: int = 1) -> List[Dict[str, Any]]:
    """Spans as chrome-trace X slices on one process lane.  Defaults
    keep the historical driver lane (pid 1); the dashboard passes each
    harvested worker's real OS pid so its spans land on the same row as
    that worker's execution slices (util/timeline.py convention)."""
    events = []
    for s in spans:
        events.append({
            "cat": "span", "name": s["name"], "ph": "X",
            "pid": pid, "tid": 0,
            "ts": s["start"] * 1e6,
            "dur": max(0.0, s["end"] - s["start"]) * 1e6,
            "args": {**s["attributes"], "span_id": s["span_id"],
                     "parent_id": s["parent_id"],
                     "trace_id": s.get("trace_id", "")},
        })
    if events:
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": process_name}})
        events.append({"ph": "M", "pid": pid,
                       "name": "process_sort_index",
                       "args": {"sort_index": sort_index}})
    return events


def trace_events(runtime=None, max_tasks: int = 0
                 ) -> List[Dict[str, Any]]:
    """The unified trace: local spans + cluster task/scheduling lanes +
    wire/scheduler flight-recorder lanes, as one chrome-trace event
    list (the dashboard's /api/trace payload)."""
    events = spans_to_chrome_events(get_spans())
    try:
        from ray_tpu_torch.util.timeline import timeline_events

        events.extend(timeline_events(runtime, max_tasks=max_tasks))
    except Exception:
        pass
    return events


def export_chrome_trace(filename: str, include_tasks: bool = True) -> int:
    """Write local spans (+ the cluster task timeline and wire/scheduler
    lanes) as chrome-trace JSON; returns the number of events written."""
    events = (trace_events() if include_tasks
              else spans_to_chrome_events(get_spans()))
    with open(filename, "w") as f:
        json.dump(events, f)
    return len(events)
