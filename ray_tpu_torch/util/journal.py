"""Durable ops journal: bounded on-disk record streams for the
observability plane (spans, flight-recorder events, metrics snapshots,
device telemetry).

Copy of ray_tpu/util/journal.py, with its segment format, stream names
and settings, so that either package replays what the other wrote.  The
live rings in `tracing`, `flight_recorder` and `metrics` are in-memory
only; each named *stream* spills into length-prefixed JSONL segments
under ``RAY_TPU_OPS_JOURNAL_DIR``, and `replay` reads any past window
back.

Design constraints:

  * ``append()`` is an enqueue under a lock — never touches the
    filesystem, so it is safe from hot paths and lock-held paths.
    A dedicated daemon writer thread drains the queue, batching
    ``write()+fsync()`` on an interval (``RAY_TPU_OPS_JOURNAL_FSYNC_S``)
    so durability costs are amortized, not per-record.
  * Segments are bounded: a segment rotates once it exceeds its size
    share or age (``RAY_TPU_OPS_JOURNAL_ROTATE_S``); stream-wide
    retention deletes oldest segments past
    ``RAY_TPU_OPS_JOURNAL_MAX_BYTES``.
  * Crash safe: records are ``%08x <json>\\n`` (hex byte-length prefix
    of the JSON payload).  A kill -9 mid-write leaves at most one
    truncated tail record, which replay detects and drops — everything
    before it is served intact.

Multi-process: every process appends to its own pid-suffixed segments
(``<stream>-<pid>-<seq>.jrnl``); replay merges across pids by
timestamp.  Retention never deletes another pid's newest segment (it
may still be open for append).

The journal is off by default — ``stream(name)`` returns None unless
``RAY_TPU_OPS_JOURNAL_DIR`` is set — so the live path stays zero-cost.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ray_tpu_torch.core import log_once

logger = logging.getLogger(__name__)

_SEGMENT_RE = re.compile(r"^(?P<stream>.+)-(?P<pid>\d+)-(?P<seq>\d+)\.jrnl$")

# Bound on records queued in memory awaiting the writer thread; past
# this, oldest pending records are dropped (counted in stats()).
_MAX_PENDING = 50000
# Queue depth past which append() wakes the writer early instead of
# waiting out the fsync interval.
_WAKE_DEPTH = 512


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def journal_dir() -> str:
    """The configured journal root ('' = journaling disabled)."""
    return os.environ.get("RAY_TPU_OPS_JOURNAL_DIR", "").strip()


class Journal:
    """One append-only record stream, written by a background thread."""

    def __init__(self, directory: str, stream: str,
                 max_bytes: int = 0, rotate_s: float = 0.0,
                 fsync_s: float = 0.0) -> None:
        if not _SEGMENT_RE.match(f"{stream}-0-0.jrnl"):
            raise ValueError(f"bad stream name: {stream!r}")
        self.directory = directory
        self.stream = stream
        self.max_bytes = max_bytes or _env_int(
            "RAY_TPU_OPS_JOURNAL_MAX_BYTES", 67108864)
        self.rotate_s = rotate_s or _env_float(
            "RAY_TPU_OPS_JOURNAL_ROTATE_S", 600.0)
        self.fsync_s = fsync_s or _env_float(
            "RAY_TPU_OPS_JOURNAL_FSYNC_S", 0.2)
        # A segment's size share: rotate well before one segment could
        # swallow the whole retention budget.
        self.segment_bytes = max(1 << 20, self.max_bytes // 8)
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._buf: "deque[Tuple[float, Any]]" = deque()
        self._wake = threading.Event()
        self._flushed = threading.Condition(self._lock)
        self._gen = 0            # drain generation, bumped per drain
        self._stop = False
        self.closed = False
        self._dropped = 0
        self._appended = 0
        self._written = 0
        self._fh = None          # open segment file object
        self._seg_path = ""
        self._seg_bytes = 0
        self._seg_opened_at = 0.0
        self._last_fsync = 0.0
        self._force_sync = False  # flush() demands durability now
        self._seq = 0
        os.makedirs(directory, exist_ok=True)
        self._seq = self._next_seq()
        self._writer = threading.Thread(
            target=self._run, name=f"ops-journal-{stream}", daemon=True)
        self._writer.start()

    # -- hot path ---------------------------------------------------------

    def append(self, record: Any) -> None:
        """Enqueue one JSON-representable record (never blocks on IO)."""
        if self.closed:
            return
        wake = False
        with self._lock:
            if len(self._buf) >= _MAX_PENDING:
                self._buf.popleft()
                self._dropped += 1
            self._buf.append((time.time(), record))
            self._appended += 1
            wake = len(self._buf) >= _WAKE_DEPTH
        if wake:
            self._wake.set()

    # -- writer thread ----------------------------------------------------

    def _run(self) -> None:
        while True:
            self._wake.wait(timeout=self.fsync_s)
            self._wake.clear()
            stop = self._stop
            try:
                self._drain()
            except OSError as exc:
                log_once.warn_once(
                    logger, "journal-write", exc,
                    "ops journal write failed (stream=%s)" % self.stream)
            if stop:
                break
        try:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None
        except OSError:  # raylint: allow-swallow(best-effort close at exit)
            pass

    def _drain(self) -> None:
        with self._lock:
            batch = list(self._buf)
            self._buf.clear()
        if batch:
            self._write_batch(batch)
        elif self._force_sync and self._fh is not None:
            os.fsync(self._fh.fileno())
            self._last_fsync = time.time()
            self._force_sync = False
        with self._lock:
            self._gen += 1
            self._flushed.notify_all()

    def _write_batch(self, batch: List[Tuple[float, Any]]) -> None:
        now = time.time()
        if (self._fh is not None
                and (self._seg_bytes >= self.segment_bytes
                     or now - self._seg_opened_at >= self.rotate_s)):
            self._rotate()
        if self._fh is None:
            self._open_segment()
        chunks = []
        for ts, record in batch:
            payload = json.dumps(
                {"t": round(ts, 6), "p": self._pid, "d": record},
                separators=(",", ":"), default=str).encode()
            chunks.append(b"%08x " % len(payload) + payload + b"\n")
        data = b"".join(chunks)
        self._fh.write(data)
        self._fh.flush()
        # Depth-triggered wakes drain more often than fsync_s; pace the
        # fsync to the knob so the durability window — not the drain
        # cadence — is what fsync_s buys.  flush() overrides the pacing.
        if self._force_sync or now - self._last_fsync >= self.fsync_s:
            os.fsync(self._fh.fileno())
            self._last_fsync = now
            self._force_sync = False
        self._seg_bytes += len(data)
        self._written += len(batch)

    def _open_segment(self) -> None:
        self._seq += 1
        name = f"{self.stream}-{self._pid}-{self._seq:08d}.jrnl"
        self._seg_path = os.path.join(self.directory, name)
        self._fh = open(self._seg_path, "ab")
        self._seg_bytes = self._fh.tell()
        self._seg_opened_at = time.time()

    def _rotate(self) -> None:
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
        finally:
            self._fh = None
        self._enforce_retention()

    def _next_seq(self) -> int:
        seq = 0
        for _, pid, s, _ in self._segments():
            if pid == self._pid:
                seq = max(seq, s)
        return seq

    def _segments(self) -> List[Tuple[str, int, int, int]]:
        """(path, pid, seq, size) for every segment of this stream,
        any pid, oldest-mtime first."""
        return list_segments(self.directory, self.stream)

    def _enforce_retention(self) -> None:
        segs = self._segments()
        total = sum(size for _, _, _, size in segs)
        if total <= self.max_bytes:
            return
        # Never delete the newest segment of any pid: it may be the
        # live append target of another process.
        newest_by_pid: Dict[int, int] = {}
        for _, pid, seq, _ in segs:
            newest_by_pid[pid] = max(newest_by_pid.get(pid, 0), seq)
        for path, pid, seq, size in segs:
            if total <= self.max_bytes:
                break
            if seq == newest_by_pid.get(pid):
                continue
            try:
                os.unlink(path)
                total -= size
            except OSError:  # raylint: allow-swallow(racing deleter wins)
                pass

    # -- control ----------------------------------------------------------

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every record appended before this call is on
        disk (tests / orderly shutdown).  Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._lock:
            target = self._gen + (2 if self._buf else 1)
            self._force_sync = True
        self._wake.set()
        with self._flushed:
            while self._gen < target:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._flushed.wait(timeout=left)
                self._wake.set()
        return True

    def close(self, timeout: float = 5.0) -> None:
        if self.closed:
            return
        self.closed = True
        self._stop = True
        self._wake.set()
        self._writer.join(timeout=timeout)

    def stats(self) -> Dict[str, Any]:
        segs = self._segments()
        with self._lock:
            return {
                "stream": self.stream,
                "appended": self._appended,
                "written": self._written,
                "pending": len(self._buf),
                "dropped": self._dropped,
                "segments": len(segs),
                "bytes": sum(size for _, _, _, size in segs),
            }


# -- replay (read side) ----------------------------------------------------

def list_segments(directory: str,
                  stream: str) -> List[Tuple[str, int, int, int]]:
    """(path, pid, seq, size) for every segment of `stream` under
    `directory`, sorted oldest-mtime first."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        m = _SEGMENT_RE.match(name)
        if not m or m.group("stream") != stream:
            continue
        path = os.path.join(directory, name)
        try:
            st = os.stat(path)
        except OSError:  # raylint: allow-swallow(segment raced deletion)
            continue
        out.append((st.st_mtime, path, int(m.group("pid")),
                    int(m.group("seq")), st.st_size))
    out.sort()
    return [(path, pid, seq, size) for _, path, pid, seq, size in out]


def _iter_segment(path: str) -> Iterator[Dict[str, Any]]:
    """Yield complete records from one segment; stop at the first
    truncated or corrupt tail (crash recovery)."""
    try:
        fh = open(path, "rb")
    except OSError:  # raylint: allow-swallow(segment raced deletion)
        return
    with fh:
        while True:
            head = fh.read(9)
            if len(head) < 9 or head[8:9] != b" ":
                break
            try:
                n = int(head[:8], 16)
            except ValueError:
                break
            payload = fh.read(n + 1)
            if len(payload) < n + 1 or payload[n:] != b"\n":
                break
            try:
                env = json.loads(payload[:n])
            except ValueError:
                break
            if isinstance(env, dict) and "d" in env:
                yield env


def replay(directory: str, stream: str, since: float = 0.0,
           until: float = 0.0,
           max_records: int = 0) -> List[Dict[str, Any]]:
    """All surviving records of `stream`, merged across pids and
    sorted by append timestamp.  Each element is the envelope
    ``{"t": ts, "p": pid, "d": record}``.  `since`/`until` bound the
    window (0 = unbounded); `max_records` keeps the newest N."""
    records: List[Dict[str, Any]] = []
    for path, _, _, _ in list_segments(directory, stream):
        for env in _iter_segment(path):
            ts = env.get("t", 0.0)
            if not isinstance(ts, (int, float)):
                continue
            if since and ts < since:
                continue
            if until and ts > until:
                continue
            records.append(env)
    records.sort(key=lambda e: e.get("t", 0.0))
    if max_records and len(records) > max_records:
        records = records[-max_records:]
    return records


# -- per-process shared streams -------------------------------------------

_streams: Dict[str, Journal] = {}
_streams_lock = threading.Lock()


def stream(name: str) -> Optional[Journal]:
    """The process-wide journal for `name`, or None when journaling is
    disabled (RAY_TPU_OPS_JOURNAL_DIR unset).  Cheap enough to call
    per-event: one dict lookup under a lock on the common path."""
    directory = journal_dir()
    if not directory:
        return None
    with _streams_lock:
        j = _streams.get(name)
        if j is None or j.closed or j.directory != directory:
            try:
                j = Journal(directory, name)
            except (OSError, ValueError) as exc:
                log_once.warn_once(
                    logger, "journal-open", exc,
                    "cannot open ops journal (dir=%s stream=%s)"
                    % (directory, name))
                return None
            _streams[name] = j
        return j


def flush_all(timeout: float = 5.0) -> None:
    with _streams_lock:
        streams = list(_streams.values())
    for j in streams:
        j.flush(timeout=timeout)


def reset() -> None:
    """Close every shared stream (tests)."""
    with _streams_lock:
        streams = list(_streams.values())
        _streams.clear()
    for j in streams:
        j.close()
