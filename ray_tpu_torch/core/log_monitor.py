"""Log monitor: stream worker stdout/stderr to the driver.

Counterpart of the reference's per-node log monitor
(python/ray/_private/log_monitor.py: tails session/logs files, publishes
via GCS pubsub; drivers print with a `(pid=...)` prefix). Single-host
simplification: the driver tails the session log directory directly — no
pubsub hop — with the same worker-attribution prefix. Enabled by
`init(log_to_driver=True)` (the reference's default behavior).
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from typing import Dict, TextIO

_POLL_INTERVAL_S = 0.25
_WORKER_FILE = re.compile(r"worker-(?P<hex>[0-9a-f]+)\.(?P<stream>out|err)$")


class LogMonitor:
    """Tails `<session_dir>/logs/worker-*.{out,err}` and forwards new
    lines to the driver's stdout/stderr with a worker prefix."""

    def __init__(self, session_dir: str, out: TextIO = None,
                 err: TextIO = None):
        self.log_dir = os.path.join(session_dir, "logs")
        self.out = out or sys.stdout
        self.err = err or sys.stderr
        self._offsets: Dict[str, int] = {}
        self._stop = threading.Event()
        # Serializes sweeps: stop()'s final flush can run concurrently
        # with the monitor thread's sweep.
        self._sweep_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="log-monitor")

    def start(self) -> "LogMonitor":
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        # One final sweep so output produced right before shutdown lands.
        self._sweep()

    def _loop(self):
        while not self._stop.is_set():
            self._sweep()
            self._stop.wait(_POLL_INTERVAL_S)

    def _sweep(self):
        with self._sweep_lock:
            self._sweep_locked()

    def _sweep_locked(self):
        try:
            names = os.listdir(self.log_dir)
        except OSError:
            return
        for name in sorted(names):
            m = _WORKER_FILE.search(name)
            if not m:
                continue
            path = os.path.join(self.log_dir, name)
            offset = self._offsets.get(path, 0)
            # Binary IO with byte offsets: text-mode seek/read would count
            # characters and drift on multi-byte UTF-8.
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read()
            except OSError:
                continue
            if not chunk:
                continue
            # Emit only complete lines: a chunk can end mid-line (or even
            # mid-UTF-8-sequence); holding the tail until its newline
            # arrives keeps characters and lines intact across sweeps.
            nl = chunk.rfind(b"\n")
            if nl < 0:
                if len(chunk) < 65536:
                    continue  # wait for the newline
                nl = len(chunk) - 1  # pathological no-newline flood: flush
            chunk = chunk[:nl + 1]
            self._offsets[path] = offset + len(chunk)
            stream = self.out if m.group("stream") == "out" else self.err
            prefix = f"({m.group('hex')[:8]}) "
            for line in chunk.decode(errors="replace").splitlines():
                if line.strip():
                    print(prefix + line, file=stream)
