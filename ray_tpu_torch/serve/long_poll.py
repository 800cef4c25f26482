"""Long-poll host: versioned key/value broadcast from controller to routers.

Counterpart of python/ray/serve/_private/long_poll.py (LongPollHost :177 /
LongPollClient :64): listeners call `listen_for_change` with the versions
they already know; the call blocks until some key advances, then returns
only the changed entries.  Runs inside the controller actor, which has
max_concurrency high enough that blocked listens don't starve control ops.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple


class LongPollHost:
    def __init__(self):
        self._lock = threading.Condition()
        self._store: Dict[str, Tuple[int, Any]] = {}

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            version = self._store.get(key, (0, None))[0] + 1
            self._store[key] = (version, value)
            self._lock.notify_all()

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            entry = self._store.get(key)
            return None if entry is None else entry[1]

    def drop(self, key: str) -> None:
        with self._lock:
            if key in self._store:
                version = self._store[key][0] + 1
                self._store[key] = (version, None)
                self._lock.notify_all()

    def listen(self, known: Dict[str, int],
               timeout_s: float = 30.0) -> Dict[str, Tuple[int, Any]]:
        """Block until any watched key's version exceeds `known[key]`
        (0 = never seen), then return all changed {key: (version, value)}.
        Empty dict on timeout."""
        deadline_changed = {}
        with self._lock:
            end = None

            def changed():
                out = {}
                for key, ver in known.items():
                    entry = self._store.get(key)
                    if entry is not None and entry[0] > ver:
                        out[key] = entry
                return out

            import time

            end = time.monotonic() + timeout_s
            while True:
                deadline_changed = changed()
                if deadline_changed:
                    return deadline_changed
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return {}
                self._lock.wait(timeout=remaining)
