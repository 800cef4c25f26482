"""Pluggable control-plane KV storage.

Counterpart of the reference's GCS StoreClient layer (SURVEY.md §2.1 N6:
store_client.h iface, InMemoryStoreClient, RedisStoreClient — the thing
that lets a restarted GCS recover cluster metadata). Two backends:

  - InMemoryStoreClient: a dict (the default, as in the reference).
  - FileBackedStoreClient: dict + append-only journal on disk; a new
    instance pointed at the same path replays the journal, so the
    cluster KV (runtime-env packages, named functions, user KV, job
    records) survives a head restart. Journal compaction happens on
    open when the log has accumulated enough dead weight.

Both expose MutableMapping, so the control server's dict-style usage
(`self.kv[k] = v`, `.get`, `del`, iteration) works unchanged.
"""

from __future__ import annotations

import os
import pickle
import struct
from collections.abc import MutableMapping
from typing import Any, Dict, Iterator

_LEN = struct.Struct("<I")
# Journal record: (key, value) = put; (key, None-sentinel) = delete.
_DELETE = ("__store_client_delete__",)


class InMemoryStoreClient(MutableMapping):
    def __init__(self):
        self._d: Dict[str, Any] = {}

    def __getitem__(self, k):
        return self._d[k]

    def __setitem__(self, k, v):
        self._d[k] = v

    def __delitem__(self, k):
        del self._d[k]

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def close(self):
        pass


class FileBackedStoreClient(MutableMapping):
    """Append-only journal + in-memory view (the Redis role, fileless)."""

    # Compact when the journal holds this many times more records than
    # live keys (dead puts/deletes dominate).
    _COMPACT_RATIO = 4

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._d: Dict[str, Any] = {}
        self._records = 0
        self._replay()
        if self._records > max(16, len(self._d) * self._COMPACT_RATIO):
            self._compact()
        self._f = open(path, "ab")

    def _replay(self):
        if not os.path.exists(self.path):
            return
        valid_end = 0
        with open(self.path, "rb") as f:
            while True:
                header = f.read(_LEN.size)
                if len(header) < _LEN.size:
                    break
                (n,) = _LEN.unpack(header)
                blob = f.read(n)
                if len(blob) < n:
                    break  # torn tail write (crash mid-append)
                try:
                    key, value = pickle.loads(blob)
                except Exception:
                    break
                valid_end = f.tell()
                # Type-check before comparing: arbitrary values (numpy
                # arrays) don't support bool(==); and only the exact
                # sentinel tuple is a delete.
                if isinstance(value, tuple) and value == _DELETE:
                    self._d.pop(key, None)
                else:
                    self._d[key] = value
                self._records += 1
        # Truncate any torn tail: appending AFTER garbage would make
        # every post-crash record unreachable on the next replay.
        if os.path.getsize(self.path) > valid_end:
            with open(self.path, "r+b") as f:
                f.truncate(valid_end)

    def _append(self, key: str, value: Any):
        blob = pickle.dumps((key, value), protocol=5)
        try:
            self._f.write(_LEN.pack(len(blob)) + blob)
            self._f.flush()
        except ValueError:
            return  # closed during shutdown; in-memory view stays right
        self._records += 1
        # Inline compaction: overwrite-heavy keys (metrics snapshots)
        # would otherwise grow the journal without bound until restart.
        if self._records > max(64, len(self._d) * self._COMPACT_RATIO):
            self._f.close()
            self._compact()
            self._f = open(self.path, "ab")

    def _compact(self):
        tmp = self.path + ".compact"
        with open(tmp, "wb") as f:
            for k, v in self._d.items():
                blob = pickle.dumps((k, v), protocol=5)
                f.write(_LEN.pack(len(blob)) + blob)
        os.replace(tmp, self.path)
        self._records = len(self._d)

    # -- MutableMapping ----------------------------------------------------
    def __getitem__(self, k):
        return self._d[k]

    def __setitem__(self, k, v):
        if isinstance(v, tuple) and v == _DELETE:
            raise ValueError(
                "value collides with the journal's delete sentinel")
        self._d[k] = v
        self._append(k, v)

    def __delitem__(self, k):
        del self._d[k]
        self._append(k, _DELETE)

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def close(self):
        try:
            self._f.close()
        except Exception:
            pass


def make_store_client(path: str = ""):
    """'' → in-memory (default); a path → file-backed journal."""
    return FileBackedStoreClient(path) if path else InMemoryStoreClient()


def peek_journal_key(path: str, key: str):
    """Read one key from a journal without keeping it open (used by a
    restarting head to adopt the previous session id before the control
    server re-opens the store)."""
    if not path or not os.path.exists(path):
        return None
    store = FileBackedStoreClient(path)
    try:
        return store.get(key)
    finally:
        store.close()
