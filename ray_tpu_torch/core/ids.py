"""Typed identifiers for tasks, actors, objects, nodes and workers.

Capability counterpart of the reference's typed-ID layer
(src/ray/common/id.h): fixed-width random binary IDs with hex rendering,
hashable and order-stable so they can key tables in the control store and be
shipped over the wire cheaply.  TPU-native design note: IDs are plain bytes —
no embedded job/actor cursors — because ownership metadata lives in the
object directory rather than being bit-packed into the ID.
"""

from __future__ import annotations

import os
import threading

_ID_NBYTES = 14


# Unique-ID generation: one urandom seed per (process, thread), then a
# counter suffix — keeps from_random() syscall-free on the hot submission
# paths (two IDs per task) while preserving global uniqueness.
_rand_local = threading.local()


def _next_unique() -> bytes:
    st = _rand_local
    try:
        n = st.counter
    except AttributeError:
        st.suffix = os.urandom(_ID_NBYTES - 6)
        st.counter = n = int.from_bytes(os.urandom(6), "little")
    st.counter = (n + 1) & 0xFFFFFFFFFFFF
    # Counter bytes FIRST: consumers hash id prefixes (e.g. the SPREAD
    # tie-break), so the varying part must lead; the per-thread random
    # suffix carries the uniqueness across processes/threads.
    return n.to_bytes(6, "little") + st.suffix


class BaseID:
    __slots__ = ("_bytes", "_hex", "_hashv")
    _prefix = "id"

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != _ID_NBYTES:
            raise ValueError(
                f"{type(self).__name__} requires {_ID_NBYTES} bytes, got {binary!r}"
            )
        self._bytes = binary
        self._hex = None
        self._hashv = None

    @classmethod
    def nil(cls):
        return cls(b"\x00" * _ID_NBYTES)

    @classmethod
    def from_random(cls):
        return cls(_next_unique())

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        h = self._hex
        if h is None:
            h = self._hex = self._bytes.hex()
        return h

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * _ID_NBYTES

    def __hash__(self):
        # Cached: ids key hot dicts/sets (wait sets, arg prep) and the
        # tuple construction + double hash dominated profiles.
        h = self._hashv
        if h is None:
            h = self._hashv = hash((self._prefix, self._bytes))
        return h

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class TaskID(BaseID):
    _prefix = "task"


class ObjectID(BaseID):
    _prefix = "obj"


class ActorID(BaseID):
    _prefix = "actor"


class NodeID(BaseID):
    _prefix = "node"


class WorkerID(BaseID):
    _prefix = "worker"


class JobID(BaseID):
    _prefix = "job"


class PlacementGroupID(BaseID):
    _prefix = "pg"


class _SequenceGen:
    """Monotonic per-process sequence numbers (actor task ordering)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0

    def next(self) -> int:
        with self._lock:
            v = self._next
            self._next += 1
            return v
