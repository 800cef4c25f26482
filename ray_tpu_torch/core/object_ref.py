"""ObjectRef: a first-class future handle to an object in the cluster.

Counterpart of the reference's ObjectRef (python/ray/_raylet.pyx ObjectRef +
src/ray/core_worker/reference_count.h).  Holds the object id plus owner hint;
pickling an ObjectRef routes through module-level hooks so the serializer can
record borrowed refs and the deserializer can re-register them with the
runtime (the borrowing protocol's Python edge).
"""

from __future__ import annotations

import threading
from typing import Any

from ray_tpu_torch.core.ids import ObjectID

_local = threading.local()


def _push_capture_list(lst):
    prev = getattr(_local, "capture", None)
    _local.capture = lst
    return prev


def _pop_capture_list(prev):
    _local.capture = prev


def _push_ref_resolver(fn):
    prev = getattr(_local, "resolver", None)
    _local.resolver = fn
    return prev


def _pop_ref_resolver(prev):
    _local.resolver = prev


def _reconstruct_ref(hex_id: str, owner: Any):
    resolver = getattr(_local, "resolver", None)
    ref = ObjectRef(ObjectID.from_hex(hex_id), owner=owner)
    if resolver is not None:
        resolver(ref)
    return ref


class ObjectRef:
    __slots__ = ("_id", "_owner", "_hex", "__weakref__")

    def __init__(self, object_id: ObjectID, owner=None):
        self._id = object_id
        self._owner = owner
        # Precomputed: hot paths (wait partition scans) read the
        # attribute directly instead of two method calls per ref.
        self._hex = object_id.hex()

    @property
    def id(self) -> ObjectID:
        return self._id

    @property
    def owner(self):
        return self._owner

    def hex(self) -> str:
        return self._hex

    def binary(self) -> bytes:
        return self._id.binary()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        capture = getattr(_local, "capture", None)
        if capture is not None:
            capture.append(self._id.hex())
        return (_reconstruct_ref, (self._id.hex(), self._owner))

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        from ray_tpu_torch.core.runtime import get_runtime

        return get_runtime().as_future(self)

    def __await__(self):
        import asyncio

        fut = self.future()
        return asyncio.wrap_future(fut).__await__()

    def __del__(self):
        try:
            from ray_tpu_torch.core.runtime import _global_runtime

            if _global_runtime is not None:
                _global_runtime.on_ref_deleted(self._id)
        except Exception:
            pass
