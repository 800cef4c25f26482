"""Streaming generator tasks: results flow to the caller as they are
yielded.

Counterpart of the reference's streaming-generator returns
(src/ray/protobuf/core_worker.proto streaming-generator RPCs,
python/ray/_raylet.pyx :1324/:1367 — `num_returns="streaming"` yields an
ObjectRefGenerator). Design here leans on the owner-directory instead of
a dedicated RPC pair: item object ids are DERIVED deterministically from
the task id + index, so the caller can subscribe to item i before it
exists and the worker never round-trips to hand out ids; a derived
end-of-stream object carries the final item count.

    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i

    for ref in gen.remote(5):      # ObjectRefGenerator
        value = ray_tpu_torch.get(ref)
"""

from __future__ import annotations

import hashlib
from concurrent.futures import FIRST_COMPLETED, wait
from typing import Optional

from ray_tpu_torch.core.ids import ObjectID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef

STREAMING = "streaming"
_EOS_INDEX = -1


def stream_item_id(task_id: TaskID, index: int) -> ObjectID:
    """Deterministic object id for the index-th yielded item (the
    reference packs an index into the return id; we hash, since our ids
    carry no structure)."""
    digest = hashlib.sha1(
        task_id.binary() + index.to_bytes(8, "little", signed=True)
    ).digest()
    return ObjectID(digest[:14])


def stream_eos_id(task_id: TaskID) -> ObjectID:
    return stream_item_id(task_id, _EOS_INDEX)


class ObjectRefGenerator:
    """Iterator over a streaming task's item refs, in yield order.

    Each __next__ blocks until item i exists OR the stream is known to
    have ended before i (StopIteration). A failed generator stores the
    error into its final item slot, so iterating still surfaces it on
    get() — same contract as the reference.
    """

    def __init__(self, task_id: TaskID, runtime=None):
        self._task_id = task_id
        self._rt = runtime
        self._i = 0
        self._count: Optional[int] = None

    @property
    def task_id(self) -> TaskID:
        return self._task_id

    def _runtime(self):
        if self._rt is None:
            from ray_tpu_torch.core.runtime import get_runtime

            self._rt = get_runtime()
        return self._rt

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        if self._count is not None and self._i >= self._count:
            raise StopIteration
        core = self._runtime().core
        item_hex = stream_item_id(self._task_id, self._i).hex()
        if self._count is None:
            item_fut = core.object_future(item_hex)
            eos_fut = core.object_future(
                stream_eos_id(self._task_id).hex())
            while not item_fut.done():
                wait([item_fut, eos_fut], return_when=FIRST_COMPLETED)
                # Both may resolve in the same wake (a crashed worker's
                # error EOS lands right behind its last item): the item,
                # when present, wins — the EOS is only consulted for
                # indexes past the stream's end.
                if item_fut.done():
                    break
                if eos_fut.done():
                    # Stream ended; resolve the count exactly once. A
                    # failed task stores an ERROR eos, which raises here
                    # — retire the speculative item probe either way.
                    eos_hex = stream_eos_id(self._task_id).hex()
                    try:
                        self._count = core._load_object(
                            eos_hex, eos_fut.result())
                    except BaseException:
                        core.forget_object(item_hex)
                        raise
                    try:
                        core.client.send({"op": "decref", "obj": eos_hex})
                    except Exception:
                        pass
                    if self._i >= self._count:
                        # The probe subscribed item[count], which will
                        # never exist — retire the speculative entry so
                        # heavy stream consumers don't leak directory
                        # entries/futures.
                        core.forget_object(item_hex)
                        raise StopIteration
                    # Items are stored BEFORE eos, so item i exists: the
                    # ref is valid even if its push hasn't landed yet
                    # (get() waits on the same future). No more spinning.
                    break
        # else: count known and i < count — the item already exists.
        self._i += 1
        return ObjectRef(ObjectID.from_hex(item_hex))

    def disown(self):
        """The caller takes over server-side stream cleanup (serve's
        proxy consumes by task id and sends its own free_stream with
        accurate consumed/count state): suppress __del__'s own free so
        a stale duplicate never parks on the head."""
        self._disowned = True

    def __del__(self):
        # Free unconsumed items server-side (they were stored with one
        # owner ref that only __next__'s ObjectRefs would release).
        # If the stream is still RUNNING, the head parks this free and
        # applies it when the EOS object lands (gcs.py _op_free_stream /
        # _store_object_locked) — mid-stream drops clean up too.
        if getattr(self, "_disowned", False):
            return
        try:
            rt = self._rt
            if rt is None or not getattr(rt, "is_initialized", False):
                return
            rt.core.client.send({
                "op": "free_stream",
                "task": self._task_id.hex(),
                "from_index": self._i,
                "eos_consumed": self._count is not None,
                # When this consumer already read the EOS (and its
                # decref may have DELETED it head-side), the head can't
                # learn the item count from the EOS anymore — ship it.
                "count": self._count,
            })
        except Exception:
            pass

    def __reduce__(self):
        # Generators are owner-local handles (like the reference's);
        # pass the yielded refs to other tasks instead.
        raise TypeError(
            "ObjectRefGenerator cannot be serialized; iterate it and "
            "pass the ObjectRefs")
