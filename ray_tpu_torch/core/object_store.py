"""Shared-memory object store (plasma counterpart) + in-process memory store.

Reference counterparts:
  - plasma store embedded in the raylet (src/ray/object_manager/plasma/):
    here a directory of mmap-able segment files under /dev/shm, one per
    object, creatable by any worker process on the node and attachable
    zero-copy by any other.
  - CoreWorkerMemoryStore
    (src/ray/core_worker/store_provider/memory_store/memory_store.h): the
    in-process table of small/inline objects and pending futures.

Segments are page-aligned flat buffers, so a deserialized numpy array
aliases shm, and a CUDA tensor is copied from the device straight into its
segment and back (core/serialization.py).  The port's segment files and
arena take their own prefix (config.ARENA_PREFIX), never the JAX
package's `raytpu-<session>`.

Departure from the reference (ray_tpu/core/object_store.py `cleanup`):
there only a clean `shutdown()` removes a session's files, so a head or
node manager killed by SIGKILL, the OOM killer or a timeout leaves its
arena in /dev/shm for good.  Here the process that owns a store (a head
or a node manager: `owner=True`) records its pid under
`<tmpdir>/ray_tpu_torch/arena_owners/<key>.json` before it creates the
arena, and reclaims first the files of every recorded key whose owner is
gone (`reclaim_dead_arenas`).  Files of a live owner, files without a
record, and every file of the JAX package are left alone.
"""

from __future__ import annotations

import mmap
import os
import shutil
import threading
from concurrent.futures import Future
from typing import Any, Dict, Optional

from ray_tpu_torch.core.config import ARENA_PREFIX, tmp_root
from ray_tpu_torch.core.ids import ObjectID


def _owners_dir() -> str:
    return os.path.join(tmp_root(), "arena_owners")


def _start_time(pid: int) -> Optional[str]:
    """The process's start time in clock ticks since boot (field 22 of
    /proc/<pid>/stat), which tells a reused pid apart; None off Linux."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[19]
    except (OSError, IndexError):
        return None


def _alive(pid: int, start: Optional[str]) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass  # exists, owned by another user
    return start is None or _start_time(pid) in (None, start)


def record_arena_owner(key: str, shm_dir: str) -> str:
    """Record this process as the owner of store `key`'s files in
    `shm_dir`; returns the record's path."""
    import json

    os.makedirs(_owners_dir(), exist_ok=True)
    path = os.path.join(_owners_dir(), f"{key}.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "start": _start_time(os.getpid()),
                   "shm_dir": shm_dir}, f)
    os.replace(tmp, path)
    return path


def reclaim_dead_arenas(keep: str = "") -> Dict[str, int]:
    """Remove the `<ARENA_PREFIX>-<key>-*` files of every recorded store
    whose owner process is gone, and its record; `keep` names a key to
    leave alone (a restarted head re-attaching its journaled session).
    Returns {key: files removed}."""
    import json

    removed: Dict[str, int] = {}
    try:
        names = os.listdir(_owners_dir())
    except OSError:
        return removed
    for name in names:
        if not name.endswith(".json"):
            continue
        key = name[:-len(".json")]
        path = os.path.join(_owners_dir(), name)
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue  # being written, or not ours to judge
        if key == keep or _alive(int(rec["pid"]), rec.get("start")):
            continue
        shm_dir, prefix, n = rec.get("shm_dir", "/dev/shm"), \
            f"{ARENA_PREFIX}-{key}-", 0
        try:
            for f_name in os.listdir(shm_dir):
                if f_name.startswith(prefix):
                    try:
                        os.unlink(os.path.join(shm_dir, f_name))
                        n += 1
                    except OSError:
                        pass
        except OSError:
            pass
        try:
            os.unlink(path)
        except OSError:
            pass
        removed[key] = n
    return removed


def _default_capacity(shm_dir: str) -> int:
    """Arena size when unset: most of shm, sparse so it commits lazily."""
    try:
        free = shutil.disk_usage(shm_dir).free
    except OSError:
        free = 1 << 30
    return max(64 << 20, min(int(free * 0.8), 8 << 30))


class NativeSegment:
    """View over one object's payload inside the native arena."""

    __slots__ = ("name", "size", "_view", "writable")

    def __init__(self, name: str, size: int, view, writable: bool):
        self.name = name
        self.size = size
        self._view = view
        self.writable = writable

    @property
    def buf(self):
        return self._view

    def close(self):
        try:
            self._view.release()
        except (BufferError, AttributeError):
            pass


class ShmSegment:
    """One mmap'ed object segment; read or write view over a /dev/shm file."""

    __slots__ = ("name", "path", "size", "_mm", "_file", "writable")

    def __init__(self, name: str, path: str, size: int, mm, file, writable: bool):
        self.name = name
        self.path = path
        self.size = size
        self._mm = mm
        self._file = file
        self.writable = writable

    @property
    def buf(self) -> memoryview:
        return memoryview(self._mm)

    def close(self):
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass  # exported views still alive; mmap closes on GC
        try:
            self._file.close()
        except Exception:
            pass


class ShmObjectStore:
    """Node-local store of shared-memory segments, one file per object.

    The store itself is just a naming convention: segment files live at
    ``{shm_dir}/{prefix}-{object_hex}``; creation happens in whichever
    process produced the value, attachment in whichever consumes it.  The
    object *directory* (who has what, sizes, inline values) lives in the
    control store — this class only manages local segments.
    """

    def __init__(self, session_id: str, shm_dir: str = "/dev/shm",
                 capacity: int = 0, owner: bool = False):
        self.session_id = session_id
        self.shm_dir = shm_dir
        self._prefix = f"{ARENA_PREFIX}-{session_id}"
        # The head's and node managers' stores own their files (module
        # docstring); workers only attach.
        self._owner_record = None
        if owner:
            reclaim_dead_arenas(keep=session_id)
            self._owner_record = record_arena_owner(session_id, shm_dir)
        self._lock = threading.Lock()
        self._open: Dict[str, object] = {}
        self._arena = None
        if os.environ.get("RAY_TPU_NATIVE_STORE", "1") != "0":
            try:
                from ray_tpu_torch.native.store import NativeArena

                self._arena = NativeArena(
                    os.path.join(shm_dir, f"{self._prefix}-arena"),
                    capacity or _default_capacity(shm_dir), create=True)
            except Exception as e:
                # g++ missing etc. — fall back to file-per-object segments.
                # Loud, because a *partial* fallback (only some processes)
                # would split object visibility across the node.
                import logging

                logging.getLogger("ray_tpu_torch").warning(
                    "native shm arena unavailable (%s); using "
                    "file-per-object store", e)
                self._arena = None

    @property
    def native(self) -> bool:
        return self._arena is not None

    def _path(self, object_id: ObjectID) -> str:
        return os.path.join(self.shm_dir, f"{self._prefix}-{object_id.hex()}")

    def create(self, object_id: ObjectID, size: int) -> ShmSegment:
        with self._lock:
            if self._arena is not None:
                from ray_tpu_torch.native.store import (
                    ArenaFullError,
                    ObjectExistsError,
                )

                oid = object_id.binary()
                try:
                    try:
                        view = self._arena.create(oid, size)
                    except ObjectExistsError:
                        # task retry re-storing the same return id: replace
                        # (pinned old copies are orphaned by the C side)
                        self._arena.delete(oid)
                        view = self._arena.create(oid, size)
                    seg = NativeSegment(
                        object_id.hex(), size, view, writable=True)
                    self._open[object_id.hex()] = seg
                    return seg
                except ArenaFullError:
                    pass  # overflow: spill to a file-per-object segment
        path = self._path(object_id)
        fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, max(size, 1))
            f = os.fdopen(fd, "r+b")
        except Exception:
            os.close(fd)
            os.unlink(path)
            raise
        mm = mmap.mmap(f.fileno(), max(size, 1))
        seg = ShmSegment(object_id.hex(), path, size, mm, f, writable=True)
        with self._lock:
            self._open[object_id.hex()] = seg
        return seg

    def seal(self, object_id: ObjectID):
        """Publish a written object (native arena; no-op for file-backed)."""
        with self._lock:
            if self._arena is not None:
                import errno

                from ray_tpu_torch.native.store import ArenaError

                try:
                    self._arena.seal(object_id.binary())
                except ArenaError as e:
                    # ENOENT: an overflow object living in a file segment
                    if e.err != errno.ENOENT:
                        raise
                else:
                    # seal() drops the creator's arena pin, so the
                    # writable view cached by create() may alias a block
                    # that can now be deleted/reused (e.g. by spilling).
                    # Evict it; a later read re-attaches with a proper
                    # reader pin and a fresh view.
                    seg = self._open.pop(object_id.hex(), None)
                    if seg is not None:
                        seg.close()

    def attach(self, object_id: ObjectID, size: int) -> ShmSegment:
        key = object_id.hex()
        with self._lock:
            # cache check and pin happen under one lock hold so two racing
            # threads can't both pin (the loser's pin would never be
            # released)
            seg = self._open.get(key)
            if seg is not None:
                return seg
            if self._arena is not None:
                import errno

                from ray_tpu_torch.native.store import ArenaError

                try:
                    view = self._arena.get(object_id.binary())
                except ArenaError as e:
                    if e.err != errno.EBUSY:
                        raise
                    # Pin-slot table full (many live reader processes):
                    # degrade to a copied read — correct, just not zero-copy.
                    data = self._arena.read_copy(object_id.binary())
                    view = memoryview(bytearray(data)) if data is not None \
                        else None
                    if view is not None:
                        seg = NativeSegment(key, len(view), view,
                                            writable=False)
                        self._open.setdefault(key, seg)
                        return seg
                if view is not None:
                    # The pin taken by get() is held for this process's
                    # lifetime: deserialized arrays may alias the buffer
                    # (pickle5 zero copy), mirroring how the file-backed
                    # path keeps the mmap open.
                    seg = NativeSegment(key, len(view), view, writable=False)
                    self._open.setdefault(key, seg)
                    return seg
                # else: overflow object — fall through to the file path
        path = self._path(object_id)
        f = open(path, "rb")
        mm = mmap.mmap(f.fileno(), max(size, 1), prot=mmap.PROT_READ)
        seg = ShmSegment(key, path, size, mm, f, writable=False)
        with self._lock:
            self._open.setdefault(key, seg)
        return seg

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            if self._arena is not None and \
                    self._arena.contains(object_id.binary()):
                return True
        return os.path.exists(self._path(object_id))

    def release(self, object_id: ObjectID):
        """Close the local mapping (does not delete the object)."""
        with self._lock:
            seg = self._open.pop(object_id.hex(), None)
            if seg is not None:
                seg.close()
                if self._arena is not None and not seg.writable:
                    self._arena.release(object_id.binary())

    def delete(self, object_id: ObjectID):
        with self._lock:
            seg = self._open.pop(object_id.hex(), None)
            if seg is not None:
                seg.close()
            if self._arena is not None:
                self._arena.delete(object_id.binary())
        try:
            os.unlink(self._path(object_id))
        except FileNotFoundError:
            pass

    def sweep(self, alive_pids) -> int:
        """Drop pins held by dead processes (node-daemon duty; native only)."""
        with self._lock:
            if self._arena is not None:
                return self._arena.sweep(list(alive_pids))
        return 0

    def stats(self):
        """(capacity, used, num_objects, evicted_bytes) — native arena only."""
        with self._lock:
            if self._arena is not None:
                return self._arena.stats()
        return (0, 0, 0, 0)

    def cleanup(self):
        with self._lock:
            segs = list(self._open.values())
            self._open.clear()
            arena, self._arena = self._arena, None
        for seg in segs:
            seg.close()
        if arena is not None:
            try:
                arena.close()
            except Exception:
                pass
        # best-effort sweep of this session's files
        try:
            for name in os.listdir(self.shm_dir):
                if name.startswith(self._prefix):
                    try:
                        os.unlink(os.path.join(self.shm_dir, name))
                    except OSError:
                        pass
        except OSError:
            pass
        if self._owner_record is not None:
            try:
                os.unlink(self._owner_record)
            except OSError:
                pass
            self._owner_record = None


class InProcessStore:
    """Per-process table of resolved values and pending futures."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: Dict[ObjectID, Any] = {}
        self._futures: Dict[ObjectID, list] = {}

    def put(self, object_id: ObjectID, value: Any):
        with self._lock:
            self._values[object_id] = value
            waiters = self._futures.pop(object_id, [])
        for fut in waiters:
            if not fut.done():
                fut.set_result(value)

    def get_future(self, object_id: ObjectID) -> Future:
        fut: Future = Future()
        with self._lock:
            if object_id in self._values:
                fut.set_result(self._values[object_id])
                return fut
            self._futures.setdefault(object_id, []).append(fut)
        return fut

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._values

    def peek(self, object_id: ObjectID):
        with self._lock:
            return self._values.get(object_id)

    def pop(self, object_id: ObjectID):
        with self._lock:
            self._values.pop(object_id, None)
            self._futures.pop(object_id, None)

    def fail(self, object_id: ObjectID, exc: BaseException):
        with self._lock:
            self._values[object_id] = exc
            waiters = self._futures.pop(object_id, [])
        for fut in waiters:
            if not fut.done():
                fut.set_result(exc)
