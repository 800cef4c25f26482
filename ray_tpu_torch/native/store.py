"""ctypes binding for the native shared-memory object arena (libtpustore).

The C++ side (store.cc beside this module, the port's copy of the JAX
package's src/store/tpustore.cc) owns all metadata — object table,
free-list allocator, LRU list, per-pid pin counts — inside one shm arena
file. This wrapper adds the Python-visible data path: the same file is
mmap'ed here, and object payloads are exposed as zero-copy memoryview
slices at the offsets the C side hands back.

Reference counterpart: the plasma client
(src/ray/object_manager/plasma/client.cc) — Create/Seal/Get/Release/
Delete/Evict — minus the socket protocol (no store server process).
"""

from __future__ import annotations

import ctypes
import mmap
import os
from typing import Optional, Tuple

from ray_tpu_torch.native.build import NativeBuildError, build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "store.cc")

_lib = None


def library_path() -> str:
    """Filesystem path of the built store library (native C++ clients
    dlopen it to attach the arena)."""
    return build_library("tpustore", source=_SRC)


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    path = build_library("tpustore", source=_SRC)
    lib = ctypes.CDLL(path, use_errno=True)
    lib.tps_open.restype = ctypes.c_void_p
    lib.tps_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
    lib.tps_close.argtypes = [ctypes.c_void_p]
    lib.tps_capacity.restype = ctypes.c_uint64
    lib.tps_capacity.argtypes = [ctypes.c_void_p]
    lib.tps_create.restype = ctypes.c_int
    lib.tps_create.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
    lib.tps_seal.restype = ctypes.c_int
    lib.tps_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tps_get.restype = ctypes.c_int
    lib.tps_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    lib.tps_read.restype = ctypes.c_int64
    lib.tps_read.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.tps_contains.restype = ctypes.c_int
    lib.tps_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tps_release.restype = ctypes.c_int
    lib.tps_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tps_delete.restype = ctypes.c_int
    lib.tps_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tps_evict.restype = ctypes.c_uint64
    lib.tps_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tps_sweep.restype = ctypes.c_int
    lib.tps_sweep.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.tps_stats.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_uint64)] * 4
    _lib = lib
    return lib


class ArenaError(RuntimeError):
    def __init__(self, op: str, err: int):
        self.err = err
        super().__init__(f"tpustore {op} failed: errno {err} "
                         f"({os.strerror(err)})")


class ObjectExistsError(ArenaError):
    pass


class ArenaFullError(ArenaError):
    pass


def _check(op: str, rc: int):
    if rc == 0:
        return
    err = -rc
    import errno as _errno
    if err == _errno.EEXIST:
        raise ObjectExistsError(op, err)
    if err in (_errno.ENOMEM, _errno.ENOSPC):
        raise ArenaFullError(op, err)
    raise ArenaError(op, err)


_ID_LEN = 20  # kIdLen in tpustore.cc


def _pad_id(oid: bytes) -> bytes:
    if len(oid) > _ID_LEN:
        raise ValueError(f"object id longer than {_ID_LEN} bytes")
    return oid.ljust(_ID_LEN, b"\0")


class NativeArena:
    """One process's view of the node arena: C metadata ops + mmap'ed data."""

    def __init__(self, path: str, capacity: int, create: bool):
        self._lib = load_library()
        self.path = path
        self._handle = self._lib.tps_open(
            path.encode(), ctypes.c_uint64(capacity), 1 if create else 0)
        if not self._handle:
            raise ArenaError("open", ctypes.get_errno() or 1)
        self.capacity = self._lib.tps_capacity(self._handle)
        f = open(path, "r+b")
        try:
            self._mm = mmap.mmap(f.fileno(), self.capacity)
        finally:
            f.close()

    def _h(self):
        if not self._handle:
            import errno
            raise ArenaError("use-after-close", errno.EBADF)
        return self._handle

    # -- object lifecycle ------------------------------------------------
    def create(self, oid: bytes, size: int, evict_ok: bool = False) -> memoryview:
        oid = _pad_id(oid)
        off = ctypes.c_uint64()
        rc = self._lib.tps_create(
            self._h(), oid, ctypes.c_uint64(size), ctypes.byref(off),
            1 if evict_ok else 0)
        _check("create", rc)
        return memoryview(self._mm)[off.value:off.value + size]

    def seal(self, oid: bytes):
        oid = _pad_id(oid)
        _check("seal", self._lib.tps_seal(self._h(), oid))

    def get(self, oid: bytes) -> Optional[memoryview]:
        """Pin and return a zero-copy read view, or None if absent."""
        oid = _pad_id(oid)
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.tps_get(
            self._h(), oid, ctypes.byref(off), ctypes.byref(size))
        if rc == -2:  # -ENOENT
            return None
        _check("get", rc)
        return memoryview(self._mm)[off.value:off.value + size.value]

    def read_copy(self, oid: bytes) -> Optional[bytes]:
        """Copy a sealed object's payload out without pinning it (fallback
        when the entry's pin-slot table is full)."""
        import errno as _errno

        oid = _pad_id(oid)
        cap = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.tps_read(self._h(), oid, buf, ctypes.c_uint64(cap))
            if n == -_errno.ENOENT:
                return None
            if n == -_errno.ERANGE:  # buffer too small: grow and retry
                cap *= 8
                continue
            if n < 0:
                _check("read", int(n))
            return buf.raw[:n]

    def contains(self, oid: bytes) -> bool:
        return bool(self._lib.tps_contains(self._h(), _pad_id(oid)))

    def release(self, oid: bytes):
        self._lib.tps_release(self._h(), _pad_id(oid))

    def delete(self, oid: bytes):
        self._lib.tps_delete(self._h(), _pad_id(oid))

    def evict(self, nbytes: int) -> int:
        return self._lib.tps_evict(self._h(), ctypes.c_uint64(nbytes))

    def sweep(self, alive_pids) -> int:
        arr = (ctypes.c_int32 * len(alive_pids))(*alive_pids)
        return self._lib.tps_sweep(self._h(), arr, len(alive_pids))

    def stats(self) -> Tuple[int, int, int, int]:
        cap = ctypes.c_uint64()
        used = ctypes.c_uint64()
        nobj = ctypes.c_uint64()
        evb = ctypes.c_uint64()
        self._lib.tps_stats(self._h(), ctypes.byref(cap),
                            ctypes.byref(used), ctypes.byref(nobj),
                            ctypes.byref(evb))
        return cap.value, used.value, nobj.value, evb.value

    def close(self):
        if self._handle:
            try:
                self._mm.close()
            except (BufferError, ValueError):
                pass
            self._lib.tps_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = [
    "NativeArena", "ArenaError", "ArenaFullError", "ObjectExistsError",
    "NativeBuildError", "load_library",
]
