"""External storage for spilled objects.

Counterpart of the reference's python/ray/_private/external_storage.py
(ExternalStorage ABC :72, FileSystemStorage :246, smart_open/S3 :451) —
the sink the raylet's LocalObjectManager spills cold primary copies to
(src/ray/raylet/local_object_manager.h:105). Here the control server
spills directly (core/gcs.py _maybe_spill) since it owns the store.

URIs are `spill:<backend>:<key>`; backends implement raw put/get/delete
of bytes.
"""

from __future__ import annotations

import os
from typing import Optional


class ExternalStorage:
    name = "external"

    def spill(self, key: str, data: bytes) -> str:
        """Persist bytes; returns a restore URI."""
        raise NotImplementedError

    def restore(self, uri: str) -> bytes:
        raise NotImplementedError

    def delete(self, uri: str) -> None:
        raise NotImplementedError


class FileSystemStorage(ExternalStorage):
    """Spill to a local directory (reference FileSystemStorage)."""

    name = "filesystem"

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, key)

    def spill(self, key: str, data: bytes) -> str:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.rename(tmp, self._path(key))  # atomic publish
        return f"spill:filesystem:{key}"

    def restore(self, uri: str) -> bytes:
        key = uri.rsplit(":", 1)[1]
        with open(self._path(key), "rb") as f:
            return f.read()

    def delete(self, uri: str) -> None:
        key = uri.rsplit(":", 1)[1]
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass


class SmartOpenStorage(ExternalStorage):
    """Remote-URI spilling via smart_open (reference :451 — S3/GS/...).
    Gated: raises a clear error if smart_open isn't baked into the
    image."""

    name = "smart_open"

    def __init__(self, uri_prefix: str):
        try:
            import smart_open  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "smart_open is not available in this image; use "
                "FileSystemStorage or bake smart_open in") from e
        self.uri_prefix = uri_prefix.rstrip("/")

    def spill(self, key: str, data: bytes) -> str:
        from smart_open import open as s_open

        uri = f"{self.uri_prefix}/{key}"
        with s_open(uri, "wb") as f:
            f.write(data)
        return f"spill:smart_open:{uri}"

    def restore(self, uri: str) -> bytes:
        from smart_open import open as s_open

        with s_open(uri.split(":", 2)[2], "rb") as f:
            return f.read()

    def delete(self, uri: str) -> None:
        pass  # remote GC is offline (reference leaves this to lifecycle)


def storage_from_spec(spec: Optional[str], session_dir: str
                      ) -> ExternalStorage:
    """spec: None/'' → session-local dir; a path → that dir; an
    s3://... prefix → smart_open."""
    if not spec:
        return FileSystemStorage(os.path.join(session_dir, "spilled"))
    if "://" in spec:
        return SmartOpenStorage(spec)
    return FileSystemStorage(spec)
