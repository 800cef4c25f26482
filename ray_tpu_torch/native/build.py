"""On-demand build of the native (C++) libraries.

Compiles a C++ source of this package into ``ray_tpu_torch/native/_lib/lib<name>.so``
the first time it's needed and whenever the source changes (tracked by a
content hash stamp). Keeps the package runnable from a plain git checkout
with no separate build step, like the reference's bazel-built wheels but
without the wheel.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

_LIB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_lib")
_lock = threading.Lock()
_built: dict = {}


class NativeBuildError(RuntimeError):
    pass


def build_library(name: str, source: str) -> str:
    """Build (if stale) and return the path to ``lib<name>.so``.

    Raises NativeBuildError if no compiler is available or the build fails.
    """
    # Sanitizer build flavor (reference: bazel --config=asan/tsan,
    # .bazelrc:104-125): RAY_TPU_NATIVE_SANITIZE=address|thread builds a
    # separate lib<name>-<san>.so.  Loading an ASan .so into a vanilla
    # python requires LD_PRELOAD of libasan — scripts/asan_native_store.py
    # wires that up for the test suite.
    sanitize = os.environ.get("RAY_TPU_NATIVE_SANITIZE", "")
    with _lock:
        key = (name, sanitize)
        if key in _built:
            return _built[key]
        src = source
        if not os.path.exists(src):
            raise NativeBuildError(f"native source not found: {src}")
        os.makedirs(_LIB_DIR, exist_ok=True)
        suffix = f"-{sanitize}" if sanitize else ""
        out = os.path.join(_LIB_DIR, f"lib{name}{suffix}.so")
        stamp = out + ".stamp"
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if os.path.exists(out) and os.path.exists(stamp):
            with open(stamp) as f:
                if f.read().strip() == digest:
                    _built[key] = out
                    return out
        # Built under a name of this process's own and renamed into place:
        # several processes of a fresh checkout (xdist workers, a cluster's
        # workers) may build at once, and none may load a half-written
        # library.
        tmp_out = f"{out}.{os.getpid()}.tmp"
        cmd = [
            os.environ.get("CXX", "g++"), "-O2", "-g", "-std=c++17",
            "-fPIC", "-shared", "-Wall", "-o", tmp_out, src, "-lpthread",
        ]
        if sanitize:
            cmd.insert(1, f"-fsanitize={sanitize}")
            cmd.insert(1, "-fno-omit-frame-pointer")
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"compiler unavailable: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"build of {name} failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp_out, out)
        with open(f"{stamp}.{os.getpid()}.tmp", "w") as f:
            f.write(digest)
        os.replace(f"{stamp}.{os.getpid()}.tmp", stamp)
        _built[key] = out
        return out
