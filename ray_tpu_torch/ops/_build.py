"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library
`_build/lib<name>.so` (a plain C interface, no PyTorch headers, so a build
takes seconds) and loads with ctypes.  Builds happen at first use, never
at import: the package imports on a host with no nvcc and no GPU.
`build()` compiles several sources at once, one nvcc process each, and
returns the compiler's register and shared-memory report (-Xptxas -v).
A library is rebuilt when its source or any shared header `csrc/*.cuh`
is newer than it.

A `Kernel` is one C entry point of one source: calling `launch()` builds
and loads the library if needed, calls the entry point, raises on a
non-zero cudaError_t, and counts the launch in `Kernel.launches`.  A call
made while the stream is capturing a CUDA graph launches nothing: it is
not counted but logged, and the graph adds the launches of its capture
at each replay (`take_captured`, models/decode_graph.py).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable, Optional, Sequence

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_captured: list = []

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(*tensors: torch.Tensor) -> int:
    """The kernels' dtype argument (0 = float32, 1 = bfloat16) for
    tensors that must share one of those dtypes."""
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise TypeError("the CUDA kernels take float32 or bfloat16 tensors "
                        f"of one dtype, got {[t.dtype for t in tensors]}")
    return _DTYPE_CODES[dtype]


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def sources() -> list:
    """Names of every kernel source in csrc/."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def headers() -> list:
    """Paths of the shared headers in csrc/ (any source may include
    them)."""
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cuh"))


def _stale(name: str) -> bool:
    """True if lib<name>.so is missing or older than its source or than
    any csrc/*.cuh header."""
    lib = library_path(name)
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return any(os.path.getmtime(p) > built
               for p in [source_path(name), *headers()])


def build(names: Optional[Iterable[str]] = None, force: bool = False
          ) -> Dict[str, dict]:
    """Compile the named sources (default: all) in parallel, one nvcc
    each.  Returns {name: {"seconds": wall time, "log": ptxas report}}
    for the sources it compiled; raises with nvcc's output on failure.
    Each library is written under a temporary name and renamed into
    place, so a reader never loads a half-written file."""
    names = list(sources() if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, library_path(name))
        report[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing or
    older than its source or a csrc/*.cuh header."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


class Kernel:
    """One C entry point of one kernel source, with its launch count.

    `argtypes` are the ctypes types of the entry point's arguments,
    without the trailing stream, which launch() appends (PyTorch's current
    stream of `device`).  Every entry point returns a cudaError_t."""

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence[type]):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._entry()(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.source}.cu {self.symbol} failed to launch: CUDA "
                f"error {err}")
        if torch.cuda.is_current_stream_capturing():
            _captured.append(self)
        else:
            self.launches += 1


def take_captured() -> list:
    """The kernels called under stream capture since the last call, one
    entry per call, and clear the log."""
    taken = _captured[:]
    _captured.clear()
    return taken
