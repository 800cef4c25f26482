"""Device-plane telemetry on CUDA: backend probe, compile-event
accounting, HBM ledger, and continuous roofline/MFU attribution.

Port of ray_tpu/util/device_stats.py, rebuilt for PyTorch on an NVIDIA
GPU with the reference's public names, record shapes and metric names.
Everything here rides the observability modules beside it: metric
registry snapshots, the span ring and the durable ops journal ("device"
stream).

Design rules:
  - Never create a CUDA context on behalf of a process: a context costs
    hundreds of MB of card memory in every worker.  ``backend_info()``
    and ``memory_stats()`` report "unloaded" / None until the process
    has initialized CUDA itself (``torch.cuda.is_initialized()``), unless
    the caller forces a probe with ``probe=True``.
  - Sampling must never hurt the caller: every probe is wrapped and
    degrades to None / empty on any backend quirk.
  - No made-up peak: an unknown card has no row in `_PEAK_SPECS`, so
    its roofline fraction and MFU read 0.0 (with a warning) until
    RAY_TPU_DEVICE_HBM_GBPS / RAY_TPU_DEVICE_PEAK_TFLOPS name its rates.
  - Compile accounting: on the card the counterpart of an XLA
    recompile is a CUDA-graph capture, which models/decode_graph.py
    reports through ``note_compile``.  ``count_compiles`` wraps the eager
    decoding entry points and counts their first call per argument
    signature (the reference's fallback path); the signature reads only
    shapes, dtypes, container lengths and plain numbers, never a
    tensor's values (a ``repr`` of a CUDA tensor copies it to the host).
"""

import logging
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch.core.log_once import warn_once

logger = logging.getLogger(__name__)

_FALSY = ("0", "false", "no", "off", "")

_lock = threading.Lock()

# name -> {"count", "after_warmup", "total_wall_s", "last_wall_s",
#          "last_shapes", "first_ts", "last_ts"}
_compiles: Dict[str, Dict[str, Any]] = {}

# component -> absolute device bytes attributed by the owning
# subsystem (weights / kv_pages / ...).
_components: Dict[str, int] = {}

_watermark_bytes = 0
_watermark_fraction = 0.0
_last_step: Optional[Dict[str, Any]] = None

_metrics_cache: Optional[Tuple[Any, Any, Any, Any]] = None


def _env_flag(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).strip().lower() not in _FALSY


def _env_int(name: str, default: int, floor: int = 0) -> int:
    try:
        return max(floor, int(os.environ.get(name, str(default))))
    except ValueError:
        return default


def _env_float(name: str, default: float, floor: float = 0.0) -> float:
    try:
        return max(floor, float(os.environ.get(name, str(default))))
    except ValueError:
        return default


_enabled = _env_flag("RAY_TPU_DEVICE_STATS", "1")
_warmup = _env_int("RAY_TPU_DEVICE_RECOMPILE_WARMUP", 2, 0)


def set_enabled(on: bool) -> None:
    """Runtime switch for the compile hook + step accounting (A/B runs
    and tests flip this without re-importing)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Test hook: drop all per-process accumulated state."""
    global _watermark_bytes, _watermark_fraction, _last_step
    with _lock:
        _compiles.clear()
        _components.clear()
        _watermark_bytes = 0
        _watermark_fraction = 0.0
        _last_step = None


# ---------------------------------------------------------------------------
# backend probe

def backend_info(probe: bool = False) -> Dict[str, Any]:
    """{"backend", "device_kind", "num_devices"}.  backend is
    "unloaded" while this process has not initialized CUDA (unless
    probe=True, which may), "cuda" with torch's device name otherwise,
    and "cpu" on a probed host without a CUDA device."""
    if not (probe or torch.cuda.is_initialized()):
        return {"backend": "unloaded", "device_kind": "", "num_devices": 0}
    try:
        if not torch.cuda.is_available():
            return {"backend": "cpu", "device_kind": "cpu",
                    "num_devices": 1}
        return {"backend": "cuda",
                "device_kind": torch.cuda.get_device_name(0),
                "num_devices": torch.cuda.device_count()}
    except Exception:  # raylint: allow-swallow(a broken CUDA install reads as no backend, the documented fallback)
        return {"backend": "none", "device_kind": "", "num_devices": 0}


def has_accelerator() -> bool:
    return backend_info().get("backend") not in (
        "cpu", "none", "unloaded", "")


def memory_stats() -> Optional[Dict[str, Any]]:
    """Device 0's allocator counters under the reference's keys
    (bytes_in_use, peak_bytes_in_use, bytes_limit), or None while CUDA
    is not initialized here (never initializes it) or on any error."""
    if not torch.cuda.is_initialized():
        return None
    try:
        stats = torch.cuda.memory_stats(0)
        used = int(stats.get("allocated_bytes.all.current", 0))
        return {
            "bytes_in_use": used,
            "peak_bytes_in_use": int(
                stats.get("allocated_bytes.all.peak", used)),
            "bytes_limit": int(torch.cuda.get_device_properties(0)
                               .total_memory),
        }
    except Exception:  # raylint: allow-swallow(None is the documented fallback)
        return None


# Per-card peak specs: (HBM bytes/s, dense bf16 FLOP/s), from NVIDIA's
# data sheets without sparsity, keyed on torch.cuda.get_device_name()
# lowered with spaces removed; the longest key contained in the name
# wins, so "h100pcie" matches before "h100".  RAY_TPU_DEVICE_HBM_GBPS /
# RAY_TPU_DEVICE_PEAK_TFLOPS override both.  No default: an unknown
# card has no peak here, and its fractions read 0.0.
_PEAK_SPECS = {
    "h100": (3.35e12, 989e12),      # H100 SXM
    "h100pcie": (2.0e12, 756e12),
    "h200": (4.8e12, 989e12),
}


def peak_specs_for(device_kind: str) -> Optional[Tuple[float, float]]:
    """The `_PEAK_SPECS` row of a device name, or None."""
    kind = device_kind.lower().replace(" ", "")
    for key in sorted(_PEAK_SPECS, key=len, reverse=True):
        if key in kind:
            return _PEAK_SPECS[key]
    return None


def peak_specs() -> Tuple[float, float]:
    """(hbm_bytes_per_s, peak_flops_per_s) for the local card; 0.0 for
    a rate neither the environment nor the table gives."""
    hbm = _env_float("RAY_TPU_DEVICE_HBM_GBPS", 0.0) * 1e9
    tf = _env_float("RAY_TPU_DEVICE_PEAK_TFLOPS", 0.0) * 1e12
    if hbm and tf:
        return hbm, tf
    spec = peak_specs_for(backend_info().get("device_kind", "")) \
        or (0.0, 0.0)
    return (hbm or spec[0], tf or spec[1])


# ---------------------------------------------------------------------------
# metrics / journal (both lazy so importing this module stays free)


def _metrics():
    global _metrics_cache
    if _metrics_cache is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge
        _metrics_cache = (
            Counter("ray_tpu_recompiles_total",
                    "XLA compilations observed after per-function "
                    "warmup (recompile churn)", tag_keys=("function",)),
            Gauge("ray_tpu_device_roofline_fraction",
                  "Achieved / roofline HBM-bandwidth fraction of the "
                  "last sampled step window", tag_keys=("plane",)),
            Gauge("ray_tpu_device_mfu",
                  "Model FLOPs utilization of the last sampled step "
                  "window", tag_keys=("plane",)),
            Gauge("ray_tpu_device_hbm_watermark_fraction",
                  "Peak observed device-memory occupancy fraction "
                  "since process start"),
        )
    return _metrics_cache


def _journal(record: Dict[str, Any]) -> None:
    try:
        from ray_tpu_torch.util import journal
        js = journal.stream("device")
        if js is not None:
            js.append(record)
    except Exception as exc:
        warn_once(logger, "device-journal", exc,
                  "could not append to the device journal stream")


# ---------------------------------------------------------------------------
# compile-event hook


def _arg_shapes(args: tuple, kwargs: dict) -> list:
    out = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None:
            out.append([list(shape), str(getattr(a, "dtype", ""))])
        elif isinstance(a, (int, float, bool)):
            out.append(a)
        else:
            out.append(type(a).__name__)
    for k in sorted(kwargs):
        v = kwargs[k]
        shape = getattr(v, "shape", None)
        out.append([k, list(shape) if shape is not None
                    else type(v).__name__])
    return out


def _sig_item(a):
    """One argument's part of a call signature: shape and dtype of a
    tensor or array, the value of a plain number, the type and length of
    a container, the type of anything else.  Never formats a value, so
    a dict of CUDA tensors costs no device-to-host copy."""
    shape = getattr(a, "shape", None)
    if shape is not None:
        return tuple(shape), str(getattr(a, "dtype", ""))
    if isinstance(a, (bool, int, float)):
        return a
    if isinstance(a, (dict, list, tuple)):
        return type(a).__name__, len(a)
    return type(a).__name__


def note_compile(name: str, wall_s: float, shapes: list) -> None:
    """Record one observed compilation (on the card: one graph capture)
    of `name`.  Past the warmup allowance the recompile counter
    increments and the event lands in the durable "device" journal
    stream."""
    now = time.time()
    with _lock:
        ent = _compiles.setdefault(name, {
            "count": 0, "after_warmup": 0, "total_wall_s": 0.0,
            "last_wall_s": 0.0, "last_shapes": None,
            "first_ts": now, "last_ts": now,
        })
        ent["count"] += 1
        ent["total_wall_s"] += wall_s
        ent["last_wall_s"] = wall_s
        ent["last_shapes"] = shapes
        ent["last_ts"] = now
        post_warmup = ent["count"] > _warmup
        if post_warmup:
            ent["after_warmup"] += 1
        count, after_warmup = ent["count"], ent["after_warmup"]
    if post_warmup:
        try:
            _metrics()[0].inc(tags={"function": name})
        except Exception as exc:
            warn_once(logger, "device-metrics", exc,
                      "could not update device metrics")
    _journal({"kind": "compile", "ts": now, "function": name,
              "wall_s": round(wall_s, 4), "shapes": shapes,
              "count": count, "after_warmup": after_warmup})


class _CompileTracked:
    """Wrapper around an eager entry point that counts its first call
    per argument signature as a compilation (the reference's fallback
    for callables without a tracing cache).  Attribute access forwards
    to the wrapped function; ``__wrapped__`` is the function itself."""

    def __init__(self, fn, name: str):
        self._fn = fn
        self._name = name
        self._seen_sigs: set = set()
        self.__wrapped__ = fn

    def __call__(self, *args, **kwargs):
        if not _enabled:
            return self._fn(*args, **kwargs)
        sig = (tuple(_sig_item(a) for a in args),
               tuple((k, _sig_item(kwargs[k])) for k in sorted(kwargs)))
        miss = sig not in self._seen_sigs
        self._seen_sigs.add(sig)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        if miss:
            note_compile(self._name, time.perf_counter() - t0,
                         _arg_shapes(args, kwargs))
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)


def count_compiles(fn, name: Optional[str] = None):
    """Wrap an entry point so its first call per argument signature is
    counted per function with shapes + wall time.  Transparent to
    callers."""
    label = name or getattr(fn, "__name__", None) or repr(fn)
    return _CompileTracked(fn, label)


def compile_counts() -> Dict[str, Dict[str, Any]]:
    """Per-function compile table (copies, json-safe)."""
    with _lock:
        return {k: dict(v) for k, v in _compiles.items()}


def recompiles_after_warmup() -> Dict[str, int]:
    """{function: compiles beyond the warmup allowance}."""
    with _lock:
        return {k: v["after_warmup"] for k, v in _compiles.items()
                if v["after_warmup"]}


# ---------------------------------------------------------------------------
# HBM ledger


def attribute(component: str, nbytes: int) -> None:
    """Set the absolute device bytes attributed to `component`
    (weights / kv_pages / ...).  Owners call this once at allocation
    time or per sampler tick; idempotent."""
    with _lock:
        _components[component] = int(nbytes)


def ledger(probe: bool = False) -> Dict[str, Any]:
    """The per-process HBM ledger.  ALWAYS returns a dict (hosts without
    an initialized card get capacity from the attribution sum), so a
    reader sees the same shape everywhere.  workspace_bytes is what the
    caching allocator holds beyond the attributed components (graph
    pools, activations, temporaries)."""
    global _watermark_bytes, _watermark_fraction
    info = backend_info(probe=probe)
    stats = memory_stats()
    with _lock:
        components = dict(_components)
    attributed = sum(components.values())
    if stats:
        used = int(stats.get("bytes_in_use", attributed))
        capacity = int(stats.get("bytes_limit", 0)) or used
        peak = int(stats.get("peak_bytes_in_use", used))
    else:
        used = attributed
        capacity = _env_int("RAY_TPU_DEVICE_HBM_BYTES", 0) or used
        peak = used
    workspace = max(0, used - attributed)
    with _lock:
        if peak > _watermark_bytes:
            _watermark_bytes = peak
        if capacity:
            frac = _watermark_bytes / capacity
            if frac > _watermark_fraction:
                _watermark_fraction = frac
        wm_bytes, wm_frac = _watermark_bytes, _watermark_fraction
    try:
        _metrics()[3].set(wm_frac)
    except Exception as exc:
        warn_once(logger, "device-metrics", exc,
                  "could not update device metrics")
    return {
        "backend": info["backend"],
        "device_kind": info["device_kind"],
        "num_devices": info["num_devices"],
        "capacity_bytes": capacity,
        "used_bytes": used,
        "watermark_bytes": wm_bytes,
        "watermark_fraction": round(wm_frac, 4),
        "components": components,
        "workspace_bytes": workspace,
        "memory_stats": stats,
        "ts": time.time(),
    }


# ---------------------------------------------------------------------------
# continuous roofline / MFU step hook


def note_step(*, tokens_per_s: float, bytes_per_token: float,
              flops_per_token: float, plane: str = "serve",
              extra: Optional[Dict[str, Any]] = None,
              ) -> Tuple[float, float]:
    """Fold one sampled step window into the continuous gauges.

    `bytes_per_token` / `flops_per_token` are the MODELED per-token
    traffic and compute (weights + live KV for bytes, 2*params for
    flops).  Returns (roofline_fraction, mfu); each is 0.0 where the
    card's peak is unknown (warned once per interval)."""
    global _last_step
    if not _enabled:
        return 0.0, 0.0
    peak_bw, peak_flops = peak_specs()
    if not (peak_bw and peak_flops):
        info = backend_info()
        warn_once(logger, "device-peak-unknown", None,
                  "no peak rates known for device %r (backend %s): "
                  "roofline fraction and MFU read 0.0; set "
                  "RAY_TPU_DEVICE_HBM_GBPS and RAY_TPU_DEVICE_PEAK_TFLOPS",
                  info["device_kind"], info["backend"])
    achieved_bytes_s = tokens_per_s * max(0.0, bytes_per_token)
    achieved_flops_s = tokens_per_s * max(0.0, flops_per_token)
    frac = achieved_bytes_s / peak_bw if peak_bw else 0.0
    mfu = achieved_flops_s / peak_flops if peak_flops else 0.0
    step = {
        "kind": "step", "ts": time.time(), "plane": plane,
        "tokens_per_s": round(tokens_per_s, 2),
        "bytes_per_token": int(bytes_per_token),
        "flops_per_token": int(flops_per_token),
        "roofline_fraction": round(frac, 5),
        "mfu": round(mfu, 5),
    }
    if extra:
        step.update(extra)
    with _lock:
        _last_step = step
    try:
        m = _metrics()
        m[1].set(frac, tags={"plane": plane})
        m[2].set(mfu, tags={"plane": plane})
    except Exception as exc:
        warn_once(logger, "device-metrics", exc,
                  "could not update device metrics")
    _journal(step)
    return frac, mfu


def last_step() -> Optional[Dict[str, Any]]:
    with _lock:
        return dict(_last_step) if _last_step else None


# ---------------------------------------------------------------------------
# profile-sampler piggyback


def device_sample() -> Optional[Dict[str, Any]]:
    """Device fields for a profile sampler.  None on hosts without an
    initialized card (never raises), a compact ledger view otherwise."""
    try:
        if not has_accelerator():
            return None
        led = ledger()
        return {
            "backend": led["backend"],
            "device_kind": led["device_kind"],
            "capacity_bytes": led["capacity_bytes"],
            "used_bytes": led["used_bytes"],
            "watermark_fraction": led["watermark_fraction"],
            "components": led["components"],
            "workspace_bytes": led["workspace_bytes"],
        }
    except Exception:  # raylint: allow-swallow(sampling must never hurt the worker; None is the no-device value)
        return None


def profile_fields() -> Dict[str, Any]:
    """Top-level sample fields a profile sampler merges in: always
    includes "device" (possibly None); recompile counts and the last
    roofline/MFU window only when present."""
    out: Dict[str, Any] = {"device": device_sample()}
    try:
        rec = recompiles_after_warmup()
        if rec:
            out["recompiles"] = rec
        ls = last_step()
        if ls:
            out["roofline_fraction"] = ls["roofline_fraction"]
            out["mfu"] = ls["mfu"]
            out["tokens_per_s"] = ls["tokens_per_s"]
        led_frac = _watermark_fraction
        if led_frac:
            out["hbm_watermark_fraction"] = round(led_frac, 4)
    except Exception as exc:
        warn_once(logger, "device-profile-fields", exc,
                  "could not build device profile fields")
    return out
