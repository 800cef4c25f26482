"""@serve.multiplexed: per-replica LRU of loaded models.

Counterpart of python/ray/serve/multiplex.py: a replica hosts up to
num_models_per_replica models, loading on demand and evicting
least-recently-used.  The model id for a request comes from
handle.options(multiplexed_model_id=...) via the request context.

Concurrency: loads are single-flight (concurrent requests for the same
id share one loader call; the loser threads wait), and a model is
PINNED while any request holds it — the LRU never evicts a model
mid-inference.  Pins release when the request finishes
(replica._finish_call); if every resident model is pinned the cache
temporarily overflows capacity and evicts on the next release instead.
"""

from __future__ import annotations

import functools
import logging
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List

from ray_tpu_torch.core.log_once import warn_once
from ray_tpu_torch.serve.replica import get_request_context, _live_request_context

logger = logging.getLogger(__name__)


class _ModelCache:
    def __init__(self, loader: Callable, capacity: int):
        self._loader = loader
        self._capacity = capacity
        self._lock = threading.Lock()
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._pins: Dict[str, int] = {}
        # model_id -> in-flight load marker.  The loading thread owns
        # the loader call; everyone else waits on the Event (a failed
        # load attaches the exception so waiters re-raise it).
        self._loading: Dict[str, threading.Event] = {}
        self.load_count = 0  # distinct loader invocations (tests)

    def get(self, instance, model_id: str) -> Any:
        """Return the model, loading it at most once per miss across
        concurrent callers, and pin it (caller's request holds it)."""
        while True:
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    self._pins[model_id] = \
                        self._pins.get(model_id, 0) + 1
                    return self._models[model_id]
                ev = self._loading.get(model_id)
                if ev is None:
                    ev = self._loading[model_id] = threading.Event()
                    break  # this thread loads; others wait on ev
            ev.wait()
            err = getattr(ev, "error", None)
            if err is not None:
                raise err
            # else: loaded — loop re-checks under the lock.
        try:
            model = (self._loader(instance, model_id)
                     if instance is not None
                     else self._loader(model_id))
        except BaseException as e:
            ev.error = e  # waiters re-raise; later callers retry fresh
            with self._lock:
                self._loading.pop(model_id, None)
            ev.set()
            raise
        with self._lock:
            self.load_count += 1
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            self._pins[model_id] = self._pins.get(model_id, 0) + 1
            self._loading.pop(model_id, None)
            self._evict_locked()
        ev.set()
        return model

    def unpin(self, model_id: str) -> None:
        with self._lock:
            n = self._pins.get(model_id, 0) - 1
            if n > 0:
                self._pins[model_id] = n
            else:
                self._pins.pop(model_id, None)
            self._evict_locked()

    def _evict_locked(self) -> None:
        """Evict unpinned LRU entries past capacity.  A fully-pinned
        cache overflows instead of evicting a model in use; the next
        unpin re-runs this."""
        while len(self._models) > self._capacity:
            victim = next((mid for mid in self._models
                           if self._pins.get(mid, 0) == 0), None)
            if victim is None:
                return
            evicted = self._models.pop(victim)
            unload = getattr(evicted, "unload", None)
            if callable(unload):
                try:
                    unload()
                except Exception as e:  # noqa: BLE001
                    warn_once(logger, "multiplex-unload", e,
                              "model %r unload() failed: %r", victim, e)
            del evicted

    def loaded_ids(self) -> List[str]:
        with self._lock:
            return list(self._models)

    def pinned_ids(self) -> List[str]:
        with self._lock:
            return [m for m, n in self._pins.items() if n > 0]


# Caches are created lazily per (process, function) — a _ModelCache holds a
# lock, which would make decorated classes unpicklable (same pattern as
# batching._get_batcher).
_registry_lock = threading.Lock()
_registry: dict = {}


def _get_cache(key, fn, capacity) -> _ModelCache:
    with _registry_lock:
        c = _registry.get(key)
        if c is None:
            c = _registry[key] = _ModelCache(fn, capacity)
        return c


def loaded_model_ids() -> List[str]:
    """All multiplex model ids resident in THIS process, across every
    @serve.multiplexed cache (the replica's load_report piggybacks this
    to the router for model-affinity P2C)."""
    with _registry_lock:
        caches = list(_registry.values())
    ids: set = set()
    for c in caches:
        ids.update(c.loaded_ids())
    return sorted(ids)


def _pin_for_request(cache: _ModelCache, model_id: str) -> None:
    """get() already pinned the model for the caller; hand the pin to
    the live request context (released at request end) or drop it right
    away when called outside a replica request (direct test calls)."""
    ctx = _live_request_context()
    if ctx is not None:
        ctx.model_pins.append((cache, model_id))
    else:
        cache.unpin(model_id)


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorator on the replica's model-loading method; returns a getter
    that resolves the current request's multiplexed model id."""

    def wrap(fn):
        import inspect

        params = list(inspect.signature(fn).parameters)
        is_method = params and params[0] == "self"
        key = f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def method(self, model_id: str = ""):
            mid = model_id or get_request_context().multiplexed_model_id
            cache = _get_cache(
                (key, id(self)), fn, max_num_models_per_replica)
            model = cache.get(self, mid)
            _pin_for_request(cache, mid)
            return model

        @functools.wraps(fn)
        def func(model_id: str = ""):
            mid = model_id or get_request_context().multiplexed_model_id
            cache = _get_cache((key, None), fn, max_num_models_per_replica)
            model = cache.get(None, mid)
            _pin_for_request(cache, mid)
            return model

        return method if is_method else func

    if _fn is not None:
        return wrap(_fn)
    return wrap


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id requested by the caller."""
    return get_request_context().multiplexed_model_id
