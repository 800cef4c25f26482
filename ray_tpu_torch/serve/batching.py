"""@serve.batch: dynamic request batching inside a replica.

Counterpart of python/ray/serve/batching.py: calls arriving within
batch_wait_timeout_s are coalesced (up to max_batch_size) into ONE call of
the wrapped function, which receives a list and must return a same-length
list.  On GPU replicas this is the knob that keeps the tensor cores fed —
batched forward passes instead of per-request ones.
"""

from __future__ import annotations

import functools
import threading
from concurrent.futures import Future
from typing import Any, Callable, List


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._wait_s = batch_wait_timeout_s
        self._lock = threading.Lock()
        self._pending: List[tuple] = []  # (arg, Future)
        self._timer: threading.Timer | None = None

    def submit(self, instance, arg) -> Future:
        fut: Future = Future()
        flush_now = False
        with self._lock:
            self._pending.append((arg, fut))
            if len(self._pending) >= self._max:
                flush_now = True
            elif self._timer is None:
                self._timer = threading.Timer(
                    self._wait_s, self._flush, args=(instance,))
                self._timer.daemon = True
                self._timer.start()
        if flush_now:
            self._flush(instance)
        return fut

    def _flush(self, instance):
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            batch, self._pending = self._pending, []
        if not batch:
            return
        args = [a for a, _ in batch]
        futs = [f for _, f in batch]
        try:
            results = (self._fn(instance, args) if instance is not None
                       else self._fn(args))
            if len(results) != len(args):
                raise ValueError(
                    f"batched function returned {len(results)} results "
                    f"for a batch of {len(args)}")
            for f, r in zip(futs, results):
                f.set_result(r)
        except BaseException as e:  # noqa: BLE001
            for f in futs:
                if not f.done():
                    f.set_exception(e)


# Batchers are created lazily per (process, wrapped function) and kept out
# of the wrapper's closure: a _Batcher holds locks/timers, which would make
# decorated classes unpicklable for shipping to replica actors.
_registry_lock = threading.Lock()
_registry: dict = {}


def _get_batcher(key, fn, max_batch_size, batch_wait_timeout_s) -> _Batcher:
    with _registry_lock:
        b = _registry.get(key)
        if b is None:
            b = _registry[key] = _Batcher(
                fn, max_batch_size, batch_wait_timeout_s)
        return b


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator for replica methods (or bare functions) taking a single
    request argument; the wrapped implementation receives a list."""

    def wrap(fn):
        key = f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def method(self, arg: Any = None):
            batcher = _get_batcher(
                (key, id(self)), fn, max_batch_size, batch_wait_timeout_s)
            return batcher.submit(self, arg).result()

        @functools.wraps(fn)
        def func(arg: Any = None):
            batcher = _get_batcher(
                (key, None), fn, max_batch_size, batch_wait_timeout_s)
            return batcher.submit(None, arg).result()

        import inspect

        params = list(inspect.signature(fn).parameters)
        is_method = params and params[0] == "self"
        return method if is_method else func

    if _fn is not None:
        return wrap(_fn)
    return wrap
