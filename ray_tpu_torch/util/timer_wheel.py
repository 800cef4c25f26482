"""Copy of ray_tpu/util/timer_wheel.py.

Event-driven timer wheel: O(pending timers) wakeups, not O(polls).

The head's control loops historically woke on short fixed intervals
(`Event.wait(0.5)` in the scheduler, `Event.wait(0.1)` in the owner-side
lease flusher) so that *time-based* state transitions — lease-demand
expiry, denial backoff, idle-lease sweeps — were noticed promptly.  That
burns a wakeup every interval even when nothing is due.  The wheel
replaces those polls with explicit deadlines: callers schedule a
callback at an absolute delay, the single wheel thread sleeps exactly
until the earliest deadline (or forever when none are pending), and
cancellation is O(1) by tombstoning the handle (reference: Ray's
``event_loop``-driven GcsServer timers and the classic hashed-wheel
design — here a binary heap suffices because pending-timer counts are
small and Python's heapq is C-backed).

Callbacks run on the wheel thread OUTSIDE the wheel lock; they must be
short and non-blocking (typically "set an Event" / "notify a
condition").  Exceptions are swallowed so one bad callback cannot kill
the shared thread.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, List, Optional, Tuple

__all__ = ["Timer", "TimerWheel", "wheel"]


class Timer:
    """Handle for one scheduled callback.  ``cancel()`` is O(1): the
    heap entry stays put but fires as a no-op."""

    __slots__ = ("deadline", "seq", "_fn", "_cancelled")

    def __init__(self, deadline: float, seq: int, fn: Callable[[], None]):
        self.deadline = deadline
        self.seq = seq
        self._fn = fn
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True
        self._fn = None

    @property
    def cancelled(self) -> bool:
        return self._cancelled


class TimerWheel:
    """Single-threaded deadline heap with condition-variable wakeups.

    ``schedule(delay_s, fn)`` returns a :class:`Timer`; the wheel thread
    is started lazily on first schedule and parks indefinitely when the
    heap drains, so an idle process costs zero wakeups.
    """

    def __init__(self, name: str = "ray_tpu-timer-wheel"):
        self._name = name
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._heap: List[Tuple[float, int, Timer]] = []
        self._seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._fired = 0

    # -- public API ----------------------------------------------------
    def schedule(self, delay_s: float, fn: Callable[[], None],
                 label: str = "") -> Timer:
        """Run ``fn()`` on the wheel thread ``delay_s`` seconds from now
        (clamped to >= 0).  Returns a cancellable handle."""
        deadline = time.time() + max(0.0, float(delay_s))
        with self._cond:
            if self._stopped:
                raise RuntimeError("timer wheel stopped")
            t = Timer(deadline, next(self._seq), fn)
            heapq.heappush(self._heap, (t.deadline, t.seq, t))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True)
                self._thread.start()
            # Wake the thread iff the new timer became the head —
            # otherwise its current sleep already covers us.
            if self._heap[0][2] is t:
                self._cond.notify()
        return t

    def pending(self) -> int:
        with self._lock:
            return sum(1 for _, _, t in self._heap if not t.cancelled)

    def fired(self) -> int:
        with self._lock:
            return self._fired

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._heap.clear()
            self._cond.notify()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    # -- wheel thread --------------------------------------------------
    def _run(self) -> None:
        while True:
            fire: List[Timer] = []
            with self._cond:
                while not self._stopped:
                    now = time.time()
                    # Pop tombstoned heads eagerly so cancelled timers
                    # never shorten the sleep.
                    while self._heap and self._heap[0][2].cancelled:
                        heapq.heappop(self._heap)
                    if self._heap and self._heap[0][0] <= now:
                        while self._heap and self._heap[0][0] <= now:
                            _, _, t = heapq.heappop(self._heap)
                            if not t.cancelled:
                                fire.append(t)
                        break
                    timeout = (self._heap[0][0] - now) if self._heap \
                        else None
                    self._cond.wait(timeout)
                if self._stopped:
                    return
                self._fired += len(fire)
            for t in fire:
                fn = t._fn
                t._fn = None
                if fn is None:
                    continue
                try:
                    fn()
                except Exception:  # raylint: allow-swallow(one bad wakeup callback must not kill the shared wheel thread)
                    pass
                try:
                    from ray_tpu_torch.util import flight_recorder
                    flight_recorder.record(
                        "sched", "timer_fire",
                        deadline=round(t.deadline, 4))
                except Exception:  # raylint: allow-swallow(telemetry only)
                    pass


_wheel: Optional[TimerWheel] = None
_wheel_lock = threading.Lock()


def wheel() -> TimerWheel:
    """Lazily-created process-wide wheel shared by the head scheduler
    and owner-side runtimes (one extra thread per process, total)."""
    global _wheel
    w = _wheel
    if w is None:
        with _wheel_lock:
            w = _wheel
            if w is None:
                w = _wheel = TimerWheel()
    return w
