"""Rate-limited once-per-cause warnings for hot paths.

Copy of ray_tpu/core/log_once.py (the port imports nothing of the JAX
package).  Where raising is wrong but silence is worse (a telemetry
write, an optional hook), warn once per distinct cause per interval::

    from ray_tpu_torch.core.log_once import warn_once
    ...
    except Exception as exc:
        warn_once(logger, "respond-failed", exc,
                  "could not deliver response (peer gone?)")

A (tag, exception type, truncated message) triple is warned at most
once per ``_WARN_INTERVAL_S``; repeats within the window are counted
and the count is folded into the next emission so bursts stay visible
without log spam.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

_WARN_INTERVAL_S = 60.0
_lock = threading.Lock()
# cause-key -> (last emission monotonic time, suppressed since then)
_seen: Dict[str, Tuple[float, int]] = {}


def cause_key(tag: str, exc: Optional[BaseException]) -> str:
    if exc is None:
        return tag
    return f"{tag}: {type(exc).__name__}: {str(exc)[:120]}"


def should_log(tag: str, exc: Optional[BaseException] = None,
               interval_s: float = _WARN_INTERVAL_S
               ) -> Tuple[bool, int]:
    """(emit?, count suppressed since the last emission).  Thread-safe
    and allocation-light: one dict probe under one module lock."""
    key = cause_key(tag, exc)
    now = time.monotonic()
    with _lock:
        last = _seen.get(key)
        if last is not None and now - last[0] < interval_s:
            _seen[key] = (last[0], last[1] + 1)
            return False, 0
        suppressed = last[1] if last is not None else 0
        _seen[key] = (now, 0)
    return True, suppressed


def warn_once(logger, tag: str, exc: Optional[BaseException],
              message: str, *args,
              interval_s: float = _WARN_INTERVAL_S) -> bool:
    """Log ``message`` (lazy %-args) at WARNING, at most once per
    distinct (tag, cause) per interval.  Returns True if it logged."""
    emit, suppressed = should_log(tag, exc, interval_s)
    if not emit:
        return False
    suffix = f" [{suppressed} similar suppressed]" if suppressed else ""
    cause = f": {cause_key('', exc)[2:]}" if exc is not None else ""
    logger.warning(message + cause + suffix, *args)
    return True


def reset() -> None:
    """Test hook: forget every cause."""
    with _lock:
        _seen.clear()
