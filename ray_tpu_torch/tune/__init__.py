"""Tune's callbacks: the experiment-loop hooks and the JSON / CSV / TBX
loggers that `train.DataParallelTrainer.fit()` dispatches.

Only `callbacks.py` is ported so far.  The rest of the JAX package's
`tune/` (Tuner, the controller, search spaces and algorithms,
schedulers) is ROADMAP Queue A item 10.
"""

from ray_tpu_torch.tune.callbacks import (
    DEFAULT_LOGGERS,
    Callback,
    CallbackList,
    CSVLoggerCallback,
    JsonLoggerCallback,
    TBXLoggerCallback,
    default_callbacks,
)

__all__ = [
    "Callback",
    "CallbackList",
    "CSVLoggerCallback",
    "JsonLoggerCallback",
    "TBXLoggerCallback",
    "DEFAULT_LOGGERS",
    "default_callbacks",
]
