"""Copy of ray_tpu/tune/callbacks.py.

Tune callbacks + logger callbacks.

Counterpart of the reference's python/ray/tune/callback.py (Callback
hook surface dispatched from TuneController) and tune/logger/
(JsonLoggerCallback json.py, CSVLoggerCallback csv.py,
TBXLoggerCallback tensorboardx.py).  Hook names match the reference so
user callbacks port verbatim; dispatch points live in
tune_controller.py.  Loggers write per-trial files into each trial's
own directory (result.json / progress.csv), the layout downstream
tooling expects.

TBX is gated exactly like tune/external_searchers.py: tensorboardX is
not in the air-gapped image, so the adapter raises a guiding
ImportError, takes `_module=` for protocol-faithful stub tests, and
activates unchanged where the real package exists.  The experiment
trackers (wandb/mlflow/comet) live in util/integrations.py.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


class Callback:
    """Experiment-loop hooks (reference tune/callback.py Callback).

    The controller calls these synchronously from its event loop; state
    kept on the callback is safe without locks."""

    def setup(self, *, run_dir: str, trials: List[Any]) -> None:
        """Once, before the loop starts (trials may still be empty —
        they are created lazily as searchers suggest)."""

    def on_trial_start(self, *, trial) -> None:
        pass

    def on_trial_result(self, *, trial, result: Dict[str, Any]) -> None:
        pass

    def on_checkpoint(self, *, trial, checkpoint_path: str) -> None:
        pass

    def on_trial_complete(self, *, trial) -> None:
        pass

    def on_trial_error(self, *, trial) -> None:
        pass

    def on_experiment_end(self, *, trials: List[Any]) -> None:
        pass


class CallbackList(Callback):
    """Fan-out dispatcher; one misbehaving callback must not kill the
    experiment loop, so hook errors are contained and reported once."""

    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])
        self._failed: set = set()

    def _each(self, hook: str, **kwargs) -> None:
        for cb in self.callbacks:
            try:
                getattr(cb, hook)(**kwargs)
            except Exception as e:  # noqa: BLE001 - contain user bugs
                key = (id(cb), hook)
                if key not in self._failed:
                    self._failed.add(key)
                    import logging

                    logging.getLogger("ray_tpu_torch.tune").warning(
                        "callback %s.%s raised %r (suppressed; further "
                        "errors from this hook are silent)",
                        type(cb).__name__, hook, e)

    def setup(self, **kw):
        self._each("setup", **kw)

    def on_trial_start(self, **kw):
        self._each("on_trial_start", **kw)

    def on_trial_result(self, **kw):
        self._each("on_trial_result", **kw)

    def on_checkpoint(self, **kw):
        self._each("on_checkpoint", **kw)

    def on_trial_complete(self, **kw):
        self._each("on_trial_complete", **kw)

    def on_trial_error(self, **kw):
        self._each("on_trial_error", **kw)

    def on_experiment_end(self, **kw):
        self._each("on_experiment_end", **kw)


# ---------------------------------------------------------------------------
# Logger callbacks
# ---------------------------------------------------------------------------


def _scalarize(value: Any) -> Any:
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, np.ndarray) and value.ndim == 0:
        return value.item()
    return value


def _flatten(metrics: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in metrics.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, f"{key}/"))
        else:
            out[key] = _scalarize(v)
    return out


class JsonLoggerCallback(Callback):
    """One JSON line per reported result → <trial_dir>/result.json
    (reference tune/logger/json.py)."""

    FILE = "result.json"

    def on_trial_result(self, *, trial, result: Dict[str, Any]) -> None:
        os.makedirs(trial.trial_dir, exist_ok=True)
        row = _flatten(result)
        row.setdefault("trial_id", trial.trial_id)
        with open(os.path.join(trial.trial_dir, self.FILE), "a") as f:
            f.write(json.dumps(row, default=str) + "\n")


class CSVLoggerCallback(Callback):
    """Tabular per-trial progress → <trial_dir>/progress.csv (reference
    tune/logger/csv.py).  The header is fixed by the FIRST result's
    keys; later keys not in the header are dropped, matching the
    reference's behavior."""

    FILE = "progress.csv"

    def __init__(self):
        self._fields: Dict[str, List[str]] = {}

    def on_trial_result(self, *, trial, result: Dict[str, Any]) -> None:
        os.makedirs(trial.trial_dir, exist_ok=True)
        row = _flatten(result)
        row.setdefault("trial_id", trial.trial_id)
        path = os.path.join(trial.trial_dir, self.FILE)
        if trial.trial_id not in self._fields:
            # An existing non-empty file means a restored experiment:
            # adopt ITS header instead of writing a second one mid-file.
            if os.path.exists(path) and os.path.getsize(path) > 0:
                with open(path, newline="") as f:
                    self._fields[trial.trial_id] = next(csv.reader(f))
            else:
                self._fields[trial.trial_id] = list(row)
                with open(path, "a", newline="") as f:
                    csv.DictWriter(
                        f, fieldnames=self._fields[trial.trial_id]
                    ).writeheader()
        with open(path, "a", newline="") as f:
            csv.DictWriter(
                f, fieldnames=self._fields[trial.trial_id],
                extrasaction="ignore").writerow(row)


class TBXLoggerCallback(Callback):
    """TensorBoard event files via tensorboardX (reference
    tune/logger/tensorboardx.py); numeric scalars only."""

    def __init__(self, _module=None):
        if _module is None:
            try:
                import tensorboardX as _module  # noqa: N813
            except ImportError:
                raise ImportError(
                    "tensorboardX is not installed (pip install "
                    "tensorboardX); in the air-gapped image use "
                    "JsonLoggerCallback / CSVLoggerCallback") from None
        self._tbx = _module
        self._writers: Dict[str, Any] = {}

    def on_trial_result(self, *, trial, result: Dict[str, Any]) -> None:
        writer = self._writers.get(trial.trial_id)
        if writer is None:
            writer = self._tbx.SummaryWriter(logdir=trial.trial_dir)
            self._writers[trial.trial_id] = writer
        step = int(result.get("training_iteration",
                              len(trial.metrics_history)))
        for k, v in _flatten(result).items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            writer.add_scalar(k, v, global_step=step)
        writer.flush()

    def on_trial_complete(self, *, trial) -> None:
        writer = self._writers.pop(trial.trial_id, None)
        if writer is not None:
            writer.close()

    def on_experiment_end(self, *, trials) -> None:
        for writer in self._writers.values():
            writer.close()
        self._writers.clear()


DEFAULT_LOGGERS = (JsonLoggerCallback, CSVLoggerCallback)


def default_callbacks(user: Optional[List[Callback]] = None
                      ) -> CallbackList:
    """User callbacks plus the default JSON/CSV loggers — unless the
    user already supplied that logger class themselves (reference
    tune/utils/callback.py _create_default_callbacks)."""
    cbs: List[Callback] = list(user or [])
    for cls in DEFAULT_LOGGERS:
        # isinstance, not type equality: a user's subclassed logger
        # already covers the role (the reference's
        # _create_default_callbacks does the same).
        if not any(isinstance(cb, cls) for cb in cbs):
            cbs.append(cls())
    return CallbackList(cbs)
