"""The port's tune callbacks against the JAX package's, on the CPU.

The logger cases of tests/test_tune_callbacks.py that need no Tuner:
the JSON and CSV loggers attached by default (both packages writing the
same result.json and progress.csv for the same results), no second CSV
header after a restore, the default loggers respecting a user's
subclass, the TBX logger through a stub module, and a failing callback
contained by CallbackList.  No cluster.
"""

import csv
import dataclasses
import importlib
import json
import os
import types

import numpy as np
import pytest

from ray_tpu.tune import callbacks as jcb

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
tcb = importlib.import_module(f"{PORT}.tune.callbacks")
tune = importlib.import_module(f"{PORT}.tune")


@dataclasses.dataclass
class _Trial:
    trial_id: str
    trial_dir: str
    metrics_history: list


RESULTS = [{"score": 1.0, "training_iteration": 1, "nested": {"a": 1}},
           {"score": np.float32(2.0), "training_iteration": 2,
            "nested": {"a": np.int64(2)}, "extra": "dropped by the CSV"},
           {"score": 3.0, "training_iteration": 3, "nested": {"a": 3}}]


def _drive(mod, trial_dir, callbacks=None):
    cbs = mod.default_callbacks(callbacks)
    trial = _Trial("trial_00000", trial_dir, [])
    cbs.setup(run_dir=os.path.dirname(trial_dir), trials=[trial])
    cbs.on_trial_start(trial=trial)
    for r in RESULTS:
        trial.metrics_history.append(r)
        cbs.on_trial_result(trial=trial, result=r)
    cbs.on_trial_complete(trial=trial)
    cbs.on_experiment_end(trials=[trial])
    return cbs


def test_json_and_csv_loggers_default(tmp_path):
    """default_callbacks(None) attaches the JSON and CSV loggers, and the
    port's write what the reference's write, byte for byte."""
    files = {}
    for pkg, mod in (("ref", jcb), ("port", tcb)):
        cbs = _drive(mod, str(tmp_path / pkg / "trial_00000"))
        assert [type(c).__name__ for c in cbs.callbacks] == [
            "JsonLoggerCallback", "CSVLoggerCallback"]
        tdir = tmp_path / pkg / "trial_00000"
        files[pkg] = {f: (tdir / f).read_text()
                      for f in ("result.json", "progress.csv")}
    assert files["ref"] == files["port"]
    rows = [json.loads(line) for line in files["port"][
        "result.json"].splitlines()]
    assert [r["score"] for r in rows] == [1.0, 2.0, 3.0]
    assert rows[0]["trial_id"] == "trial_00000" and rows[1]["nested/a"] == 2
    crows = list(csv.DictReader(files["port"]["progress.csv"].splitlines()))
    assert [float(r["score"]) for r in crows] == [1.0, 2.0, 3.0]
    assert "extra" not in crows[0]


def test_csv_logger_no_duplicate_header_after_restore(tmp_path):
    t = _Trial("trial_x", str(tmp_path / "trial_x"), [])
    tcb.CSVLoggerCallback().on_trial_result(trial=t, result={"score": 1.0})
    # A restored controller: a fresh instance adopts the file's header.
    tcb.CSVLoggerCallback().on_trial_result(trial=t, result={"score": 2.0})
    with open(os.path.join(t.trial_dir, "progress.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    assert [float(r["score"]) for r in rows] == [1.0, 2.0]


def test_default_loggers_respect_subclasses():
    class MyJson(tcb.JsonLoggerCallback):
        pass

    cbs = tcb.default_callbacks([MyJson()]).callbacks
    assert sum(isinstance(c, tcb.JsonLoggerCallback) for c in cbs) == 1
    assert sum(isinstance(c, tcb.CSVLoggerCallback) for c in cbs) == 1
    assert tcb.DEFAULT_LOGGERS == (tcb.JsonLoggerCallback,
                                   tcb.CSVLoggerCallback)
    assert [type(c).__name__ for c in jcb.default_callbacks(
        [type("MyJson", (jcb.JsonLoggerCallback,), {})()]).callbacks] == [
        type(c).__name__ for c in cbs]


def _stub_tbx(writes):
    class _Writer:
        def __init__(self, logdir=None):
            writes.append(("open", os.path.basename(logdir)))

        def add_scalar(self, tag, value, global_step=None):
            writes.append((tag, value, global_step))

        def flush(self):
            pass

        def close(self):
            writes.append(("closed",))

    mod = types.ModuleType("tensorboardX")
    mod.SummaryWriter = _Writer
    return mod


def test_tbx_logger_stub(tmp_path):
    """Numeric scalars at their training_iteration, the writer closed at
    the trial's end; the same calls from both packages' loggers."""
    calls = {}
    for pkg, mod in (("ref", jcb), ("port", tcb)):
        writes = []
        _drive(mod, str(tmp_path / pkg / "trial_00000"),
               [mod.TBXLoggerCallback(_module=_stub_tbx(writes))])
        calls[pkg] = writes
    assert calls["ref"] == calls["port"]
    scalars = [w for w in calls["port"] if w[0] == "score"]
    assert [(v, s) for _, v, s in scalars] == [(1.0, 1), (2.0, 2), (3.0, 3)]
    assert calls["port"][-1] == ("closed",)


def test_tbx_logger_without_the_package_raises(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="tensorboardX"):
        tcb.TBXLoggerCallback()


def test_callback_error_is_contained():
    class Broken(tcb.Callback):
        def on_trial_start(self, *, trial):
            raise ValueError("bad callback")

    seen = []

    class Recorder(tcb.Callback):
        def on_trial_start(self, *, trial):
            seen.append(trial.trial_id)

    cbs = tune.CallbackList([Broken(), Recorder()])
    t = _Trial("t0", "", [])
    cbs.on_trial_start(trial=t)
    cbs.on_trial_start(trial=t)
    assert seen == ["t0", "t0"]
    assert set(tune.__all__) == {
        "Callback", "CallbackList", "CSVLoggerCallback",
        "JsonLoggerCallback", "TBXLoggerCallback", "DEFAULT_LOGGERS",
        "default_callbacks"}
