"""Ranks of the port for the CPU tests: a TorchTrainer fit of n gloo
ranks whose results come back as one pickle per rank, and a result
shared by the xdist workers of one test run.

The pytest process never joins a process group; every rank is a
TorchTrainer worker of the test file's cluster.  Imported by the
tests/test_torch_*.py files that run ranks.
"""

import fcntl
import importlib
import os
import pickle
import threading

import pytest

PORT = "ray_tpu" "_torch"
train = importlib.import_module(f"{PORT}.train")
tbackend = importlib.import_module(f"{PORT}.train.torch_backend")


def fit_ranks(loop, n, out_dir, config=None, timeout=240.0):
    """Run `loop` on `n` gloo ranks (TorchTrainer workers on the CPU) and
    return each rank's pickled results from `out_dir`; fails the test
    if the fit does not end within `timeout` seconds."""
    os.makedirs(out_dir, exist_ok=True)
    trainer = train.TorchTrainer(
        loop, train_loop_config={**(config or {}), "out": str(out_dir)},
        scaling_config=train.ScalingConfig(num_workers=n, use_gpu=False),
        backend_config=tbackend.TorchConfig(init_timeout_s=120.0),
        run_config=train.RunConfig(storage_path=str(out_dir), name="fit"))
    box = {}

    def run():
        try:
            box["result"] = trainer.fit()
        except BaseException as e:  # reported below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"fit of {n} ranks did not end in {timeout} s")
    if "error" in box:
        raise box["error"]
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def shared_result(request, name, compute):
    """`compute()`, run once per test run: under xdist every worker that
    draws a test of a module-scoped fixture would run the fixture again,
    so the first computes under a file lock in the run's base temporary
    directory (each worker's own is under it) and the others load its
    pickle.  A result that raised is not stored."""
    base = request.getfixturevalue("tmp_path_factory").getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"shared-{name}.pkl"
    with open(base / f"shared-{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = compute()
        tmp = base / f"shared-{name}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, path)
        return out
