"""The port's Train library on its own runtime, on the CPU.

The function-level cases of tests/test_train_jaxtrainer.py with
TorchTrainer (one worker's reports and result, two workers' contexts and
data shards, a checkpoint persisted into the result, recovery from a
hard-killed worker resuming from its checkpoint, a loop's own error,
checkpoint numbering across a restart with num_to_keep), the cases of
tests/test_train_torch.py (two-worker gloo DDP, prepare_data_loader's
shards, one worker without a process group) and
tests/test_tune_callbacks.py::test_train_fit_dispatches_callbacks.

The slice as a whole: a TorchTrainer worker trains the tiny transformer
at fp32 through ShardedTrainStep(device="cpu") for 2 steps, checkpoints
its whole state with save_pytree_async, is killed (os._exit), and a new
worker resumes from the checkpoint for 2 more steps.  Its reported
losses and grad norms equal the reference's ShardedTrainStep run in this
process for 4 uninterrupted steps from the same state (carried across
with state_from_numpy) to rtol 1e-5 and 1e-4, and the port's own
uninterrupted run in a worker bit for bit.

One cluster for the file (num_cpus=4, num_gpus=0); every blocking call
has a timeout; loops are defined inside the tests (a test module is not
importable in a worker), and name the port through `PORT`.
"""

import csv
import importlib
import json
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel.mesh import build_mesh
from ray_tpu.train import config as jconfig
from ray_tpu.train import train_state as jts

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
rt = importlib.import_module(PORT)
train = importlib.import_module(f"{PORT}.train")
ttf = importlib.import_module(f"{PORT}.models.transformer")
twg = importlib.import_module(f"{PORT}.train.worker_group")
tsess = importlib.import_module(f"{PORT}.train.session")
tts = importlib.import_module(f"{PORT}.train.train_state")
tcb = importlib.import_module(f"{PORT}.tune.callbacks")


@pytest.fixture(scope="module")
def cluster():
    drv = rt.init(num_cpus=4, num_gpus=0, log_to_driver=False)
    try:
        yield drv
    finally:
        rt.shutdown()


def _fit(loop, tmp_path, name, *, config=None, workers=1, max_failures=0,
         num_to_keep=None, **kw):
    return train.TorchTrainer(
        loop, train_loop_config=config or {},
        scaling_config=train.ScalingConfig(num_workers=workers,
                                           use_gpu=False),
        run_config=train.RunConfig(
            storage_path=str(tmp_path), name=name,
            failure_config=train.FailureConfig(max_failures=max_failures),
            checkpoint_config=train.CheckpointConfig(
                num_to_keep=num_to_keep),
            callbacks=kw.pop("callbacks", None)), **kw).fit()


# -- tests/test_train_jaxtrainer.py -------------------------------------------


def test_single_worker_report_and_result(cluster, tmp_path):
    port = PORT

    def loop(config):
        tr = importlib.import_module(f"{port}.train")
        ctx = tr.get_context()
        for i in range(config["steps"]):
            tr.report({"step": i, "loss": 1.0 / (i + 1),
                       "rank": ctx.get_world_rank(),
                       "experiment": ctx.get_experiment_name()})

    res = _fit(loop, tmp_path, "single", config={"steps": 3})
    assert res.metrics["step"] == 2 and res.metrics["rank"] == 0
    assert res.metrics["experiment"] == "single"
    assert len(res.metrics_history) == 3
    assert res.path == os.path.join(str(tmp_path), "single")
    assert res.checkpoint is None and res.error is None


def test_two_workers_context_and_data_shards(cluster, tmp_path):
    port = PORT

    def loop():
        tr = importlib.import_module(f"{port}.train")
        ctx = tr.get_context()
        shard = tr.get_dataset_shard("train")
        tr.report({"rank": ctx.get_world_rank(),
                   "world": ctx.get_world_size(),
                   "shard_sum": float(np.sum(shard))})

    res = _fit(loop, tmp_path, "two", workers=2,
               datasets={"train": np.arange(8)})
    assert res.metrics["world"] == 2 and res.metrics["rank"] == 0
    # rank 0 got the first half of 0..7
    assert res.metrics["shard_sum"] == float(np.sum(np.arange(4)))


def test_checkpoint_persist_and_result(cluster, tmp_path):
    port = PORT

    def loop(config):
        tr = importlib.import_module(f"{port}.train")
        for i in range(2):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"step": i}, f)
            tr.report({"step": i},
                      checkpoint=tr.Checkpoint.from_directory(d))

    res = _fit(loop, tmp_path, "ckpt")
    assert res.checkpoint is not None
    with open(os.path.join(res.checkpoint.as_directory(),
                           "state.json")) as f:
        assert json.load(f)["step"] == 1
    assert res.checkpoint.get_metadata()["metrics"]["step"] == 1
    assert res.metrics_history[-1]["checkpoint_path"] \
        == res.checkpoint.path
    assert res.best_checkpoints == [res.checkpoint]


def test_failure_recovery_resumes_from_checkpoint(cluster, tmp_path):
    port = PORT
    marker = str(tmp_path / "killed")

    def loop(config):
        tr = importlib.import_module(f"{port}.train")
        start = 0
        ck = tr.get_checkpoint()
        if ck is not None:
            with open(os.path.join(ck.as_directory(), "s.json")) as f:
                start = json.load(f)["step"] + 1
        for i in range(start, 4):
            if i == 2 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                # report() returned, so the driver holds step 1's row.
                os._exit(1)  # hard-kill the worker process
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "s.json"), "w") as f:
                json.dump({"step": i}, f)
            tr.report({"step": i, "resumed_from": start, "pid": os.getpid()},
                      checkpoint=tr.Checkpoint.from_directory(d))

    res = _fit(loop, tmp_path, "recover", config={"marker": marker},
               max_failures=1)
    assert res.metrics["step"] == 3
    assert res.metrics["resumed_from"] == 2  # resumed, not restarted
    hist = res.metrics_history
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert hist[1]["pid"] != hist[2]["pid"]


def test_failed_attempt_keeps_its_last_report(cluster, tmp_path):
    """A worker killed right after report() returned has lost nothing:
    its row without a checkpoint is in the history (the port's report
    returns once the driver holds the result)."""
    port = PORT
    marker = str(tmp_path / "killed")

    def loop(config):
        tr = importlib.import_module(f"{port}.train")
        first = not os.path.exists(config["marker"])
        tr.report({"attempt": 1 if first else 2, "pid": os.getpid()})
        if first:
            open(config["marker"], "w").close()
            os._exit(1)

    res = _fit(loop, tmp_path, "lastrow", config={"marker": marker},
               max_failures=1)
    assert [h["attempt"] for h in res.metrics_history] == [1, 2]
    assert res.metrics_history[0]["pid"] != res.metrics_history[1]["pid"]


def test_user_error_raises_training_failed(cluster, tmp_path):
    def loop():
        raise ValueError("boom in user loop")

    with pytest.raises(train.TrainingFailedError, match="boom"):
        _fit(loop, tmp_path, "err", max_failures=3)


def test_checkpoint_numbering_survives_restart_and_num_to_keep(cluster,
                                                               tmp_path):
    """Restarted attempts continue checkpoint numbering (no overwrite) and
    num_to_keep GC runs on the persisting worker."""
    port = PORT
    marker = str(tmp_path / "killed")

    def loop(config):
        tr = importlib.import_module(f"{port}.train")
        start = 0
        ck = tr.get_checkpoint()
        if ck is not None:
            start = int(open(os.path.join(
                ck.as_directory(), "s.txt")).read()) + 1
        for i in range(start, 4):
            if i == 2 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                os._exit(1)
            d = tempfile.mkdtemp()
            open(os.path.join(d, "s.txt"), "w").write(str(i))
            tr.report({"step": i}, checkpoint=tr.Checkpoint.from_directory(d))

    res = _fit(loop, tmp_path, "seq", config={"marker": marker},
               max_failures=1, num_to_keep=2)
    # The final checkpoint holds step 3 (post-crash work), not stale state.
    assert open(os.path.join(res.checkpoint.as_directory(),
                             "s.txt")).read() == "3"
    kept = sorted(d for d in os.listdir(str(tmp_path / "seq"))
                  if d.startswith("checkpoint_"))
    assert kept == ["checkpoint_000002", "checkpoint_000003"], kept


def test_scaling_config_asks_for_the_card_by_default():
    """use_gpu defaults to True where the reference's use_tpu defaults to
    False: the port's entry points run on the card unless asked for the
    CPU.  CheckpointConfig has no checkpoint_frequency, which nothing
    read."""
    assert train.ScalingConfig().use_gpu is True
    assert jconfig.ScalingConfig().use_tpu is False
    assert train.ScalingConfig().worker_resources() == {"CPU": 1.0,
                                                        "GPU": 1.0}
    assert train.ScalingConfig(use_gpu=False).worker_resources() == {
        "CPU": 1.0}
    assert train.ScalingConfig(gpus_per_worker=0.5).worker_resources() \
        == {"CPU": 1.0, "GPU": 0.5}
    assert hasattr(jconfig.CheckpointConfig(), "checkpoint_frequency")
    assert not hasattr(train.CheckpointConfig(), "checkpoint_frequency")


def test_report_returns_once_the_driver_holds_the_result(tmp_path):
    """The worker side in this process: report() queues its result and
    returns only when the driver asks for the next one, which it does
    once it holds the last reply."""
    returned = threading.Event()

    def loop():
        train.report({"step": 0})
        returned.set()

    w = twg.TrainWorker(0, 1, str(tmp_path / "run"))
    try:
        w.start_training(loop, {}, None, {}, "run")
        assert w.next_result(timeout=10)["metrics"] == {"step": 0}
        assert not returned.wait(0.3)  # handed to the driver, not yet held
        assert w.next_result(timeout=10) == {"finished": True}
        assert returned.is_set()
    finally:
        tsess._set_session(None)


# -- tests/test_train_torch.py -----------------------------------------------


def test_torch_trainer_ddp_two_workers(cluster, tmp_path):
    """Two gloo ranks: DDP's gradient averaging leaves both ranks' models
    bitwise equal after training on different shards; near the true
    weights."""
    port = PORT

    def loop(config):
        import torch
        import torch.distributed as dist
        import torch.nn as nn

        tr = importlib.import_module(f"{port}.train")
        tb = importlib.import_module(f"{port}.train.torch_backend")
        ctx = tr.get_context()
        rank, world = ctx.get_world_rank(), ctx.get_world_size()
        assert dist.is_initialized() and dist.get_world_size() == world
        assert tb.get_device() == torch.device("cpu")
        torch.manual_seed(0)  # same init on both ranks
        model = tb.prepare_model(nn.Linear(4, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        g = torch.Generator().manual_seed(100 + rank)  # distinct shards
        X = torch.randn(64, 4, generator=g)
        y = X @ torch.tensor([[1.0, -2.0, 3.0, 0.5]]).T
        for _ in range(60):
            opt.zero_grad()
            loss = ((model(X) - y) ** 2).mean()
            loss.backward()
            opt.step()
        w = model.module.weight.detach().numpy().copy()
        gathered = [None] * world
        dist.all_gather_object(gathered, w.tolist())
        tr.report({"loss": float(loss.detach()), "all_weights": gathered,
                   "wrapped": type(model).__name__,
                   "backend": dist.get_backend()})

    res = _fit(loop, tmp_path, "ddp", workers=2)
    assert res.metrics["loss"] < 0.05, res.metrics
    assert res.metrics["wrapped"] == "DistributedDataParallel"
    assert res.metrics["backend"] == "gloo"
    w0, w1 = res.metrics["all_weights"]
    assert w0 == w1
    np.testing.assert_allclose(np.asarray(w0).ravel(),
                               [1.0, -2.0, 3.0, 0.5], atol=0.2)


def test_prepare_data_loader_shards_per_rank(cluster, tmp_path):
    port = PORT

    def loop(config):
        import torch
        import torch.distributed as dist
        from torch.utils.data import DataLoader, TensorDataset

        tr = importlib.import_module(f"{port}.train")
        tb = importlib.import_module(f"{port}.train.torch_backend")
        ctx = tr.get_context()
        ds = TensorDataset(torch.arange(20).float())
        loader = tb.prepare_data_loader(DataLoader(ds, batch_size=5))
        seen = sorted(int(x) for batch in loader for x in batch[0])
        gathered = [None] * ctx.get_world_size()
        dist.all_gather_object(gathered, seen)
        tr.report({"per_rank": gathered})

    res = _fit(loop, tmp_path, "loader", workers=2)
    r0, r1 = res.metrics["per_rank"]
    # Each rank sees half the dataset; together they cover everything.
    assert len(r0) == 10 and len(r1) == 10
    assert sorted(r0 + r1) == list(range(20))


def test_torch_trainer_single_worker_no_group(cluster, tmp_path):
    port = PORT

    def loop(config):
        import torch.distributed as dist
        import torch.nn as nn

        tr = importlib.import_module(f"{port}.train")
        tb = importlib.import_module(f"{port}.train.torch_backend")
        assert not dist.is_initialized()
        model = tb.prepare_model(nn.Linear(2, 1))
        assert not hasattr(model, "module")  # no DDP wrap solo
        tr.report({"ok": 1, "device": str(tb.get_device()),
                   "mesh": tr.get_mesh().shape})

    res = _fit(loop, tmp_path, "solo")
    assert res.metrics == {"ok": 1, "device": "cpu", "mesh": {
        "data": 1, "stage": 1, "fsdp": 1, "seq": 1, "tensor": 1,
        "expert": 1}}


# -- tests/test_tune_callbacks.py --------------------------------------------


def test_train_fit_dispatches_callbacks(cluster, tmp_path):
    port = PORT
    events = []

    class Recorder(tcb.Callback):
        def setup(self, *, run_dir, trials):
            events.append(("setup", run_dir))

        def on_trial_start(self, *, trial):
            events.append(("start", trial.trial_id))

        def on_trial_result(self, *, trial, result):
            events.append(("result", result["loss"]))

        def on_checkpoint(self, *, trial, checkpoint_path):
            events.append(("checkpoint", checkpoint_path))

        def on_trial_complete(self, *, trial):
            events.append(("complete", trial.trial_id))

        def on_experiment_end(self, *, trials):
            events.append(("end", len(trials)))

    def loop(config):
        tr = importlib.import_module(f"{port}.train")
        for i in range(3):
            d = tempfile.mkdtemp() if i == 1 else None
            tr.report({"loss": 1.0 / (i + 1), "training_iteration": i + 1},
                      checkpoint=d and tr.Checkpoint.from_directory(d))

    res = _fit(loop, tmp_path, "cbtrain", callbacks=[Recorder()])
    assert len(res.metrics_history) == 3
    kinds = [e[0] for e in events]
    assert kinds[0] == "setup" and kinds[-1] == "end"
    assert kinds.count("result") == 3 and "complete" in kinds
    assert [e[1] for e in events if e[0] == "checkpoint"] == [
        res.checkpoint.path]
    # The default JSON and CSV loggers wrote the run's files too.
    with open(os.path.join(res.path, "result.json")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["loss"] for r in rows] == [1.0, 0.5, 1.0 / 3.0]
    with open(os.path.join(res.path, "progress.csv"), newline="") as f:
        assert [float(r["loss"]) for r in csv.DictReader(f)] == [
            1.0, 0.5, 1.0 / 3.0]


# -- the slice as a whole -----------------------------------------------------


def _tiny_jax():
    """fp32, so the comparison is of the algorithm; seq 32 is the Pallas
    kernels' tile."""
    return jtf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64,
        dtype=jnp.float32, fused_ce=True, use_flash=True)


def _port_config(jcfg):
    import dataclasses

    import torch

    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jtf.TransformerConfig)}
    kw["dtype"] = kw["param_dtype"] = torch.float32
    return ttf.TransformerConfig(**kw)


OPT = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6)
STEPS, SAVE_AT = 4, 2


def test_train_kill_and_resume_matches_reference_and_uninterrupted(
        cluster, tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    jcfg = _tiny_jax()
    jstep = jts.ShardedTrainStep(
        jcfg, build_mesh(axes={"fsdp": 1}, devices=jax.devices()[:1]),
        optimizer=jts.default_optimizer(**OPT))
    jstate = jstep.init(jax.random.key(5))
    tcfg = _port_config(jcfg)
    start = tts.state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                 device="cpu")
    batches = [np.random.default_rng(10 + i).integers(
        0, 64, (2, 33)).astype(np.int32) for i in range(STEPS)]
    want = []
    for b in batches:
        jstate, jm = jstep.step(jstate, {"tokens": jnp.asarray(b)})
        want.append((float(jm["loss"]), float(jm["grad_norm"])))

    port = PORT

    def loop(config):
        tr = importlib.import_module(f"{port}.train")
        ts_mod = importlib.import_module(f"{port}.train.train_state")
        ck_mod = importlib.import_module(f"{port}.train.checkpoint")
        ts = ts_mod.ShardedTrainStep(
            config["cfg"], device="cpu",
            optimizer=ts_mod.default_optimizer(**config["opt"]))
        ck = tr.get_checkpoint()
        if ck is None:
            state = config["state"]
        else:
            step = ck.get_metadata()["metrics"]["step"]
            state = ck_mod.load_pytree(
                os.path.join(ck.as_directory(), f"step_{step}"))
        while state["step"] < len(config["batches"]):
            n = state["step"] + 1
            if config["kill"] and ck is None and n == config["save_at"] + 1:
                os._exit(1)
            state, m = ts.step(state, {"tokens": config["batches"][n - 1]})
            metrics = {"step": n, "loss": m["loss"].item(),
                       "grad_norm": m["grad_norm"].item(),
                       "pid": os.getpid()}
            if n == config["save_at"]:
                local = tempfile.mkdtemp()
                ck_mod.save_pytree_async(state, local, step=n).wait()
                tr.report(metrics,
                          checkpoint=tr.Checkpoint.from_directory(local))
            else:
                tr.report(metrics)

    config = dict(cfg=tcfg, opt=OPT, state=start, batches=batches,
                  save_at=SAVE_AT)
    killed = _fit(loop, tmp_path, "killed", config=dict(config, kill=True),
                  max_failures=1)
    whole = _fit(loop, tmp_path, "whole", config=dict(config, kill=False))
    hk, hw = killed.metrics_history, whole.metrics_history
    assert [h["step"] for h in hk] == [h["step"] for h in hw] == [1, 2, 3, 4]
    assert len({h["pid"] for h in hk}) == 2 and len(
        {h["pid"] for h in hw}) == 1
    got = [(h["loss"], h["grad_norm"]) for h in hk]
    assert got == [(h["loss"], h["grad_norm"]) for h in hw]  # bit for bit
    for (loss, norm), (wl, wn) in zip(got, want):
        np.testing.assert_allclose(loss, wl, rtol=1e-5)
        np.testing.assert_allclose(norm, wn, rtol=1e-4)
    assert killed.checkpoint.get_metadata()["metrics"]["step"] == SAVE_AT
