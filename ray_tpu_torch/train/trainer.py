"""DataParallelTrainer / TorchTrainer: the Train-library driver.

Port of ray_tpu/train/trainer.py, a copy but for the backends: the JAX
package's JaxTrainer and the JAX environment it hands each worker
(`_jax_env`) are gone, and TorchTrainer (torch.distributed through
`TorchConfig`) is the port's trainer.  A run's directory is
`checkpoint.StorageContext`'s, under the port's own storage path.

Counterpart of the reference's train/data_parallel_trainer.py (:25,
training_loop :428) + train/_internal/backend_executor.py (:67; start :129
creates PG + WorkerGroup, start_training :441 wires sessions,
get_with_failure_handling :675 and _restart :736 for fault tolerance) +
train/trainer.py TrainingIterator (:31).  Collapsed into one driver class:
our worker group already runs sessions worker-side.

TorchTrainer is the reference's TorchTrainer: DataParallelTrainer with
the torch backend by default.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.checkpoint import Checkpoint, StorageContext
from ray_tpu_torch.train.config import RunConfig, ScalingConfig


class TrainingFailedError(RuntimeError):
    """Training did not complete (worker failures exceeded max_failures, or
    the training loop raised)."""


@dataclasses.dataclass
class Result:
    """Counterpart of python/ray/air/result.py Result."""

    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    @property
    def best_checkpoints(self):
        return [self.checkpoint] if self.checkpoint else []


def _shard_dataset(ds: Any, num_shards: int) -> List[Any]:
    """Split one dataset into per-worker shards.

    Datasets that have streaming_split (the data library's, ROADMAP Queue
    A items 8 and 10) use it (locality-aware iterators,
    reference dataset.py:1236); plain sequences/arrays are sliced; anything
    else is replicated.
    """
    if hasattr(ds, "streaming_split"):
        return ds.streaming_split(num_shards)
    try:
        n = len(ds)
    except TypeError:
        return [ds] * num_shards
    per = (n + num_shards - 1) // num_shards
    return [ds[i * per:(i + 1) * per] for i in range(num_shards)]


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.backend_config = backend_config or BackendConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    # ------------------------------------------------------------------
    def fit(self) -> Result:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        cfg = self.run_config
        storage = StorageContext(
            cfg.storage_path, cfg.name,
            num_to_keep=cfg.checkpoint_config.num_to_keep)
        max_failures = cfg.failure_config.max_failures
        failures = 0
        latest_ckpt = self.resume_from_checkpoint
        history: List[Dict[str, Any]] = []

        # RunConfig.callbacks reach standalone fits too (reference:
        # Train dispatches the same tune Callback surface; SURVEY L6
        # AIR-shared config).  The run is exposed to callbacks as one
        # trial-shaped handle.
        from ray_tpu_torch.tune.callbacks import default_callbacks

        callbacks = default_callbacks(getattr(cfg, "callbacks", None))
        handle = _RunHandle(
            trial_id=storage.name or "train_run",
            trial_dir=storage.run_dir,
            config=dict(self.train_loop_config),
            metrics_history=history)
        callbacks.setup(run_dir=storage.run_dir, trials=[handle])
        callbacks.on_trial_start(trial=handle)
        try:
            while True:
                try:
                    metrics = self._run_attempt(
                        storage, latest_ckpt, history,
                        callbacks=callbacks, handle=handle)
                    callbacks.on_trial_complete(trial=handle)
                    return Result(
                        metrics=metrics,
                        checkpoint=storage.latest_checkpoint(),
                        path=storage.run_dir,
                        metrics_history=history)
                except TrainingFailedError:
                    callbacks.on_trial_error(trial=handle)
                    raise
                except Exception as e:
                    failures += 1
                    if max_failures >= 0 and failures > max_failures:
                        callbacks.on_trial_error(trial=handle)
                        if isinstance(e, _UserLoopError):
                            raise TrainingFailedError(str(e)) from e
                        raise TrainingFailedError(
                            f"training failed after {failures} "
                            f"failure(s): {e}") from e
                    # restart from the latest persisted checkpoint
                    latest_ckpt = storage.latest_checkpoint() or latest_ckpt
        finally:
            callbacks.on_experiment_end(trials=[handle])

    # ------------------------------------------------------------------
    def _run_attempt(self, storage: StorageContext,
                     checkpoint: Optional[Checkpoint],
                     history: List[Dict[str, Any]],
                     callbacks=None, handle=None) -> Optional[Dict]:
        from ray_tpu_torch.train.worker_group import WorkerGroup

        sc = self.scaling_config
        group = WorkerGroup(
            sc.num_workers, sc.worker_resources(), storage.run_dir,
            placement_strategy=sc.placement_strategy,
            num_to_keep=self.run_config.checkpoint_config.num_to_keep)
        backend = self.backend_config.backend_cls()
        try:
            backend.on_start(group, self.backend_config)

            shards: Dict[int, Dict[str, Any]] = {
                i: {} for i in range(sc.num_workers)}
            for name, ds in self.datasets.items():
                for i, shard in enumerate(_shard_dataset(ds, sc.num_workers)):
                    shards[i][name] = shard

            backend.on_training_start(group, self.backend_config)
            ray_tpu_torch.get([
                w.start_training.remote(
                    self.train_loop_per_worker, self.train_loop_config,
                    checkpoint.as_directory() if checkpoint else None,
                    shards[i], storage.name)
                for i, w in enumerate(group.workers)
            ], timeout=120)

            return self._poll_results(group, history,
                                      callbacks=callbacks, handle=handle)
        finally:
            try:
                backend.on_shutdown(group, self.backend_config)
            finally:
                group.shutdown()

    def _poll_results(self, group, history,
                      callbacks=None, handle=None) -> Optional[Dict]:
        finished = set()
        last_rank0: Optional[Dict] = None
        deadline_slack = 600.0  # no single poll may hang longer than this
        while len(finished) < group.num_workers:
            pending = [i for i in range(group.num_workers)
                       if i not in finished]
            refs = {i: group.workers[i].next_result.remote(2.0)
                    for i in pending}
            for i, ref in refs.items():
                item = ray_tpu_torch.get(ref, timeout=deadline_slack)
                if item is None:
                    continue
                if item.get("finished"):
                    finished.add(i)
                    continue
                if "error" in item:
                    raise _UserLoopError(
                        f"rank {i} train loop failed:\n{item['traceback']}")
                if i == 0:
                    last_rank0 = item.get("metrics")
                    entry = dict(item.get("metrics") or {})
                    if item.get("checkpoint_path"):
                        entry["checkpoint_path"] = item["checkpoint_path"]
                        if callbacks is not None:
                            handle.last_checkpoint = \
                                item["checkpoint_path"]
                            callbacks.on_checkpoint(
                                trial=handle,
                                checkpoint_path=item["checkpoint_path"])
                    history.append(entry)
                    if callbacks is not None:
                        callbacks.on_trial_result(trial=handle,
                                                  result=entry)
            time.sleep(0.01)
        return last_rank0


@dataclasses.dataclass
class _RunHandle:
    """Trial-shaped view of a standalone train run for tune callbacks
    (same attribute surface loggers read: trial_id/trial_dir/config/
    metrics_history)."""

    trial_id: str
    trial_dir: str
    config: Dict[str, Any]
    metrics_history: List[Dict[str, Any]]
    last_checkpoint: Optional[str] = None


class _UserLoopError(RuntimeError):
    """Training-loop exception (as opposed to infrastructure failure)."""


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer with the torch.distributed backend, gloo by
    default (reference python/ray/train/torch/torch_trainer.py). Worker
    loops use train.torch_backend.get_device / prepare_model /
    prepare_data_loader."""

    def __init__(self, train_loop_per_worker, *, backend_config=None,
                 **kw):
        from ray_tpu_torch.train.torch_backend import TorchConfig

        super().__init__(
            train_loop_per_worker,
            backend_config=backend_config or TorchConfig(), **kw)
