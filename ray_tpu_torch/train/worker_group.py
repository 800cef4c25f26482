"""Copy of ray_tpu/train/worker_group.py, less its XLA_FLAGS merge.

Training worker group: N actors in a placement group.

Counterpart of the reference's train/_internal/worker_group.py (`WorkerGroup`
:102 — plain Ray actors; execute/execute_async :260/:233) plus the worker-side
half of backend_executor.start_training (:441): each worker hosts a
`_TrainSession` and runs the user loop in a daemon thread, surfacing results
through a polled queue.

The JAX package's TrainWorker merges an XLA_FLAGS entry of `env` into the
worker's own flags; here every entry of `env` is set as given.  Which
cards a worker sees is the runtime's business (a GPU-class worker sees
the node's; per-lease visibility is ROADMAP Queue A item 6e).

Departure: `train.report` returns only once the driver holds the result.
In the JAX package it returns when the result is queued, so a worker
that dies just after reporting (a hard kill, a lost node) can take its
last metrics row with it.  Here the result counts as taken when the
driver asks for the next one (`next_result`), which it does only after
the previous reply reached it; the reference's Ray Train blocks its
report the same way, until the driver's next fetch.  The methods that
nothing called (`execute`, `execute_single`, `node_info`,
`TrainWorker.shutdown`) are not carried over.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint, StorageContext
from ray_tpu_torch.train import session as _session_mod
from ray_tpu_torch.train.session import TrainContext, _TrainSession


class TrainWorker:
    """Actor hosting one training process (rank)."""

    def __init__(self, rank: int, world_size: int, run_dir: str,
                 env: Optional[Dict[str, str]] = None,
                 num_to_keep: Optional[int] = None):
        self.rank = rank
        self.world_size = world_size
        self.run_dir = run_dir
        self.num_to_keep = num_to_keep
        self.session: Optional[_TrainSession] = None
        self.thread: Optional[threading.Thread] = None
        # Released by next_result once the driver holds the result that
        # report() queued (the departure in the module docstring).
        self._taken = threading.Semaphore(0)
        self._handed_out = False
        os.environ.update(env or {})

    # -- generic execution (backends run setup through it) ------------------
    def run(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    # -- training lifecycle -------------------------------------------------
    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       checkpoint_path: Optional[str],
                       dataset_shards: Optional[Dict[str, Any]],
                       experiment_name: str) -> bool:
        ckpt = Checkpoint(checkpoint_path) if checkpoint_path else None
        ctx = TrainContext(
            world_size=self.world_size, world_rank=self.rank,
            local_rank=self.rank, node_rank=self.rank,
            experiment_name=experiment_name)
        self.session = _TrainSession(ctx, ckpt, dataset_shards)
        _session_mod._set_session(self.session)
        storage = StorageContext(
            os.path.dirname(self.run_dir), os.path.basename(self.run_dir),
            num_to_keep=self.num_to_keep)

        def runner():
            s = self.session
            try:
                if _takes_config(train_fn):
                    train_fn(config)
                else:
                    train_fn()
            except BaseException as e:  # noqa: BLE001 — surfaced to driver
                s.error = e
                s.result_queue.put({
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc(),
                })
            finally:
                s.finished.set()

        # Persist checkpoints worker-side (rank 0), reference
        # storage.py:508 persist_current_checkpoint runs on the worker.
        orig_report = self.session.report

        def reporting(metrics, checkpoint=None):
            if checkpoint is not None and self.rank == 0:
                persisted = storage.persist_checkpoint(
                    checkpoint.as_directory(), metrics)
                checkpoint = persisted
            orig_report(metrics, checkpoint)
            self._taken.acquire()  # until the driver holds it

        self.session.report = reporting
        self.thread = threading.Thread(target=runner, daemon=True)
        self.thread.start()
        return True

    def next_result(self, timeout: float = 1.0) -> Optional[Dict[str, Any]]:
        """One queued result, {'finished': True} at end, None if no news."""
        import queue as _q

        s = self.session
        if s is None:
            return None
        if self._handed_out:
            # The driver asks again only once it holds the last reply.
            self._handed_out = False
            self._taken.release()
        try:
            item = s.result_queue.get(timeout=timeout)
        except _q.Empty:
            if s.finished.is_set() and s.result_queue.empty():
                return {"finished": True}
            return None
        if "error" not in item:
            self._handed_out = True
        if item.get("checkpoint") is not None:
            item["checkpoint_path"] = item.pop("checkpoint").as_directory()
        return item


def _takes_config(fn: Callable) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    positional = [p for p in sig.parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                                p.VAR_POSITIONAL)]
    # Keyword-only / **kwargs-only loops take no config positionally.
    return len(positional) >= 1


class WorkerGroup:
    """N TrainWorker actors, optionally inside a placement group."""

    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 run_dir: str, placement_strategy: str = "PACK",
                 env: Optional[Dict[str, str]] = None,
                 num_to_keep: Optional[int] = None):
        from ray_tpu_torch.util.placement_group import (
            placement_group,
            remove_placement_group,
        )
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
        )

        self.num_workers = num_workers
        self._pg = placement_group(
            [dict(resources_per_worker) for _ in range(num_workers)],
            strategy=placement_strategy)
        if not self._pg.wait(timeout_seconds=60):
            remove_placement_group(self._pg)
            raise RuntimeError(
                f"placement group for {num_workers} train workers "
                f"({resources_per_worker}/worker) not schedulable")
        cls = ray_tpu_torch.remote(TrainWorker)
        self.workers: List = [
            cls.options(
                resources=dict(resources_per_worker),
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self._pg, placement_group_bundle_index=i),
            ).remote(i, num_workers, run_dir, env, num_to_keep)
            for i in range(num_workers)
        ]

    def shutdown(self):
        from ray_tpu_torch.util.placement_group import remove_placement_group

        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        try:
            remove_placement_group(self._pg)
        except Exception:
            pass
        self.workers = []
