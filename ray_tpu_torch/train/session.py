"""Copy of ray_tpu/train/session.py.

Per-worker train session: report / get_checkpoint / get_dataset_shard.

Counterpart of the reference's train/_internal/session.py `_TrainSession`
(:110 — report() :402 queues results to the driver, get_dataset_shard :477)
and the module-level `ray.train.report/get_context` API.  The user training
loop runs in a daemon thread inside the train-worker actor; `report()` hands
(metrics, checkpoint) to the actor's result queue with maxsize-1
backpressure, exactly the reference's result-queue flow (trainer.py:31
TrainingIterator pulls).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, Iterable, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_session_lock = threading.Lock()
_session: Optional["_TrainSession"] = None


@dataclasses.dataclass
class TrainContext:
    world_size: int
    world_rank: int
    local_rank: int
    node_rank: int
    experiment_name: str = ""

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name


class _TrainSession:
    def __init__(self, context: TrainContext,
                 checkpoint: Optional[Checkpoint],
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self.context = context
        self.loaded_checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        # maxsize=1: the loop blocks in report() until the driver consumed
        # the previous result — keeps driver and workers in lockstep.
        self.result_queue: "queue.Queue" = queue.Queue(maxsize=1)
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        self._last_report_t: Optional[float] = None

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        self._note_device_step(metrics)
        self.result_queue.put({"metrics": dict(metrics),
                               "checkpoint": checkpoint})

    def _note_device_step(self, metrics: Dict[str, Any]) -> None:
        """Device-plane step hook (same accounting the serve engine's
        step sampler does): when the loop reports modeled per-step
        work — "step_flops" and/or "step_bytes", or a ready-made
        "tokens_per_sec" with "flops_per_token" — fold it into the
        continuous roofline/MFU gauges tagged plane="train".  Loops
        that report neither pay one dict lookup."""
        now = time.time()
        prev, self._last_report_t = self._last_report_t, now
        flops = metrics.get("step_flops")
        nbytes = metrics.get("step_bytes")
        tok_s = metrics.get("tokens_per_sec")
        if flops is None and nbytes is None and tok_s is None:
            return
        try:
            from ray_tpu_torch.util import device_stats, tracing

            if tok_s is not None:
                frac, mfu = device_stats.note_step(
                    tokens_per_s=float(tok_s),
                    bytes_per_token=float(
                        metrics.get("bytes_per_token", 0.0)),
                    flops_per_token=float(
                        metrics.get("flops_per_token", 0.0)),
                    plane="train")
            elif prev is not None and now > prev:
                # One report == one step: per-"token" terms collapse to
                # per-step terms at 1/dt steps per second.
                frac, mfu = device_stats.note_step(
                    tokens_per_s=1.0 / (now - prev),
                    bytes_per_token=float(nbytes or 0.0),
                    flops_per_token=float(flops or 0.0),
                    plane="train")
            else:
                return
            if prev is not None and now > prev:
                tracing.record_span(
                    "device.step", prev, now,
                    attributes={"plane": "train",
                                "roofline_fraction": round(frac, 5),
                                "mfu": round(mfu, 5)})
        except Exception:  # raylint: allow-swallow(telemetry must never fail a train step report)
            pass


def _set_session(s: Optional[_TrainSession]):
    global _session
    with _session_lock:
        _session = s


def _get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "No train session active: ray_tpu_torch.train.report()/"
            "get_context() may only be called inside a training loop run "
            "by a Trainer.")
    return _session


# -- public module-level API (ray.train.* parity) ---------------------------

def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    _get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _get_session().loaded_checkpoint


def get_context() -> TrainContext:
    return _get_session().context


def get_dataset_shard(name: str = "train"):
    shard = _get_session().dataset_shards.get(name)
    if shard is None:
        raise KeyError(
            f"no dataset shard {name!r}; pass datasets={{{name!r}: ds}} to "
            f"the Trainer")
    return shard
