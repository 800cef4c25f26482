"""Train/AIR config dataclasses.

Port of ray_tpu/train/config.py: counterparts of the reference's
python/ray/air/config.py (ScalingConfig, RunConfig, FailureConfig,
CheckpointConfig).  `FailureConfig`, and `RunConfig` are copies;
`CheckpointConfig` is a copy less `checkpoint_frequency`, which nothing
read (checkpoints are the loop's own, through `train.report`).
`ScalingConfig` asks for GPUs where the JAX package asks for TPU chips:
`use_gpu` and `gpus_per_worker` in place of `use_tpu` and
`tpu_chips_per_worker`, and the resource is "GPU".  A fraction of a card
(`gpus_per_worker=0.5`) is a valid share: the runtime gives such a
worker a GPU-class process.

Departure: `use_gpu` defaults to True (the reference's `use_tpu` to
False), as the port's other entry points default to the card; a run on
the CPU asks for it with `use_gpu=False`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class ScalingConfig:
    """How many training workers and what each needs.

    num_workers: training workers (actors), one rank each.  With
    use_gpu each worker reserves gpus_per_worker of the "GPU" resource
    (the reference's worker == GPU-process model).
    """

    num_workers: int = 1
    use_gpu: bool = True  # the card by default, as device="cuda" elsewhere
    resources_per_worker: Optional[Dict[str, float]] = None
    gpus_per_worker: float = 1  # GPUs reserved per worker
    placement_strategy: str = "PACK"

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if "CPU" not in res:
            res["CPU"] = 1.0
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = float(self.gpus_per_worker)
        return res


@dataclasses.dataclass
class FailureConfig:
    """max_failures: worker-group restarts before giving up (reference
    FailureConfig air/config.py; restart logic backend_executor._restart)."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    # default: <tmpdir>/ray_tpu_torch/results (checkpoint.StorageContext)
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    # Tune stop criterion: {"metric": threshold} (stop when >=) or a
    # callable (trial_id, metrics) -> bool (reference air.RunConfig.stop).
    stop: Optional[object] = None
    # Experiment-loop callbacks (tune/callbacks.py Callback; reference
    # air.RunConfig.callbacks).  JSON/CSV loggers are added by default.
    callbacks: Optional[list] = None
