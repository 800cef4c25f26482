"""ray_tpu_torch.train: distributed training library (reference:
python/ray/train).

Port of ray_tpu/train/__init__.py: the same exports less the JAX names
(JaxTrainer, JaxBackendConfig).  TorchTrainer runs a user loop on a
worker group of actors and joins them with torch.distributed
(train/torch_backend.py); `optim` and `train_state` hold the optimizer
and the one-device train step.
"""

from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    StorageContext,
    load_pytree,
    save_pytree,
    save_pytree_async,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.train_loop_utils import (
    get_mesh,
    prepare_pytree,
    shard_batch,
)
from ray_tpu_torch.train.trainer import (
    DataParallelTrainer,
    TorchTrainer,
    Result,
    TrainingFailedError,
)

__all__ = [
    "Backend", "BackendConfig",
    "Checkpoint", "StorageContext", "save_pytree", "save_pytree_async", "load_pytree",
    "ScalingConfig", "RunConfig", "FailureConfig", "CheckpointConfig",
    "TrainContext", "report", "get_checkpoint", "get_context",
    "get_dataset_shard",
    "get_mesh", "prepare_pytree", "shard_batch",
    "DataParallelTrainer", "TorchTrainer", "Result", "TrainingFailedError",
]

# Feature-usage tag (util/usage_stats.py; local-only, no egress).
from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu
_rlu("train")
del _rlu
