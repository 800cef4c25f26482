"""Torch backend: torch.distributed process groups over the worker group.

Port of ray_tpu/train/torch_backend.py, the counterpart of the
reference's Train Torch backend (python/ray/train/torch/config.py:150 —
TCP-store rendezvous from the rank-0 address :65,
`dist.init_process_group`) and the worker loop utilities
(torch/train_loop_utils.py:158 prepare_model / :200
prepare_data_loader).  In the port `torch.distributed` is what the JAX
package's `jax.distributed` backend was, so `TorchConfig` is
`TorchTrainer`'s default.  Departures from the copy, each commented:
`get_device` (the worker's device: cuda:0 in a GPU-class worker),
`prepare_model` moving the model there and giving DDP its `device_ids`
on CUDA, and an NCCL rank binding its card before the rendezvous.
`backend="gloo"` stays the default; "nccl" is accepted and needs a card
per rank (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ray_tpu_torch.train.backend import Backend, BackendConfig, _free_port


@dataclass
class TorchConfig(BackendConfig):
    """backend: torch.distributed backend name ("gloo", or "nccl" with a
    card per rank); init_timeout_s: process-group rendezvous timeout."""

    backend: str = "gloo"
    init_timeout_s: float = 120.0

    @property
    def backend_cls(self):
        return TorchBackend


def _setup_torch_process_group(master_addr: str, master_port: int,
                               rank: int, world_size: int, backend: str,
                               timeout_s: float) -> Dict[str, int]:
    """Runs ON each train worker (reference torch/config.py:65)."""
    import datetime
    import os

    import torch.distributed as dist

    os.environ["MASTER_ADDR"] = master_addr
    os.environ["MASTER_PORT"] = str(master_port)
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    if backend == "nccl":
        # Departure: NCCL binds each rank to the current card.
        import torch

        torch.cuda.set_device(get_device())
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{master_addr}:{master_port}",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size()}


def _shutdown_torch_process_group() -> bool:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


class TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig):
        import ray_tpu_torch

        n = worker_group.num_workers
        if n <= 1:
            return  # single worker: no process group needed
        port = _free_port()
        refs = [
            w.run.remote(
                _setup_torch_process_group, "127.0.0.1", port, i, n,
                backend_config.backend, backend_config.init_timeout_s)
            for i, w in enumerate(worker_group.workers)
        ]
        infos = ray_tpu_torch.get(refs,
                            timeout=backend_config.init_timeout_s + 30)
        for info in infos:
            if info["world_size"] != n:
                raise RuntimeError(
                    f"torch process group world size mismatch: {infos}")

    def on_shutdown(self, worker_group, backend_config: TorchConfig):
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(
                [w.run.remote(_shutdown_torch_process_group)
                 for w in worker_group.workers], timeout=30)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Worker-loop utilities (reference torch/train_loop_utils.py)
# ---------------------------------------------------------------------------

def get_device():
    """The worker's device (the reference's ray.train.torch.get_device):
    cuda:0 in a GPU-class worker, the CPU otherwise.  A GPU-class worker
    sees the node's cards and takes the first (card visibility per lease
    is ROADMAP Queue A item 6e; a one-card node is exact)."""
    import torch

    from ray_tpu_torch.core.api import get_gpu_ids

    if get_gpu_ids() and torch.cuda.is_available():
        return torch.device("cuda", 0)
    return torch.device("cpu")


def prepare_model(model):
    """Move the model to the worker's device and wrap it in DDP when a
    process group is active (reference prepare_model :158).  Departure
    from the JAX package's copy, which moves nothing: on CUDA the model
    goes to get_device() and DDP gets device_ids=[that card]."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    device = get_device()
    model = model.to(device)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        if device.type == "cuda":
            return DistributedDataParallel(model, device_ids=[device.index])
        return DistributedDataParallel(model)
    return model


class _EpochedLoader:
    """DataLoader wrapper that advances the DistributedSampler epoch on
    every full iteration (the reference's _WrappedDataLoader role) so
    shuffling reshuffles per epoch instead of repeating one permutation."""

    def __init__(self, loader, sampler):
        self._loader = loader
        self._sampler = sampler
        self._epoch = 0

    def __iter__(self):
        self._sampler.set_epoch(self._epoch)
        self._epoch += 1
        return iter(self._loader)

    def __len__(self):
        return len(self._loader)

    def __getattr__(self, name):
        return getattr(self._loader, name)


def prepare_data_loader(data_loader):
    """Re-create the loader with a DistributedSampler so each rank sees
    its shard (reference prepare_data_loader :200). Preserves the
    loader's shuffle setting and reshuffles per epoch."""
    import torch.distributed as dist
    from torch.utils.data import (
        DataLoader,
        DistributedSampler,
        RandomSampler,
    )

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return data_loader
    shuffled = isinstance(data_loader.sampler, RandomSampler)
    sampler = DistributedSampler(data_loader.dataset, shuffle=shuffled)
    loader = DataLoader(
        data_loader.dataset,
        batch_size=data_loader.batch_size,
        sampler=sampler,
        num_workers=0,
        collate_fn=data_loader.collate_fn,
        drop_last=data_loader.drop_last)
    return _EpochedLoader(loader, sampler)
