"""Training backends: per-worker runtime setup before the user loop runs.

Port of ray_tpu/train/backend.py: the reference's train/backend.py
`Backend` ABC (:32, on_start/on_training_start/on_shutdown) and
`_free_port`.  The JAX package's `JaxBackendConfig` / `JaxBackend` have
no counterpart here: they run `jax.distributed.initialize` across the
workers, and in the port `torch.distributed` takes that role
(`train/torch_backend.py`, `TorchConfig`, the default backend of
`TorchTrainer`).
"""

from __future__ import annotations

import dataclasses
import socket


@dataclasses.dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    def on_start(self, worker_group, backend_config: BackendConfig):
        pass

    def on_training_start(self, worker_group, backend_config: BackendConfig):
        pass

    def on_shutdown(self, worker_group, backend_config: BackendConfig):
        pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
