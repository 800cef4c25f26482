"""In-loop helpers: the mesh, params and batches of a train worker.

Port of ray_tpu/train/train_loop_utils.py, the JAX equivalents of
ray.train.torch.prepare_model / prepare_data_loader.  The JAX package
builds these on `parallel/` (`build_mesh`, `shard_tree`,
`data_sharding`); so does the port, on its own parallel layer:

- `get_mesh` builds the `Mesh` over the worker group's process group
  (every worker of a TorchTrainer with more than one worker is a rank);
  `dcn_axes` lay the ranks out by host, the hybrid layout;
- `prepare_pytree` puts a tree on the worker's device
  (`torch_backend.get_device`) and broadcasts it from rank 0, so every
  rank starts from the same replicated params;
- `shard_batch` keeps the rows of the rank's `data` coordinate, on the
  worker's device.

Sharding rules and logical axes raise NotImplementedError until the
sharding slice (ROADMAP Queue A item 6b).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.mesh import Mesh, build_mesh
from ray_tpu_torch.train.torch_backend import get_device


def get_mesh(axes: Optional[Dict[str, int]] = None,
             dcn_axes=()) -> Mesh:
    """Global mesh over every rank of the worker group (one rank and no
    process group: every axis 1).  With `dcn_axes`, each host is a slice
    of the hybrid layout."""
    slice_ids = None
    if dcn_axes:
        import socket

        import torch.distributed as dist

        if dist.is_initialized():
            hosts = [None] * dist.get_world_size()
            dist.all_gather_object(hosts, socket.gethostname())
            order = sorted(set(hosts), key=hosts.index)
            slice_ids = [order.index(h) for h in hosts]
    return build_mesh(axes=axes or {}, dcn_axes=dcn_axes,
                      slice_ids=slice_ids)


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def prepare_pytree(params: Any, mesh: Optional[Mesh] = None,
                   rules: Any = None, logical_axes: Any = None) -> Any:
    """`params` on the worker's device, replicated: every rank of the
    mesh gets rank 0's values (prepare_model equivalent).  Sharding
    rules and logical axes raise."""
    if rules is not None or logical_axes is not None:
        raise NotImplementedError(
            "sharding rules / logical axes: the port keeps params "
            "replicated; placement waits for the sharding slice (ROADMAP "
            "Queue A item 6b)")
    mesh = mesh if mesh is not None else get_mesh()
    out = _to_device(params, get_device())
    group = mesh.get_group()
    if group is not None:
        src = int(mesh.ranks.reshape(-1)[0])
        for t in _tensors(out):
            comm.broadcast_(t, src, group)
    return out


def shard_batch(batch: Any, mesh: Optional[Mesh] = None) -> Any:
    """This rank's rows of a host batch (the leading dim split over the
    mesh's `data` axis), on the worker's device (prepare_data_loader
    equivalent, per batch)."""
    mesh = mesh if mesh is not None else get_mesh()
    n, i = mesh.axis_size("data"), mesh.axis_index("data")

    def rows(t):
        if n == 1:
            return t
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} rows does not split "
                             f"over {n} data ranks")
        per = t.shape[0] // n
        return t[i * per:(i + 1) * per]

    def walk(tree):
        if isinstance(tree, (torch.Tensor, np.ndarray)):
            return rows(tree)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return _to_device(walk(batch), get_device())
