"""In-loop helpers: the mesh, params and batches of a train worker.

Port of ray_tpu/train/train_loop_utils.py, the JAX equivalents of
ray.train.torch.prepare_model / prepare_data_loader.  The JAX package
builds these on `parallel/` (`build_mesh`, `shard_tree`,
`data_sharding`); so does the port, on its own parallel layer:

- `get_mesh` builds the `Mesh` over the worker group's process group
  (every worker of a TorchTrainer with more than one worker is a rank);
  `dcn_axes` lay the ranks out by host, the hybrid layout;
- `prepare_pytree` puts a tree on the worker's device
  (`torch_backend.get_device`), gives every rank rank 0's values and
  keeps each rank's block of every leaf the sharding rules split
  (`shard_tree`: on a mesh with `fsdp` of one rank every leaf stays
  whole);
- `shard_batch` keeps the rows of the rank's `data` x `fsdp` coordinate
  (`data_sharding`), on the worker's device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.mesh import Mesh, build_mesh
from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES, Rules,
                                             data_sharding, shard_tree)
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
                   rules: Rules = DEFAULT_RULES,
                   logical_axes: Any = None) -> Any:
    """`params` placed by the sharding rules (prepare_model equivalent):
    on the worker's device, rank 0's values on every rank of the mesh,
    and of each leaf that `logical_axes` (inferred from the tree's names
    when None) and `rules` split, this rank's block."""
    mesh = mesh if mesh is not None else get_mesh()
    out = _to_device(params, get_device())
    group = mesh.get_group()
    if group is not None:
        src = int(mesh.ranks.reshape(-1)[0])
        for t in _tensors(out):
            comm.broadcast_(t, src, group)
    return shard_tree(out, mesh, rules, logical_axes)


def shard_batch(batch: Any, mesh: Optional[Mesh] = None) -> Any:
    """This rank's rows of a host batch (the leading dim split over the
    mesh's `data` and `fsdp` axes), on the worker's device
    (prepare_data_loader equivalent, per batch)."""
    mesh = mesh if mesh is not None else get_mesh()
    layout = data_sharding(mesh)

    def walk(tree):
        if isinstance(tree, np.ndarray):
            return layout.shard(torch.from_numpy(
                np.ascontiguousarray(tree)))
        if isinstance(tree, torch.Tensor):
            return layout.shard(tree)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return _to_device(walk(batch), get_device())
