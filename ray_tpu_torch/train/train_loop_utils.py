"""In-loop helpers for a one-device mesh.

Port of ray_tpu/train/train_loop_utils.py.  The JAX package builds these
on `parallel/` (`build_mesh`, `shard_tree`, `data_sharding`): the global
mesh over every worker's devices, params placed with their GSPMD
shardings, each host batch split over the data axes.  The port trains on
one device per worker so far (`train_state.ShardedTrainStep`), so here:

- `get_mesh` returns the axes dict that `ShardedTrainStep(mesh=...)`
  takes, every axis of size 1;
- `prepare_pytree` and `shard_batch` move a tree or a batch (tensors and
  numpy arrays) to the worker's device (`torch_backend.get_device`).

A mesh of more than one device, a pipeline axis, DCN axes or sharding
rules raise NotImplementedError until the parallelism slice (ROADMAP
Queue A item 6).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.train.torch_backend import get_device

# The JAX package's mesh axes and their aliases (parallel/mesh.py).
_AXIS_ALIASES = {
    "dp": "data", "data": "data", "fsdp": "fsdp", "zero": "fsdp",
    "sp": "seq", "cp": "seq", "seq": "seq", "context": "seq",
    "tp": "tensor", "mp": "tensor", "model": "tensor", "tensor": "tensor",
    "ep": "expert", "expert": "expert",
    "pp": "stage", "pipeline": "stage", "stage": "stage",
}


def _item6(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the port trains on one device per worker; meshes of more "
        "than one device wait for the parallelism slice (ROADMAP Queue A "
        "item 6)")


def get_mesh(axes: Optional[Dict[str, int]] = None,
             dcn_axes=()) -> Dict[str, int]:
    """The one-device mesh as ShardedTrainStep's axes dict: the named
    axes (aliases resolved; -1, "all devices", is 1 here), and "data"
    of size 1 when no axis is named, as the JAX package's default mesh
    puts every device on "data"."""
    if dcn_axes:
        raise _item6(f"dcn_axes {tuple(dcn_axes)}")
    sizes: Dict[str, int] = {}
    for name, size in (axes or {"data": -1}).items():
        axis = _AXIS_ALIASES.get(name.lower())
        if axis is None:
            raise ValueError(f"unknown mesh axis {name!r}; expected one of "
                             f"{sorted(_AXIS_ALIASES)}")
        sizes[axis] = 1 if size == -1 else int(size)
    if math.prod(sizes.values()) != 1 or "stage" in sizes:
        raise _item6(f"mesh {sizes}")
    return sizes


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


def prepare_pytree(params: Any, mesh: Optional[Dict[str, int]] = None,
                   rules: Any = None, logical_axes: Any = None) -> Any:
    """`params` on the worker's device (prepare_model equivalent).
    `mesh` must be a one-device mesh; sharding rules raise."""
    if rules is not None or logical_axes is not None:
        raise _item6("sharding rules / logical axes")
    get_mesh(mesh)
    return _to_device(params, get_device())


def shard_batch(batch: Any, mesh: Optional[Dict[str, int]] = None) -> Any:
    """A host batch on the worker's device (prepare_data_loader
    equivalent, per batch): the whole batch, the one device's shard."""
    get_mesh(mesh)
    return _to_device(batch, get_device())
