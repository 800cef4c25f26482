"""Device meshes over torch.distributed ranks.

Port of ray_tpu/parallel/mesh.py.  The reference lays JAX devices out on
a named `jax.sharding.Mesh` and lets XLA compile the collectives; here a
mesh is a layout of the default process group's ranks (one rank, one
device) on the same named axes, wrapping a
`torch.distributed.device_mesh.DeviceMesh` whose dims are `AXIS_ORDER`,
size-1 axes included, so every axis has its process group.

Axis convention (order matters: outermost = slowest-varying = DCN-friendly):
  data   - data parallel (gradient all-reduce)
  stage  - pipeline stages
  fsdp   - fully-sharded data parallel (param/optimizer shard axis)
  seq    - sequence/context parallel (ring attention's P2P axis)
  tensor - tensor/model parallel
  expert - expert parallel (MoE all_to_all axis)

`build_mesh` returns a `Mesh`; `with mesh:` makes it the ambient mesh
that the model reads (`current_mesh`), as `with mesh:` does for the
reference.  One process without a process group is a mesh with every
axis 1 and no DeviceMesh.  The hybrid DCN layout is computed on rank
numbers where the reference orders device objects.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

AXIS_ORDER: Tuple[str, ...] = (
    "data", "stage", "fsdp", "seq", "tensor", "expert")

# Short aliases accepted in user-facing configs.
_AXIS_ALIASES = {
    "dp": "data",
    "data": "data",
    "fsdp": "fsdp",
    "zero": "fsdp",
    "sp": "seq",
    "cp": "seq",
    "seq": "seq",
    "context": "seq",
    "tp": "tensor",
    "mp": "tensor",
    "model": "tensor",
    "tensor": "tensor",
    "ep": "expert",
    "expert": "expert",
    "pp": "stage",
    "pipeline": "stage",
    "stage": "stage",
}


def canonical_axis(name: str) -> str:
    try:
        return _AXIS_ALIASES[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown mesh axis {name!r}; expected one of {sorted(_AXIS_ALIASES)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape.  ``-1`` on at most one axis means "use all
    remaining ranks" (like a reshape wildcard).

    dcn_axes: axes whose communication crosses hosts (DCN) in a
    multi-host deployment; they are laid out outermost so the
    high-traffic axes (tensor/seq) stay within a host.
    """

    data: int = -1
    stage: int = 1
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1
    expert: int = 1
    dcn_axes: Tuple[str, ...] = ()

    @classmethod
    def from_dict(cls, axes: Dict[str, int],
                  dcn_axes: Sequence[str] = ()) -> "MeshConfig":
        out = {a: 1 for a in AXIS_ORDER}
        out["data"] = 1
        wildcard = None
        for k, v in axes.items():
            ck = canonical_axis(k)
            if v == -1:
                wildcard = ck
            out[ck] = v
        if wildcard is None and "data" not in {canonical_axis(k) for k in axes}:
            out["data"] = -1
        return cls(dcn_axes=tuple(canonical_axis(a) for a in dcn_axes), **out)

    def sizes(self, n_devices: int) -> Dict[str, int]:
        fixed = {a: getattr(self, a) for a in AXIS_ORDER}
        wild = [a for a, v in fixed.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one wildcard (-1) axis, got {wild}")
        known = math.prod(v for v in fixed.values() if v != -1)
        if wild:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product "
                    f"{known} ({fixed})")
            fixed[wild[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(
                f"mesh {fixed} needs {known} devices, have {n_devices}")
        return fixed


_ambient = threading.local()

# The axes of more than one rank that place params apart, and the slice
# that ports each (ROADMAP.md, Queue A).  fsdp is ported
# (parallel/sharding.py); data and seq replicate params.
_LATER = {
    "tensor": "the sharding slice's tensor parallelism (ROADMAP Queue A "
              "item 6b, tensor parallelism)",
    "stage": "the pipeline slice (ROADMAP Queue A item 6c)",
    "expert": "the expert-parallel slice (ROADMAP Queue A item 6d)",
}


def require_replicated(shape: Dict[str, int], named: Sequence[str] = ()
                       ) -> None:
    """Raise NotImplementedError for what places params apart beyond
    this slice on a mesh of this shape (axis -> size): tensor, expert or
    stage of more than one rank, or a `stage` axis among the `named`
    ones.  data, seq and fsdp pass."""
    named = {canonical_axis(a) for a in named}
    for axis, later in _LATER.items():
        n = shape.get(axis, 1)
        if n > 1 or (axis == "stage" and axis in named):
            raise NotImplementedError(
                f"mesh axis {axis!r} of {n}: the port shards params over "
                f"fsdp and replicates them over data and seq; {axis} "
                f"waits for {later}")


def current_mesh() -> Optional["Mesh"]:
    """The innermost mesh entered with `with mesh:` on this thread."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None


class Mesh:
    """Ranks of the default process group on the named axes.

    `ranks` is the rank array, shape `tuple(shape.values())` in
    AXIS_ORDER; `device_mesh` the DeviceMesh over it (None for one
    process without a process group).  `rotations` counts the ring
    attention's K/V rotations over this mesh in this process (calls,
    bytes sent, host seconds), for measurement."""

    axis_names: Tuple[str, ...] = AXIS_ORDER

    def __init__(self, sizes: Dict[str, int], ranks: np.ndarray,
                 rank: int = 0, device_mesh=None):
        self.shape: Dict[str, int] = {a: int(sizes[a]) for a in AXIS_ORDER}
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(
            tuple(self.shape.values()))
        self.rank = rank
        self.device_mesh = device_mesh
        self.rotations = {"calls": 0, "bytes": 0, "seconds": 0.0}
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not once in the mesh")
        self._coord = dict(zip(AXIS_ORDER, (int(i) for i in where[0])))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, axis: str) -> int:
        return self.shape[canonical_axis(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return self._coord[canonical_axis(axis)]

    def axis_ranks(self, axis: str) -> List[int]:
        """The ranks on `axis` through this rank's coordinate, in axis
        order (a group's own rank order is sorted by rank, which a
        hybrid layout may not follow)."""
        a = canonical_axis(axis)
        idx = tuple(slice(None) if b == a else self._coord[b]
                    for b in AXIS_ORDER)
        return [int(r) for r in self.ranks[idx]]

    def get_group(self, axis: Optional[str] = None):
        """The process group of `axis` through this rank, or of the whole
        mesh with axis=None; None for one process."""
        if self.device_mesh is None:
            return None
        import torch.distributed as dist

        if axis is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(canonical_axis(axis))

    def __enter__(self) -> "Mesh":
        stack = getattr(_ambient, "stack", None)
        if stack is None:
            stack = _ambient.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ambient.stack.pop()

    def __repr__(self) -> str:
        axes = {a: n for a, n in self.shape.items() if n > 1} or {"data": 1}
        return f"Mesh({axes}, rank={self.rank})"


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def build_mesh(config: Optional[MeshConfig] = None,
               devices: Optional[Sequence[int]] = None,
               axes: Optional[Dict[str, int]] = None,
               dcn_axes: Sequence[str] = (),
               n_slices: Optional[int] = None,
               slice_ids: Optional[Sequence[int]] = None) -> Mesh:
    """A `Mesh` over the default process group's ranks (or `devices`, a
    list of ranks).

    With `dcn_axes` and more than one slice the layout is the hybrid one:
    dcn axes iterate across slices (outermost), every other axis stays
    within a slice.  Slices come from `slice_ids` (one per rank, e.g. a
    host index) or, as in the reference, `n_slices` contiguous groups of
    the rank list."""
    if config is None:
        config = MeshConfig.from_dict(axes or {}, dcn_axes=dcn_axes)
    rank, world = _world()
    ranks = list(devices) if devices is not None else list(range(world))
    sizes = config.sizes(len(ranks))
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    groups = _slices(ranks, slice_ids, n_slices)
    if config.dcn_axes and len(groups) > 1:
        arr = _hybrid_device_mesh(sizes, config.dcn_axes, groups)
    else:
        arr = np.asarray(ranks).reshape(shape)
    device_mesh = None
    if world > 1:
        device_mesh = _device_mesh(arr)
    return Mesh(sizes, arr, rank=rank, device_mesh=device_mesh)


def one_process_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The mesh of this process alone, every axis 1, whatever process
    group it belongs to; `axes` naming more than one device raises."""
    sizes = MeshConfig.from_dict(axes or {}).sizes(1)
    return Mesh(sizes, np.zeros(tuple(sizes.values()), dtype=np.int64))


def _slices(ranks: List[int], slice_ids, n_slices) -> List[List[int]]:
    if slice_ids is not None:
        ids = sorted(set(slice_ids))
        return [[r for r, s in zip(ranks, slice_ids) if s == i]
                for i in ids]
    if (n_slices or 1) > 1:
        per = len(ranks) // n_slices
        return [ranks[i * per:(i + 1) * per] for i in range(n_slices)]
    return [ranks]


def _device_mesh(arr: np.ndarray):
    """The DeviceMesh over `arr`.  Its device type names the default
    group's backend ("cuda" for NCCL, "cpu" for gloo): the port's
    collectives pick their transport from the backend
    (parallel/comm.py), and no DTensor is placed on it yet."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.as_tensor(arr),
                      mesh_dim_names=AXIS_ORDER)


def _hybrid_device_mesh(sizes: Dict[str, int], dcn_axes: Tuple[str, ...],
                        groups: Sequence[Sequence[int]]) -> np.ndarray:
    """Assemble the hybrid layout: per-slice meshes, stacked so each dcn
    coordinate addresses one slice group."""
    dcn_sizes = [sizes[a] for a in AXIS_ORDER if a in dcn_axes]
    n_groups = math.prod(dcn_sizes) if dcn_sizes else 1
    if n_groups != len(groups):
        raise ValueError(
            f"dcn axes {dcn_axes} require {n_groups} slices, have "
            f"{len(groups)}")
    group_size = len(groups[0])
    if any(len(g) != group_size for g in groups):
        raise ValueError("slices must be equally sized for a hybrid mesh")
    ici_shape = tuple(
        1 if a in dcn_axes else sizes[a] for a in AXIS_ORDER)
    if math.prod(ici_shape) != group_size:
        raise ValueError(
            f"ICI shape {ici_shape} does not cover a {group_size}-device "
            "slice")
    ici_arrays = [np.asarray(list(g)).reshape(ici_shape) for g in groups]
    # (G, *ici_shape) -> (*dcn_sizes, *ici_shape) -> interleave each dcn
    # dim just before its axis's (size-1) ICI dim -> collapse pairwise.
    full = np.stack(ici_arrays).reshape(*dcn_sizes, *ici_shape)
    perm = []
    dcn_order = [a for a in AXIS_ORDER if a in dcn_axes]
    for j, a in enumerate(AXIS_ORDER):
        if a in dcn_axes:
            perm.append(dcn_order.index(a))
        perm.append(len(dcn_order) + j)
    final_shape = tuple(sizes[a] for a in AXIS_ORDER)
    return full.transpose(perm).reshape(final_shape)


def single_axis_mesh(axis: str = "data",
                     devices: Optional[Sequence[int]] = None) -> Mesh:
    """All ranks on one named axis — the pmap-style DP mesh."""
    n = len(devices) if devices is not None else _world()[1]
    return build_mesh(axes={axis: n}, devices=devices)


def mesh_shape(mesh: Mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def local_mesh_info(mesh: Mesh) -> Dict[str, object]:
    """Describe this rank's place in the mesh (for logs / state API)."""
    import torch

    return {
        "axis_names": list(mesh.axis_names),
        "shape": mesh_shape(mesh),
        "n_devices": mesh.size,
        "process_index": mesh.rank,
        "local_devices": [f"cuda:{i}" for i in range(
            torch.cuda.device_count())] if torch.cuda.is_available()
        else ["cpu"],
    }
