"""Logical-axis sharding rules: parameter and batch placement on a mesh.

Port of ray_tpu/parallel/sharding.py.  Arrays carry *logical* axis names
("batch", "embed", "heads", ...), and a rule table maps logical names to
mesh axes ("data", "fsdp", "tensor", ...).  The reference hands the
resulting NamedShardings to jit and GSPMD places the arrays and compiles
the collectives.  Here a `NamedSharding` is a layout on the port's
`Mesh` (parallel/mesh.py): `shard` keeps this rank's block of a whole
tensor, `gather` rebuilds the whole from the blocks and `reduce_scatter`
sums whole tensors over the ranks and keeps this rank's block, the last
two through parallel/comm.py's collectives and their transports.

A dim split over mesh axes is cut into equal blocks, one per coordinate
on those axes, the first axis outermost (JAX's order); a dim that does
not divide raises.  `gather` and `reduce_scatter` may walk chosen axes
only (the train step gathers over `fsdp` and keeps the `tensor` blocks
the model computes on).  Layouts on a mesh whose `expert` or `stage`
axis has more than one rank, or whose `tensor` and `seq` axes both do,
raise NotImplementedError naming their ROADMAP item (parallel/mesh.py
`require_placeable`): the port places over `fsdp`, `tensor` and `data`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.mesh import Mesh, require_placeable

Rules = Sequence[Tuple[str, Union[str, Tuple[str, ...], None]]]

# Default rule table for transformer training: FSDP over params' embed axis,
# tensor parallel over heads/mlp, sequence parallel over tokens, expert
# parallel over the expert axis.
DEFAULT_RULES: Rules = (
    ("batch", ("data", "fsdp")),
    ("seq", "seq"),
    ("embed", "fsdp"),
    ("heads", "tensor"),
    ("kv", None),
    ("head_dim", None),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("expert", "expert"),
    # Layer dim shards over the stage axis: with stage>1 each device
    # holds its pipeline stage's contiguous run of layers at rest.
    # Size-1 stage axes make this a no-op.
    ("layers", "stage"),
)


class PartitionSpec(tuple):
    """One entry per dim: a mesh axis name, a tuple of them, or None
    (replicated), as jax.sharding.PartitionSpec holds them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def spec_from_logical(logical_axes: Sequence[Optional[str]],
                      rules: Rules = DEFAULT_RULES,
                      mesh: Optional[Mesh] = None) -> PartitionSpec:
    """Map logical axis names to a `PartitionSpec` via the rule table.

    A mesh axis is used at most once per spec (first logical axis wins),
    matching GSPMD's constraint that a mesh axis shards one array dim.
    Axes whose mesh axis does not exist in `mesh` (or maps to None) are
    replicated.
    """
    table = dict(rules)
    mesh_axes = set(mesh.axis_names) if mesh is not None else None
    used: set = set()
    out: List[Union[str, Tuple[str, ...], None]] = []
    for name in logical_axes:
        if name is None:
            out.append(None)
            continue
        target = table.get(name)
        if target is None:
            out.append(None)
            continue
        targets = target if isinstance(target, tuple) else (target,)
        picked = tuple(
            t for t in targets
            if t not in used and (mesh_axes is None or t in mesh_axes))
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(picked)
    return PartitionSpec(*out)


class NamedSharding:
    """The layout of a tensor on `mesh`: dim i split over the mesh axes
    `spec[i]` names (missing trailing entries: replicated)."""

    def __init__(self, mesh: Mesh, spec: Sequence[Any]):
        require_placeable(mesh.shape)
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def dim_axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes of more than one rank that split `dim`, outermost
        first."""
        if dim >= len(self.spec) or self.spec[dim] is None:
            return ()
        part = self.spec[dim]
        axes = part if isinstance(part, tuple) else (part,)
        return tuple(a for a in axes if self.mesh.shape[a] > 1)

    def split_dims(self, ndim: int) -> Dict[int, Tuple[str, ...]]:
        """{dim: its axes} for the dims of an `ndim` tensor this layout
        splits."""
        out = {d: self.dim_axes(d) for d in range(ndim)}
        return {d: axes for d, axes in out.items() if axes}

    @property
    def is_fully_replicated(self) -> bool:
        return not self.split_dims(len(self.spec))

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one rank's block of a tensor of `shape`."""
        out = list(shape)
        for d, axes in self.split_dims(len(shape)).items():
            n = math.prod(self.mesh.shape[a] for a in axes)
            if out[d] % n:
                raise ValueError(
                    f"dim {d} of size {out[d]} does not split over "
                    f"{n} ranks of mesh axes {axes}")
            out[d] //= n
        return tuple(out)

    def _block(self, axes: Tuple[str, ...]) -> int:
        """This rank's block index on a dim split over `axes`."""
        idx = 0
        for a in axes:
            idx = idx * self.mesh.shape[a] + self.mesh.axis_index(a)
        return idx

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor `t`, a tensor of its own
        (so the whole can be freed); `t` itself when nothing splits."""
        split = self.split_dims(t.dim())
        if not split:
            return t
        size = self.shard_shape(t.shape)
        out = t
        for d, axes in split.items():
            out = out.narrow(d, self._block(axes) * size[d], size[d])
        return out.clone(memory_format=torch.contiguous_format)

    def _walk(self, ndim: int, axes: Optional[Sequence[str]]):
        """(dim, its split axes among `axes`) for each split dim; None:
        every split axis.  A dim split over a chosen axis inside one that
        is not raises: its partial gather would be no contiguous block."""
        for d, split in self.split_dims(ndim).items():
            chosen = split if axes is None else tuple(
                a for a in split if a in axes)
            if chosen and chosen != split[len(split) - len(chosen):]:
                raise ValueError(
                    f"dim {d} is split over {split}: gathering over "
                    f"{chosen} alone leaves no contiguous block")
            if chosen:
                yield d, chosen

    def gather(self, t: torch.Tensor,
               axes: Optional[Sequence[str]] = None) -> torch.Tensor:
        """The whole tensor from this rank's block `t` (an all-gather over
        each split dim's axes, innermost first); with `axes`, over those
        axes only: the block of the layout without them."""
        for d, split in self._walk(t.dim(), axes):
            for a in reversed(split):
                t = comm.all_gather(t, self.mesh.axis_ranks(a),
                                    self.mesh.get_group(a), d)
        return t

    def reduce_scatter(self, t: torch.Tensor,
                       axes: Optional[Sequence[str]] = None
                       ) -> torch.Tensor:
        """This rank's block of the sum over the split dims' axes of the
        whole tensors `t` (a reduce-scatter per axis, outermost first);
        with `axes`, over those axes only, from blocks of the layout
        without them."""
        for d, split in self._walk(t.dim(), axes):
            for a in split:
                t = comm.reduce_scatter(t, self.mesh.axis_ranks(a),
                                        self.mesh.get_group(a), d)
        return t

    def without(self, axes: Sequence[str]) -> "NamedSharding":
        """This layout with no split over `axes`."""
        def keep(part):
            parts = part if isinstance(part, tuple) else (part,)
            left = tuple(a for a in parts if a is not None
                         and a not in axes)
            return None if not left else left[0] if len(left) == 1 \
                else left

        return NamedSharding(self.mesh, [keep(p) for p in self.spec])

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def named_sharding(mesh: Mesh, logical_axes: Sequence[Optional[str]],
                   rules: Rules = DEFAULT_RULES) -> NamedSharding:
    return NamedSharding(mesh, spec_from_logical(logical_axes, rules, mesh))


def _is_axes_leaf(v: Any) -> bool:
    return isinstance(v, (tuple, list)) and (
        not v or v[0] is None or isinstance(v[0], str))


def _tree_map(fn, tree: Any, is_leaf=lambda v: False) -> Any:
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_shardings(mesh: Mesh, logical_tree: Any,
                   rules: Rules = DEFAULT_RULES) -> Any:
    """Map a tree of logical-axis tuples to a tree of NamedShardings.

    `logical_tree` leaves are tuples/lists of logical axis names (or None),
    typically produced by `infer_logical_axes` or the model's
    `logical_axes`.
    """
    return _tree_map(lambda axes: named_sharding(mesh, axes, rules),
                     logical_tree, _is_axes_leaf)


def infer_logical_axes(params: Any,
                       table: Optional[Dict[str, Sequence[str]]] = None
                       ) -> Any:
    """Heuristic logical axes for a param tree keyed by path names.

    Used when a model does not annotate its params: embedding/vocab matrices
    shard on vocab, attention projections on heads/embed, MLP on mlp/embed.
    Works for the in-tree models (models/transformer.py names its params to
    match).  Leaves default to fsdp-on-largest-axis.
    """

    def infer_one(keys: str, leaf) -> Tuple[Optional[str], ...]:
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        nd = len(shape)
        if nd == 0:
            return ()
        if nd == 1:
            return (None,)
        if "embed" in keys and ("tok" in keys or "vocab" in keys or
                                "wte" in keys):
            return ("vocab", "embed") + (None,) * (nd - 2)
        if any(k in keys for k in ("wq", "wk", "wv", "q_proj", "k_proj",
                                   "v_proj", "query", "key", "value")):
            return ("embed", "heads") + (None,) * (nd - 2)
        if any(k in keys for k in ("wo", "o_proj", "out_proj", "attn_out")):
            return ("heads", "embed") + (None,) * (nd - 2)
        if any(k in keys for k in ("w_up", "up_proj", "gate", "w_gate", "wi",
                                   "fc1")):
            return ("embed", "mlp") + (None,) * (nd - 2)
        if any(k in keys for k in ("w_down", "down_proj", "wo_mlp", "fc2")):
            return ("mlp", "embed") + (None,) * (nd - 2)
        if "lm_head" in keys or "output" in keys:
            return ("embed", "vocab") + (None,) * (nd - 2)
        # default: shard the largest dim on fsdp (the first, on ties)
        big = max(range(nd), key=lambda i: (shape[i], -i))
        return tuple("embed" if i == big else None for i in range(nd))

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + [str(i)])
                              for i, v in enumerate(node))
        return infer_one("/".join(path).lower(), node)

    # scan-stacked layers: leading 'layers' axis handled by caller
    return walk(params, [])


def _zip_map(fn, tree: Any, shardings: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s)
                          for v, s in zip(tree, shardings))
    return fn(tree, shardings)


def shard_tree(params: Any, mesh: Mesh, rules: Rules = DEFAULT_RULES,
               logical_tree: Any = None) -> Any:
    """Each rank's blocks of a whole param tree, with inferred or provided
    logical axes (the reference device-puts the tree on the shardings)."""
    require_placeable(mesh.shape)
    if logical_tree is None:
        logical_tree = infer_logical_axes(params)
    shardings = tree_shardings(mesh, logical_tree, rules)

    def place(t, s):
        if isinstance(t, torch.Tensor):
            return s.shard(t)
        if s.split_dims(len(getattr(t, "shape", ()))):
            raise TypeError(f"a {type(t).__name__} leaf to split: "
                            "shard_tree splits torch tensors")
        return t

    return _zip_map(place, params, shardings)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def data_sharding(mesh: Mesh, batch_axes: Sequence[str] = ("data", "fsdp")
                  ) -> NamedSharding:
    """Sharding for a host batch: leading dim over the data(+fsdp) axes."""
    axes = tuple(a for a in batch_axes if a in mesh.axis_names
                 and mesh.shape[a] > 1)
    if not axes:
        return NamedSharding(mesh, PartitionSpec())
    return NamedSharding(
        mesh, PartitionSpec(axes if len(axes) > 1 else axes[0]))
