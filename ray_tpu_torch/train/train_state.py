"""Train state and training step for the flagship transformer.

Port of ray_tpu/train/train_state.py.  The reference's
`ShardedTrainStep` jits one step over a named mesh and GSPMD inserts its
collectives; here PyTorch runs the step eagerly on each rank of a mesh
of torch.distributed ranks (parallel/mesh.py): value and gradient of the
loss (the flash kernels' autograd Function, ring attention on a `seq`
axis, fused CE and per-layer remat inside models/transformer.py), the
gradients summed over the mesh, the optimizer's update, new params.

The params' layout follows the sharding rules (parallel/sharding.py) on
the model's logical axes, as in the reference: on an `fsdp` axis of more
than one rank each rank holds its block of every leaf with an `embed`
dim, on a `tensor` axis its block of every leaf with a `heads`, `mlp`
or `vocab` dim, and the Adam moments mirror that layout; the other
leaves (the norms) and every leaf on `data` and `seq` ranks stay
replicated, bit-equal on every rank.  A step gathers the params over
`fsdp` before the loss, into the layout the model computes on
(`compute_shardings`: the tensor blocks stay split, and the model's
tensor-parallel layers run on them), reduce-scatters the gradients of
the fsdp-split leaves over `fsdp` and sums them over `data`, and sums
the other leaves' over the mesh without `tensor` (a tensor rank's
gradient of its block is whole; the norms' are equal on every tensor
rank).  The clip's global norm, and the reported `grad_norm`, sum the
squares of every block over the axes that split it.  expert of more
than one rank, a pipeline `stage` axis, fsdp together with seq and
tensor together with seq raise NotImplementedError naming the slice
that ports them.

`state_from_numpy` carries the reference's train state across (params,
Adam count/mu/nu, schedule counts), so both sides can start from the same
state; `shard_state` cuts a whole state to this rank's blocks and
`gather_state` makes the whole state again, for a checkpoint;
`state_shardings` is the state's layout tree, with which
train/checkpoint.py load_pytree restores each rank's blocks alone.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.mesh import (Mesh, canonical_axis, one_process_mesh,
                                         require_placeable)
from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES, NamedSharding,
                                             Rules, data_sharding, replicated,
                                             tree_shardings)
from ray_tpu_torch.train import optim


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10000,
                      b1: float = 0.9, b2: float = 0.95,
                      grad_clip: float = 1.0,
                      mu_dtype: Optional[torch.dtype] = None,
                      nu_dtype: Optional[torch.dtype] = None
                      ) -> optim.GradientTransformation:
    """AdamW + cosine schedule + global-norm clip — the Llama recipe.

    mu_dtype/nu_dtype=torch.bfloat16 halve the moment state.  With
    nu_dtype=None this is the reference's optax.adamw branch (nu in
    fp32), otherwise its memory-lean branch."""
    sched = optim.warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1))
    return optim.chain(
        optim.clip_by_global_norm(grad_clip),
        optim.adamw(sched, b1=b1, b2=b2, weight_decay=weight_decay,
                    mu_dtype=mu_dtype, nu_dtype=nu_dtype),
    )


class ShardedTrainStep:
    """init/step/eval functions on a mesh of data x fsdp x tensor or
    data x seq ranks.

    Usage (on every rank of the process group):
        mesh = build_mesh(axes={"data": 2, "fsdp": 2})
        ts = ShardedTrainStep(config, mesh, device="cuda")
        state = ts.init(0)
        state, metrics = ts.step(state, batch)   # batch: {"tokens": [b, s+1]}

    `mesh` is a `Mesh`, or None or an axes dict for one process, e.g.
    {"fsdp": 1}.  Every rank passes the same global batch; the step
    keeps the rows of the rank's `data` x `fsdp` coordinate (tensor
    ranks take the same rows), gathers over fsdp the params it holds in
    blocks, runs the loss under `with mesh:` (the ring over `seq`, the
    tensor-parallel layers over `tensor`), reduces the gradients (module
    docstring; the loss is already the global mean), then clips and
    updates each rank's blocks as on one device.  `param_shardings`
    holds each leaf's layout at rest, `compute_shardings` the layout the
    model runs on.  `num_microbatches` feeds the pipelined loss of the
    reference, which this step never takes.  `last_comm` holds the last
    step's collectives: "bytes" and "seconds" in all, and per kind
    ("gather", "reduce_scatter", "all_reduce", and "tensor": the
    model's all-reduces and all-gathers over `tensor`); the bytes of a
    gather or reduce-scatter are those of the gathered leaves, of an
    all-reduce or a tensor collective those of its buffers.
    """

    def __init__(self, config: tfm.TransformerConfig,
                 mesh: Any = None,
                 optimizer: Optional[optim.GradientTransformation] = None,
                 rules: Rules = DEFAULT_RULES,
                 loss_fn: Optional[Callable] = None,
                 num_microbatches: Optional[int] = None,
                 device: DeviceLike = None):
        if isinstance(mesh, Mesh):
            require_placeable(mesh.shape)
        else:
            axes = {canonical_axis(a): int(n) for a, n in (mesh or {}).items()}
            require_placeable(axes, named=axes)
            mesh = one_process_mesh(axes)
        if mesh.axis_size("fsdp") > 1 and mesh.axis_size("seq") > 1:
            raise NotImplementedError(
                f"fsdp of {mesh.axis_size('fsdp')} with seq of "
                f"{mesh.axis_size('seq')}: the sharding slice trains fsdp "
                "with data ranks; fsdp with seq waits for ROADMAP Queue A "
                "item 6b, fsdp with seq")
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.optimizer = optimizer or default_optimizer()
        self.rules = rules
        self.num_microbatches = num_microbatches
        self.loss_fn = loss_fn or (lambda p, b: tfm.loss_fn(p, b, config))
        self.param_logical = tfm.logical_axes(config)
        self.param_shardings = tree_shardings(mesh, self.param_logical,
                                              rules)
        self.compute_shardings = optim.tree_map(
            lambda s: s.without(("fsdp",)), self.param_shardings)
        self.batch_sharding = data_sharding(mesh)
        self._layouts = optim.tree_leaves(self.param_shardings)
        # Per leaf, the axes that split it.
        self._split = [{a for split in s.split_dims(len(s.spec)).values()
                        for a in split} for s in self._layouts]
        for split in self._split:
            if split - {"fsdp", "tensor"}:
                raise ValueError(
                    f"rules {rules} split a param over {sorted(split)}: "
                    "params split over fsdp and tensor only")
        if mesh.axis_size("tensor") > 1:
            # The tensor-parallel model's layout, checked here rather
            # than at the first step.
            want = tree_shardings(mesh, self.param_logical,
                                  [(d, "tensor") for d in tfm.TENSOR_DIMS])
            for got, need in zip(optim.tree_leaves(self.compute_shardings),
                                 optim.tree_leaves(want)):
                if got.split_dims(len(got.spec)) != \
                        need.split_dims(len(need.spec)):
                    raise ValueError(
                        f"rules {rules} place a param {got.spec} on the "
                        f"tensor ranks, not {need.spec}: the tensor-parallel "
                        f"model splits its {'/'.join(tfm.TENSOR_DIMS)} dims "
                        "over tensor and takes the rest whole")
        self.sharded = any(self._split)
        self.last_comm = self._comm_stats()

    @staticmethod
    def _comm_stats() -> Dict[str, Any]:
        kinds = ("gather", "reduce_scatter", "all_reduce", "tensor")
        return {"bytes": 0, "seconds": 0.0,
                **{k: {"bytes": 0, "seconds": 0.0} for k in kinds}}

    def _count(self, kind: str, nbytes: int, t0: float) -> None:
        dt = time.perf_counter() - t0
        for entry in (self.last_comm, self.last_comm[kind]):
            entry["bytes"] += nbytes
            entry["seconds"] += dt

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        n = self.mesh.axis_size("data") * self.mesh.axis_size("fsdp")
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.asarray(v))
            if k == "tokens":
                t = t.long()
            if t.shape[0] % n:
                raise ValueError(
                    f"batch of {t.shape[0]} rows does not split over "
                    f"{n} data x fsdp ranks")
            out[k] = self.batch_sharding.shard(t).to(self.device)
        return out

    def shard(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's blocks of whole `params` (the layout of
        `param_shardings`)."""
        return optim.tree_map(lambda t, s: s.shard(t), params,
                              self.param_shardings)

    def gather(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The whole params (or any tree of their layout, e.g. gradients
        or Adam moments) from this rank's blocks."""
        return optim.tree_map(lambda t, s: s.gather(t), params,
                              self.param_shardings)

    def _like_params(self, fn: Callable, opt_state: Any) -> Any:
        """fn on every params-shaped tree of the optimizer state (Adam's
        mu and nu), the rest as it is: the reference's
        _constrain_like_params."""
        def rec(x):
            if isinstance(x, dict) and _same_keys(x, self.param_shardings):
                return fn(x)
            if hasattr(x, "_fields"):
                return type(x)(*(rec(v) for v in x))
            if isinstance(x, (tuple, list)):
                return type(x)(rec(v) for v in x)
            return x

        return rec(opt_state)

    def shard_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A whole train state (e.g. state_from_numpy's) cut to this
        rank's blocks."""
        return {**state, "params": self.shard(state["params"]),
                "opt_state": self._like_params(self.shard,
                                               state["opt_state"])}

    def state_shardings(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The layout tree of a train state of this step (whole or in
        blocks): `param_shardings` for the params and Adam's mu and nu,
        a replicated layout for every other tensor, None for the leaves
        that hold none.  What load_pytree(shardings=...) takes to restore
        each rank's blocks; the port's counterpart of the reference's
        `jax.tree.map(lambda a: a.sharding, state)`, since a block
        carries no layout."""
        rep = replicated(self.mesh)

        def rec(x):
            if isinstance(x, NamedSharding):
                return x
            if isinstance(x, dict):
                return {k: rec(v) for k, v in x.items()}
            if hasattr(x, "_fields"):
                return type(x)(*(rec(v) for v in x))
            if isinstance(x, (tuple, list)):
                return type(x)(rec(v) for v in x)
            return rep if isinstance(
                x, (torch.Tensor, np.ndarray, np.generic)) else None

        return rec({**state, "params": self.param_shardings,
                    "opt_state": self._like_params(
                        lambda _: self.param_shardings, state["opt_state"])})

    def gather_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The whole train state from this rank's blocks, the same on
        every rank: what a checkpoint saves (a rank's blocks are not the
        state)."""
        return {**state, "params": self.gather(state["params"]),
                "opt_state": self._like_params(self.gather,
                                               state["opt_state"])}

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """The same params on every rank (one seeded generator each),
        checked by digest on a mesh of more than one rank, then cut to
        this rank's blocks; the optimizer state is made from the blocks
        and so mirrors their layout."""
        params = tfm.init_params(self.config, seed, device=self.device)
        self.check_replicated(params)
        params = self.shard(params)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0}

    def check_replicated(self, tree: Any) -> int:
        """Raise unless every rank of the mesh holds `tree` bit for bit
        (comm.tree_digest); returns the digest, the same on every rank.
        Blocks differ by rank: pass gathered trees (`gather(params)`)."""
        same, digests = comm.digests_equal(optim.tree_leaves(tree),
                                           self.mesh.get_group())
        if not same:
            raise RuntimeError(f"ranks hold different trees: digests "
                               f"{digests}")
        return digests[0]

    def _compute(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The params in the layout the model computes on
        (`compute_shardings`): gathered over fsdp, the tensor blocks
        kept."""
        return optim.tree_map(lambda t, s: s.gather(t, ("fsdp",)), params,
                              self.param_shardings)

    def _whole(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """`_compute(params)`, its gather counted."""
        fsdp = [("fsdp" in split) for split in self._split]
        if not any(fsdp):
            return params
        t0 = time.perf_counter()
        whole = self._compute(params)
        self._count("gather", sum(
            w.nbytes for w, x in zip(optim.tree_leaves(whole), fsdp) if x),
            t0)
        return whole

    def _reduce(self, grads: Dict[str, Any]) -> Dict[str, Any]:
        """Gradients in the compute layout (this rank's share) to the
        layout of the params, summed over the mesh without `tensor`."""
        group = self.mesh.get_group(self.mesh.axes_but("tensor"))
        if group is None:
            return grads
        leaves = optim.tree_leaves(grads)
        fsdp = [("fsdp" in split) for split in self._split]
        out = list(leaves)
        if any(fsdp):
            t0 = time.perf_counter()
            for i, (g, s) in enumerate(zip(leaves, self._layouts)):
                if fsdp[i]:
                    out[i] = s.reduce_scatter(g, ("fsdp",))
            self._count("reduce_scatter",
                        sum(g.nbytes for g, x in zip(leaves, fsdp) if x),
                        t0)
            del leaves
            if self.mesh.axis_size("data") > 1:
                t0 = time.perf_counter()
                nbytes = comm.all_reduce_tree_(
                    [g for g, x in zip(out, fsdp) if x],
                    self.mesh.get_group("data"))
                self._count("all_reduce", nbytes, t0)
        t0 = time.perf_counter()
        nbytes = comm.all_reduce_tree_(
            [g for g, x in zip(out, fsdp) if not x], group)
        self._count("all_reduce", nbytes, t0)
        return optim.tree_unflatten(grads, out)

    def _sum_squares(self, tree: Dict[str, Any]) -> torch.Tensor:
        """The sum of squares over every block of a tree in the params'
        layout: each leaf's own sum, summed over each axis that splits
        it (fsdp, then tensor: a leaf split over both sums over every
        block once; blocks are the same on every data rank), a
        replicated leaf's once, added in leaf order."""
        sq = torch.stack([t.float().square().sum()
                          for t in optim.tree_leaves(tree)])
        for axis in ("fsdp", "tensor"):
            if self.mesh.axis_size(axis) > 1:
                split = torch.tensor([axis in s for s in self._split],
                                     device=sq.device)
                total = comm.all_reduce_(torch.where(split, sq, 0.0),
                                         self.mesh.get_group(axis))
                sq = torch.where(split, total, sq)
        return sq.sum()

    def _norms(self):
        """Where global_norm takes its sum of squares from in the
        update: every block on an fsdp or tensor mesh."""
        if self.sharded:
            return optim.sum_squares_by(self._sum_squares)
        return contextlib.nullcontext()

    def grads(self, params: Dict[str, Any], batch: Dict[str, Any]):
        """(loss, gradient of the loss with respect to `params`) on this
        rank, summed over the mesh: the global mean's, in the params'
        layout (this rank's blocks of the split leaves), the same on
        every rank that holds the same blocks.  `batch` is the global
        batch, as for step."""
        batch = self._batch(batch)
        self.last_comm = self._comm_stats()
        whole = self._whole(params)
        before = dict(self.mesh.tensor_comm)
        with torch.enable_grad(), self.mesh:
            live = optim.tree_map(lambda p: p.detach().requires_grad_(),
                                  whole)
            del whole
            loss = self.loss_fn(live, batch)
            grads = optim.tree_unflatten(live, list(torch.autograd.grad(
                loss, optim.tree_leaves(live))))
        del live
        for entry in (self.last_comm, self.last_comm["tensor"]):
            for k in ("bytes", "seconds"):
                entry[k] += self.mesh.tensor_comm[k] - before[k]
        return loss, self._reduce(grads)

    def step(self, state: Dict[str, Any], batch: Dict[str, Any]):
        """One optimizer step.  Returns the new state and metrics
        {"loss", "grad_norm" (before clipping), "step"}; loss and
        grad_norm are fp32 0-d tensors on the device, equal on every
        rank."""
        params = state["params"]
        loss, grads = self.grads(params, batch)
        with torch.no_grad(), self._norms():
            grad_norm = optim.global_norm(grads)
            updates, opt_state = self.optimizer.update(
                grads, state["opt_state"], params)
            del grads
            params = optim.apply_updates(params, updates)
        step = state["step"] + 1
        metrics = {"loss": loss.detach().float(), "grad_norm": grad_norm,
                   "step": step}
        return {"params": params, "opt_state": opt_state,
                "step": step}, metrics

    def eval_step(self, params: Dict[str, Any], batch: Dict[str, Any]
                  ) -> torch.Tensor:
        batch = self._batch(batch)
        with torch.no_grad():
            whole = self._compute(params)
            with self.mesh:
                return self.loss_fn(whole, batch).float()


def _same_keys(tree: Any, like: Any) -> bool:
    """Whether dict `tree` has the nested keys of dict `like`."""
    if not isinstance(like, dict):
        return not isinstance(tree, dict)
    return isinstance(tree, dict) and set(tree) == set(like) and all(
        _same_keys(tree[k], like[k]) for k in like)


def state_from_numpy(tree: Dict[str, Any], config: tfm.TransformerConfig,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's train state (its pytree with numpy leaves, e.g.
    `jax.tree.map(np.asarray, state)`) as the port's: params and Adam
    moments as tensors on `device` in their own dtypes, counts as ints.
    Optimizer states are matched by their fields: (count, mu, nu) is
    Adam's, (count,) a schedule's, () an empty state; tuples nest as in
    optax.chain."""

    def params(node):
        return tfm.params_from_numpy(node, config, device=device)

    def convert(node):
        fields = getattr(node, "_fields", None)
        if fields == ("count", "mu", "nu"):
            return optim.ScaleByAdamState(int(node.count), params(node.mu),
                                          params(node.nu))
        if fields == ("count",):
            return optim.ScaleByScheduleState(int(node.count))
        if fields == ():
            return optim.EmptyState()
        if fields is None and isinstance(node, (tuple, list)):
            return tuple(convert(x) for x in node)
        raise ValueError(f"unknown optimizer state {type(node).__name__} "
                         f"with fields {fields}")

    return {"params": params(tree["params"]),
            "opt_state": convert(tree["opt_state"]),
            "step": int(np.asarray(tree["step"]))}
