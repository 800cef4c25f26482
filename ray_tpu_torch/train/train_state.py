"""Train state and training step for the flagship transformer.

Port of ray_tpu/train/train_state.py.  The reference's
`ShardedTrainStep` jits one step over a named mesh and GSPMD inserts its
collectives; here PyTorch runs the step eagerly on each rank of a mesh
of torch.distributed ranks (parallel/mesh.py): value and gradient of the
loss (the flash kernels' autograd Function, ring attention on a `seq`
axis, fused CE and per-layer remat inside models/transformer.py), the
gradients summed over the mesh, the optimizer's update, new params.
Params and optimizer state stay replicated, bit-equal on every rank, so
the axes are `data` and `seq`; fsdp, tensor and expert of more than one
rank, and a pipeline `stage` axis, raise NotImplementedError naming the
slice that ports them.

`state_from_numpy` carries the reference's train state across (params,
Adam count/mu/nu, schedule counts), so both sides can start from the same
state.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.mesh import (Mesh, canonical_axis, one_process_mesh,
                                         require_replicated)
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
    """init/step/eval functions on a mesh of data x seq ranks.

    Usage (on every rank of the process group):
        mesh = build_mesh(axes={"data": 2, "seq": 2})
        ts = ShardedTrainStep(config, mesh, device="cuda")
        state = ts.init(0)
        state, metrics = ts.step(state, batch)   # batch: {"tokens": [b, s+1]}

    `mesh` is a `Mesh`, or None or an axes dict for one process, e.g.
    {"fsdp": 1}.  Every rank passes the same global batch; the step
    keeps the rows of the rank's `data` coordinate, runs the loss under
    `with mesh:` (the ring over `seq`), sums the gradients over the mesh
    in flat buckets (the loss is already the global mean), then clips
    and updates as on one device.  `num_microbatches` feeds the
    pipelined loss of the reference, which this step never takes.
    `last_comm` holds the last step's gradient all-reduce: bytes and
    seconds.
    """

    def __init__(self, config: tfm.TransformerConfig,
                 mesh: Any = None,
                 optimizer: Optional[optim.GradientTransformation] = None,
                 loss_fn: Optional[Callable] = None,
                 num_microbatches: Optional[int] = None,
                 device: DeviceLike = None):
        if isinstance(mesh, Mesh):
            require_replicated(mesh.shape)
        else:
            axes = {canonical_axis(a): int(n) for a, n in (mesh or {}).items()}
            require_replicated(axes, named=axes)
            mesh = one_process_mesh(axes)
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.optimizer = optimizer or default_optimizer()
        self.num_microbatches = num_microbatches
        self.loss_fn = loss_fn or (lambda p, b: tfm.loss_fn(p, b, config))
        self.last_comm = {"bytes": 0, "seconds": 0.0}

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        data = self.mesh.axis_size("data")
        out = {}
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.asarray(v))
            if k == "tokens":
                t = t.long()
            if data > 1:
                if t.shape[0] % data:
                    raise ValueError(
                        f"batch of {t.shape[0]} rows does not split over "
                        f"{data} data ranks")
                n = t.shape[0] // data
                t = t[self.mesh.axis_index("data") * n:][:n]
            out[k] = t.to(self.device)
        return out

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """The same params on every rank (one seeded generator each),
        checked by digest on a mesh of more than one rank."""
        params = tfm.init_params(self.config, seed, device=self.device)
        self.check_replicated(params)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0}

    def check_replicated(self, tree: Any) -> int:
        """Raise unless every rank of the mesh holds `tree` bit for bit
        (comm.tree_digest); returns the digest, the same on every rank."""
        same, digests = comm.digests_equal(optim.tree_leaves(tree),
                                           self.mesh.get_group())
        if not same:
            raise RuntimeError(f"ranks hold different trees: digests "
                               f"{digests}")
        return digests[0]

    def grads(self, params: Dict[str, Any], batch: Dict[str, Any]):
        """(loss, gradient of the loss with respect to `params`) on this
        rank, the gradient summed over the mesh: the global mean's, the
        same on every rank.  `batch` is the global batch, as for step."""
        batch = self._batch(batch)
        with torch.enable_grad(), self.mesh:
            live = optim.tree_map(lambda p: p.detach().requires_grad_(),
                                  params)
            loss = self.loss_fn(live, batch)
            grads = optim.tree_unflatten(live, list(torch.autograd.grad(
                loss, optim.tree_leaves(live))))
        del live
        group = self.mesh.get_group()
        if group is not None:
            t0 = time.perf_counter()
            nbytes = comm.all_reduce_tree_(optim.tree_leaves(grads), group)
            self.last_comm = {"bytes": nbytes,
                              "seconds": time.perf_counter() - t0}
        return loss, grads

    def step(self, state: Dict[str, Any], batch: Dict[str, Any]):
        """One optimizer step.  Returns the new state and metrics
        {"loss", "grad_norm" (before clipping), "step"}; loss and
        grad_norm are fp32 0-d tensors on the device, equal on every
        rank."""
        params = state["params"]
        loss, grads = self.grads(params, batch)
        with torch.no_grad():
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
        with torch.no_grad(), self.mesh:
            return self.loss_fn(params, self._batch(batch)).float()


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
