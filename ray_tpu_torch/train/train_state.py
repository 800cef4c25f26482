"""Train state and training step for the flagship transformer, on one
device.

Port of ray_tpu/train/train_state.py.  The reference's
`ShardedTrainStep` jits one step over a named mesh; here PyTorch runs the
step eagerly on one device: value and gradient of the loss (the flash
kernels' autograd Function, fused CE and per-layer remat inside
models/transformer.py), the optimizer's update, new params.  A mesh of
more than one device, or a pipeline `stage` axis, raises
NotImplementedError until the parallelism slice.

`state_from_numpy` carries the reference's train state across (params,
Adam count/mu/nu, schedule counts), so both sides can start from the same
state.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models import transformer as tfm
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
    """init/step/eval functions for one device.

    Usage:
        ts = ShardedTrainStep(config, device="cuda")
        state = ts.init(0)
        state, metrics = ts.step(state, batch)   # batch: {"tokens": [b, s+1]}

    `mesh` is None or the axis sizes of a one-device mesh, e.g.
    {"fsdp": 1}.  `num_microbatches` feeds the pipelined loss of the
    reference, which a one-device step never takes.
    """

    def __init__(self, config: tfm.TransformerConfig,
                 mesh: Optional[Dict[str, int]] = None,
                 optimizer: Optional[optim.GradientTransformation] = None,
                 loss_fn: Optional[Callable] = None,
                 num_microbatches: Optional[int] = None,
                 device: DeviceLike = None):
        axes = mesh or {}
        if math.prod(axes.values()) > 1 or "stage" in axes:
            raise NotImplementedError(
                f"mesh {axes}: the port trains on one device; sharded and "
                "pipelined meshes wait for the parallelism slice")
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.optimizer = optimizer or default_optimizer()
        self.num_microbatches = num_microbatches
        self.loss_fn = loss_fn or (lambda p, b: tfm.loss_fn(p, b, config))

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.asarray(v))
            if k == "tokens":
                t = t.long()
            out[k] = t.to(self.device)
        return out

    def init(self, seed: int = 0) -> Dict[str, Any]:
        params = tfm.init_params(self.config, seed, device=self.device)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0}

    def step(self, state: Dict[str, Any], batch: Dict[str, Any]):
        """One optimizer step.  Returns the new state and metrics
        {"loss", "grad_norm" (before clipping), "step"}; loss and
        grad_norm are fp32 0-d tensors on the device."""
        batch = self._batch(batch)
        params = state["params"]
        with torch.enable_grad():
            live = optim.tree_map(lambda p: p.detach().requires_grad_(),
                                  params)
            loss = self.loss_fn(live, batch)
            grads = optim.tree_unflatten(live, list(torch.autograd.grad(
                loss, optim.tree_leaves(live))))
        del live
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
        with torch.no_grad():
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
