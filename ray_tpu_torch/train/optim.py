"""AdamW with independently typed moments, and the optax pieces it uses.

Port of ray_tpu/train/optim.py.  The reference builds on optax, which
imports JAX, so this module carries its own small functional transform
type: `GradientTransformation(init, update)` over nested dicts of tensors
(the params' layout), with `chain`, `clip_by_global_norm`,
`add_decayed_weights`, `scale_by_learning_rate`,
`warmup_cosine_decay_schedule`, `global_norm` and `apply_updates`, each
computing what its optax namesake computes.

`scale_by_adam` keeps the moment math in fp32 and stores mu and nu in the
given dtypes (None: fp32); with `nu_dtype=None` it is optax.scale_by_adam
with `mu_dtype`, so `adamw` serves both branches of the reference's
`default_optimizer`.  Step counts and schedules live on the host as
Python ints and float32 numbers; every tensor op stays on the params'
device and nothing synchronises with it.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

import numpy as np
import torch

Tree = Union[Dict[str, Any], torch.Tensor]
Schedule = Callable[[int], np.float32]


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Tuple[Tree, Any]]  # (updates, state, params)


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: int
    mu: Tree
    nu: Tree


class ScaleByScheduleState(NamedTuple):
    count: int


# ---------------------------------------------------------------------------
# Trees: nested dicts of tensors, walked in sorted key order (the order of
# a JAX pytree's leaves).
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Tree, leaves: List[torch.Tensor]) -> Tree:
    """`like`'s structure holding `leaves` (in tree_leaves order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# The sum of squares that global_norm takes, where a caller set one
# (sum_squares_by); per thread.
_sum_squares = threading.local()


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, fp32.  Inside
    `sum_squares_by(fn)` the sum is fn(tree)'s, for both the clip and
    the reported norm: a tree of shards sums over every shard."""
    fn = getattr(_sum_squares, "fn", None)
    if fn is not None:
        return torch.sqrt(fn(tree))
    return torch.sqrt(sum(t.float().square().sum()
                          for t in tree_leaves(tree)))


@contextlib.contextmanager
def sum_squares_by(fn: Callable[[Tree], torch.Tensor]):
    """global_norm takes fn(tree), an fp32 0-d tensor, as its sum of
    squares on this thread while the block runs (ShardedTrainStep on an
    fsdp mesh, whose gradient leaves are this rank's blocks)."""
    prev = getattr(_sum_squares, "fn", None)
    _sum_squares.fn = fn
    try:
        yield
    finally:
        _sum_squares.fn = prev


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init_fn(params):
        return tuple(t.init(params) for t in transforms)

    def update_fn(updates, state, params=None):
        states = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            states.append(s)
        return updates, tuple(states)

    return GradientTransformation(init_fn, update_fn)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every leaf by max_norm / norm when the global norm is not
    below max_norm (optax: where(norm < max, g, g / norm * max))."""
    def update_fn(updates, state, params=None):
        norm = global_norm(updates)
        keep = norm < max_norm
        return tree_map(lambda t: torch.where(
            keep, t, (t / norm.to(t.dtype)) * max_norm), updates), state

    return GradientTransformation(lambda params: EmptyState(), update_fn)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    """updates + weight_decay * params, for every param (the reference
    passes no mask: norms and the embedding decay too)."""
    def update_fn(updates, state, params):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return tree_map(lambda g, p: g + weight_decay * p, updates,
                        params), state

    return GradientTransformation(lambda params: EmptyState(), update_fn)


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransformation:
    """updates * step_size_fn(count), with a count of its own."""
    def update_fn(updates, state, params=None):
        step = float(step_size_fn(state.count))
        return (tree_map(lambda g: g * step, updates),
                ScaleByScheduleState(state.count + 1))

    return GradientTransformation(lambda params: ScaleByScheduleState(0),
                                  update_fn)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]
                           ) -> GradientTransformation:
    """updates * -learning_rate (a number, or a schedule of the count)."""
    if callable(learning_rate):
        return scale_by_schedule(
            lambda count: np.float32(-1) * learning_rate(count))
    step = -float(learning_rate)
    return GradientTransformation(
        lambda params: EmptyState(),
        lambda updates, state, params=None: (
            tree_map(lambda g: g * step, updates), state))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """Linear warmup from init_value to peak_value over warmup_steps,
    then cosine decay to 0 at decay_steps (warmup included), in float32
    as optax computes it (its end_value 0 and exponent 1)."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps, "
                         f"got {decay_steps=} {warmup_steps=}")
    f32 = np.float32
    cos_steps = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> np.float32:
        if count < warmup_steps:
            frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
            return f32(init_value - peak_value) * frac + f32(peak_value)
        c = min(f32(count - warmup_steps), cos_steps)
        return f32(peak_value) * (
            f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / cos_steps)))

    return schedule


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  mu_dtype: Optional[torch.dtype] = None,
                  nu_dtype: Optional[torch.dtype] = None
                  ) -> GradientTransformation:
    """Adam's rescaling: moments in fp32 from the stored dtypes, bias
    corrected with the step count, stored back in mu_dtype / nu_dtype
    (None: fp32)."""
    def zeros(dtype):
        return lambda p: torch.zeros_like(p, dtype=dtype or torch.float32)

    def init_fn(params):
        return ScaleByAdamState(0, tree_map(zeros(mu_dtype), params),
                                tree_map(zeros(nu_dtype), params))

    def update_fn(updates, state, params=None):
        count = state.count + 1
        mu = tree_map(lambda g, m: b1 * m.float() + (1 - b1) * g.float(),
                      updates, state.mu)
        nu = tree_map(lambda g, v: b2 * v.float()
                      + (1 - b2) * g.float().square(), updates, state.nu)
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        out = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps),
                       mu, nu)
        return out, ScaleByAdamState(
            count, tree_map(lambda m: m.to(mu_dtype or m.dtype), mu),
            tree_map(lambda v: v.to(nu_dtype or v.dtype), nu))

    return GradientTransformation(init_fn, update_fn)


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
          mu_dtype: Optional[torch.dtype] = None,
          nu_dtype: Optional[torch.dtype] = None) -> GradientTransformation:
    """AdamW with typed moment storage (optax.adamw signature subset)."""
    return chain(
        scale_by_adam(b1=b1, b2=b2, eps=eps, mu_dtype=mu_dtype,
                      nu_dtype=nu_dtype),
        add_decayed_weights(weight_decay),
        scale_by_learning_rate(learning_rate),
    )
