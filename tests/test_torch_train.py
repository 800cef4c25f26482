"""The port's training path against the JAX reference, on the CPU.

`loss_fn` (fused and unfused cross-entropy, with and without a mask and
remat) in value and gradient against `jax.value_and_grad`, and
`ShardedTrainStep` for three steps against the reference's on a
one-device mesh, both starting from the reference's state carried across
with `state_from_numpy`.  JAX runs its Pallas flash kernels in interpret
mode; the port's CPU path runs their plain versions.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel.mesh import build_mesh
from ray_tpu.train import train_state as jts

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
ttf = importlib.import_module(f"{PORT}.models.transformer")
tts = importlib.import_module(f"{PORT}.train.train_state")
toptim = importlib.import_module(f"{PORT}.train.optim")
tbench = importlib.import_module(f"{PORT}.bench")

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")


def port_config(jcfg):
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jtf.TransformerConfig)}
    kw["dtype"] = _DTYPES[kw["dtype"]]
    kw["param_dtype"] = _DTYPES[kw["param_dtype"]]
    return ttf.TransformerConfig(**kw)


def tiny_jax(**kw):
    """fp32 so the comparison is of the algorithm; seq 32 is the Pallas
    kernels' tile (the JAX model takes its flash kernels only when the
    sequence divides into tiles)."""
    return jtf.TransformerConfig.tiny(**{**dict(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64,
        dtype=jnp.float32), **kw})


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed, b=2, s=32, vocab=64, mask=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab, size=(b, s + 1)).astype(
        np.int32)}
    if mask:
        m = (rng.random((b, s + 1)) < 0.7).astype(np.float32)
        m[1, 1:] = 0.0  # one row with no target counted
        out["mask"] = m
    return out


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_port_flat(v, name + "/"))
        else:
            out[name] = v.detach().float().numpy()
    return out


@pytest.mark.parametrize("fused_ce", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_value_and_grad_match_jax(fused_ce, mask, remat):
    """fp32: loss to 1e-5 relative, every gradient to 1e-4 of its
    largest magnitude (the same arithmetic summed in other orders; the
    fused path rounds x and dlogits to bf16 on both sides)."""
    jcfg = tiny_jax(fused_ce=fused_ce, remat=remat, use_flash=True)
    tcfg = port_config(jcfg)
    jparams = jtf.init_params(jcfg, jax.random.key(3))
    batch = _batch(4, mask=mask)
    jl, jg = jax.value_and_grad(jtf.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    params = ttf.params_from_numpy(_numpy(jparams), tcfg, device="cpu")
    leaves = toptim.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = ttf.loss_fn(params, tb, tcfg)
    grads = toptim.tree_unflatten(params, list(torch.autograd.grad(
        loss, leaves)))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want, got = _flat(jg), _port_flat(grads)
    assert set(want) == set(got)
    for name, w in want.items():
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(got[name] - w).max() <= 1e-4 * scale, name


def test_remat_policies_not_ported_raise():
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, remat_policy="dots")
    params = ttf.init_params(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 9), dtype=torch.long)}
    with torch.no_grad():  # no backward: remat does not apply
        assert torch.isfinite(ttf.loss_fn(params, batch, cfg))
    params["final_norm"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="dots"):
        ttf.loss_fn(params, batch, cfg)


def _jax_train_step(jcfg, lean):
    mesh = build_mesh(axes={"fsdp": 1}, devices=jax.devices()[:1])
    kw = dict(mu_dtype=jnp.bfloat16, nu_dtype=jnp.bfloat16) if lean else {}
    return jts.ShardedTrainStep(
        jcfg, mesh, optimizer=jts.default_optimizer(
            learning_rate=1e-2, warmup_steps=2, total_steps=6, **kw))


@pytest.mark.parametrize("lean", [False, True])
def test_train_step_matches_jax(lean):
    """Three steps from the same state (the first at learning rate 0,
    the warmup's start) on the same batches: losses to rtol 1e-5 and
    grad norms to 1e-4; each param's change over the steps within
    1e-3 x lr of the reference's where moments are fp32
    (Adam divides each gradient by its own running RMS, so a small
    gradient's summation-order error, relative to itself, reaches its
    update), and within 2^-7 x lr per moving step where mu and nu are
    stored in bf16 (a moment that rounds the other way moves an update by
    up to 2^-8 relative, mu and nu each)."""
    jcfg = tiny_jax(fused_ce=True, use_flash=True)
    tcfg = port_config(jcfg)
    jstep = _jax_train_step(jcfg, lean)
    jstate = jstep.init(jax.random.key(5))
    ptd = torch.bfloat16 if lean else None
    tstep = tts.ShardedTrainStep(
        tcfg, mesh={"fsdp": 1}, device="cpu",
        optimizer=tts.default_optimizer(learning_rate=1e-2, warmup_steps=2,
                                        total_steps=6, mu_dtype=ptd,
                                        nu_dtype=ptd))
    tstate = tts.state_from_numpy(_numpy(jstate), tcfg, device="cpu")
    assert tstate["step"] == 0
    start = _flat(jstate["params"])
    for i in range(3):
        batch = _batch(10 + i)
        jstate, jm = jstep.step(jstate, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        tstate, tm = tstep.step(tstate, batch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert tm["step"] == int(jm["step"]) == i + 1
    # Steps 2 and 3 move the params (lr 0.5e-2, then 1e-2).
    tol = 2 * 2.0 ** -7 * 1e-2 if lean else 1e-3 * 1e-2
    want, got = _flat(jstate["params"]), _port_flat(tstate["params"])
    for name, w in want.items():
        moved = w - start[name]
        assert np.abs(moved).max() > 1e-3, name
        assert np.abs((got[name] - start[name]) - moved).max() <= tol, name
    adam = tstate["opt_state"][1][0]
    assert adam.count == 3 and tstate["opt_state"][1][2].count == 3
    assert adam.mu["tok_embed"].dtype == (ptd or torch.float32)
    np.testing.assert_allclose(
        tstep.eval_step(tstate["params"], _batch(20)).item(),
        float(jstep.eval_step(jstate["params"], {
            k: jnp.asarray(v) for k, v in _batch(20).items()})),
        rtol=1e-3)


def test_train_step_first_step_keeps_params():
    """lr is 0 at count 0 of the warmup: the first step moves no param."""
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, fused_ce=True)
    ts = tts.ShardedTrainStep(cfg, device="cpu")
    state = ts.init(1)
    new, metrics = ts.step(state, _batch(1, vocab=cfg.vocab_size))
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    for a, b in zip(toptim.tree_leaves(state["params"]),
                    toptim.tree_leaves(new["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mesh", [{"data": 2}, {"stage": 1}])
def test_sharded_meshes_raise_until_ported(mesh):
    with pytest.raises(NotImplementedError):
        tts.ShardedTrainStep(ttf.TransformerConfig.tiny(), mesh=mesh,
                             device="cpu")


def test_bench_run_once_on_cpu():
    """The bench's step loop at the tiny config on the CPU: finite loss,
    positive rates."""
    mfu, tok_s, loss = tbench._run_once(ttf.TransformerConfig.tiny(), 2, 32,
                                        2, "cpu")
    assert np.isfinite(loss) and tok_s > 0 and mfu > 0


def test_bench_peak_table():
    assert tbench._peak_flops(torch.device("cpu")) == 1e12
    assert tbench._PEAK_FLOPS["h100"] == 989e12
    assert tbench._PEAK_FLOPS["h100pcie"] == 756e12
