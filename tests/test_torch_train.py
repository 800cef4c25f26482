"""The port's training path against the JAX reference, on the CPU.

`loss_fn` (fused and unfused cross-entropy, with and without a mask and
remat) in value and gradient against `jax.value_and_grad`, and
`ShardedTrainStep` for three steps against the reference's on a
one-device mesh, both starting from the reference's state carried across
with `state_from_numpy`; the same for a mixture-of-experts model (4
experts, top 2) at capacity factors 1.25, where drops bind, and 8.0.
JAX runs its Pallas flash kernels in interpret mode; the port's CPU path
runs their plain versions.

The remat policies ("full", "dots", "save_attn", "dots_no_mlp"): each
gives the reference's loss and gradients under the same policy, dense
and MoE, and the port's own "full" and no-remat values bit for bit
(remat changes no value).  What each policy runs again in the backward
is counted: the products of an activation by a layer weight (a
TorchDispatchMode over mm / bmm) and the flash forward's calls (its
plain version, the CPU route).  The port keeps what the reference's
policies document; the reference itself re-runs the flash forward under
every policy, which a test pins from its grad jaxpr (ROADMAP.md, Queue
C).
"""

import collections
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
tmoe = importlib.import_module(f"{PORT}.models.moe")
tat = importlib.import_module(f"{PORT}.ops.attention")

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


def _port_value_and_grads(params, batch, tcfg):
    """The port's (loss, {name: gradient}) at `params` on a numpy batch."""
    live = toptim.tree_map(lambda p: p.detach().requires_grad_(), params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = ttf.loss_fn(live, tb, tcfg)
    assert loss.dtype == torch.float32
    grads = toptim.tree_unflatten(live, list(torch.autograd.grad(
        loss, toptim.tree_leaves(live))))
    return loss.item(), _port_flat(grads)


def _value_and_grads(jcfg, jparams, batch):
    """(loss, grads) of the reference and of the port, the port's params
    carried across from the reference's, grads as flat {name: array}."""
    jl, jg = jax.value_and_grad(jtf.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tcfg = port_config(jcfg)
    params = ttf.params_from_numpy(_numpy(jparams), tcfg, device="cpu")
    return (float(jl), _flat(jg)), _port_value_and_grads(params, batch,
                                                        tcfg)


def _assert_close(tl, got, jl, want):
    """fp32: loss to 1e-5 relative, every gradient to 1e-4 of its largest
    magnitude."""
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(want) == set(got)
    for name, w in want.items():
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(got[name] - w).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("fused_ce", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_value_and_grad_match_jax(fused_ce, mask, remat):
    """fp32: loss to 1e-5 relative, every gradient to 1e-4 of its
    largest magnitude (the same arithmetic summed in other orders; the
    fused path rounds x and dlogits to bf16 on both sides)."""
    jcfg = tiny_jax(fused_ce=fused_ce, remat=remat, use_flash=True)
    (jl, want), (tl, got) = _value_and_grads(
        jcfg, jtf.init_params(jcfg, jax.random.key(3)),
        _batch(4, mask=mask))
    _assert_close(tl, got, jl, want)


def _moe_jax(**kw):
    return tiny_jax(**{**dict(num_experts=4, num_experts_per_token=2), **kw})


@pytest.fixture
def drops(monkeypatch):
    """Records, per capacity-route call, whether the capacity dropped a
    pair: the output differs from the same call at a capacity that holds
    every pair."""
    seen = []
    real = tmoe.moe_ffn

    def moe_ffn(x, *args, **kw):
        out = real(x, *args, **kw)
        with torch.no_grad():
            roomy = real(x, *args, **{**kw, "capacity_factor": 100.0})
        seen.append(not torch.equal(out[0], roomy[0]))
        return out

    monkeypatch.setattr(ttf, "moe_ffn", moe_ffn)
    return seen


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("fused_ce", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_fn_value_and_grad_match_jax(capacity_factor, fused_ce,
                                              mask, remat, drops):
    """MoE (4 experts, top 2, 64 tokens): cross-entropy plus
    router_aux_coef x the aux's mean over layers, and every gradient
    (through the router's top-k renormalisation, the aux's mean
    probabilities, the dispatch gather, whose backward accumulates a
    token's at most k slots, and the combine's dtype-rounded gates), as
    test_loss_fn_value_and_grad_match_jax holds the dense model: fp32,
    loss to 1e-5 relative, gradients to 1e-4 of their largest magnitude.
    At capacity factor 1.25 some pairs are dropped (gate 0, slot 0 read),
    at 8.0 none."""
    jcfg = _moe_jax(capacity_factor=capacity_factor, fused_ce=fused_ce,
                    remat=remat, use_flash=True)
    (jl, want), (tl, got) = _value_and_grads(
        jcfg, jtf.init_params(jcfg, jax.random.key(3)),
        _batch(4, mask=mask))
    assert any(drops) == (capacity_factor == 1.25)
    assert {"blocks/router", "blocks/we_gate", "blocks/we_up",
            "blocks/we_down"} <= set(got)
    _assert_close(tl, got, jl, want)


def test_moe_loss_fn_bf16_matches_jax():
    """bf16 activations (fp32 params, router and statistics), fused CE,
    full remat, capacity factor 1.25: loss to 2e-3 relative and every
    gradient to 3e-2 of its largest magnitude.  Both sides round the same
    tensors to bf16 but compute attention apart (the reference's Pallas
    kernel in interpret mode, the port's plain version), so values that
    land near a bf16 rounding boundary round apart: 2^-8 relative per
    rounding, carried through two layers and the backward."""
    jcfg = _moe_jax(dtype=jnp.bfloat16, fused_ce=True, use_flash=True)
    (jl, want), (tl, got) = _value_and_grads(
        jcfg, jtf.init_params(jcfg, jax.random.key(3)), _batch(4))
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    for name, w in want.items():
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(got[name] - w).max() <= 3e-2 * scale, name


MODELS = {"dense": {}, "moe": dict(num_experts=4, num_experts_per_token=2)}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("policy", ["dots", "save_attn", "dots_no_mlp"])
def test_policy_matches_reference_and_full(policy, model):
    """Under `policy` (fp32, fused CE): the reference's loss and gradients
    under the same policy, within _assert_close's bounds, and the port's
    own "full" and no-remat values bit for bit."""
    jcfg = tiny_jax(fused_ce=True, use_flash=True, remat=True,
                    remat_policy=policy, **MODELS[model])
    jparams = jtf.init_params(jcfg, jax.random.key(3))
    batch = _batch(4)
    (jl, want), (tl, got) = _value_and_grads(jcfg, jparams, batch)
    _assert_close(tl, got, jl, want)
    tcfg = port_config(jcfg)
    params = ttf.params_from_numpy(_numpy(jparams), tcfg, device="cpu")
    for other in (dataclasses.replace(tcfg, remat_policy="full"),
                  dataclasses.replace(tcfg, remat=False)):
        ol, og = _port_value_and_grads(params, batch, other)
        assert ol == tl
        assert all(np.array_equal(og[n], got[n]) for n in got)


# Per layer, the weight products and flash forwards each policy runs again
# in the backward (the table of models/remat.py).  w_down's product feeds
# only the residual sum: no policy runs it again.
ATTN = {"wq": 1, "wk": 1, "wv": 1, "wo": 1}
DENSE_MLP = {"w_gate": 1, "w_up": 1}
MOE_FFN = {"router": 1, "we_gate": 1, "we_up": 1, "we_down": 1}
EXPERTS = {"we_gate": 1, "we_up": 1, "we_down": 1}
RECOMPUTED = {
    # policy: (dense products, MoE products, flash forwards)
    None: ({}, {}, 0),
    "full": ({**ATTN, **DENSE_MLP}, {**ATTN, **MOE_FFN}, 1),
    "dots": ({}, EXPERTS, 1),
    "save_attn": ({**ATTN, **DENSE_MLP}, {**ATTN, **MOE_FFN}, 0),
    "dots_no_mlp": (DENSE_MLP, MOE_FFN, 0),
}


class _WeightProducts(TorchDispatchMode):
    """Counts mm / bmm calls whose second operand is a layer weight as the
    forward multiplies by it (the stored [in, out] tensor itself; the
    backward's products take it transposed, or take no weight)."""

    def __init__(self, weights):
        super().__init__()
        self.weights = weights              # {data_ptr: name}
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            w = args[1]
            name = self.weights.get(w.data_ptr())
            if name is not None and w.is_contiguous():
                self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("policy", [None, "full", "dots", "save_attn",
                                    "dots_no_mlp"])
def test_recompute_counts(policy, model, monkeypatch):
    """The forward multiplies by every layer weight once and runs the
    flash forward once per layer; the backward runs again exactly what
    RECOMPUTED lists for the policy (None: no remat)."""
    cfg = port_config(tiny_jax(fused_ce=True, use_flash=True,
                               remat=policy is not None,
                               remat_policy=policy or "full",
                               **MODELS[model]))
    params = ttf.init_params(cfg, seed=1, device="cpu")
    weights = {}
    for name, stacked in params["blocks"].items():
        if stacked.dim() >= 3:  # matrices, not the norms' [L, h]
            weights.update({t.data_ptr(): name for t in stacked.unbind(0)})
    calls = collections.Counter()
    plain = tat.flash_attention_chunk_plain

    def counted(*args, **kw):
        calls["flash"] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(tat, "flash_attention_chunk_plain", counted)
    L = cfg.num_layers
    forward = _WeightProducts(weights)
    backward = _WeightProducts(weights)
    with forward:
        live = toptim.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = ttf.loss_fn(live, {"tokens": torch.from_numpy(
            _batch(4)["tokens"])}, cfg)
    assert calls["flash"] == L
    assert forward.counts == {n: L for n in set(weights.values())}
    calls.clear()
    with backward:
        torch.autograd.grad(loss, toptim.tree_leaves(live))
    dense, moe, flash = RECOMPUTED[policy]
    want = moe if cfg.num_experts else dense
    assert dict(backward.counts) == {n: L * c for n, c in want.items()}
    assert calls["flash"] == L * flash


def _reference_counts(jaxpr):
    """pallas_call and dot_general equations of a jaxpr, recursively
    (scan and checkpoint bodies once each, the Pallas kernels' own dots
    included)."""
    n = collections.Counter()
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("pallas_call", "dot_general"):
            n[eqn.primitive.name] += 1
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    n.update(_reference_counts(inner))
    return n


@pytest.mark.parametrize("policy,pallas,dots", [
    (None, 3, 33), ("full", 4, 41), ("save_attn", 4, 41),
    ("dots_no_mlp", 4, 40), ("dots", 4, 35)])
def test_reference_policies_rerun_the_flash_forward(policy, pallas, dots):
    """The reference's fault, pinned from its grad jaxpr (2 layers, the
    scan body counted once): no remat has the flash forward, dq and dk/dv
    (3 pallas_calls); every policy adds the forward's re-run (4), even
    "save_attn", whose names attn_out / attn_lse sit inside the kernel's
    custom_vjp rule where the checkpoint policy never sees them.
    "save_attn" recomputes all that "full" does (41 dots: the 33 of no
    remat, 6 layer products and the kernel's own 2), "dots_no_mlp" keeps
    only attn_proj (40), "dots" only skips the 6 products (35)."""
    jcfg = tiny_jax(use_flash=True, remat=policy is not None,
                    remat_policy=policy or "full")
    params = jtf.init_params(jcfg, jax.random.key(0))
    batch = {"tokens": jnp.zeros((2, 33), jnp.int32)}
    jaxpr = jax.make_jaxpr(jax.grad(
        lambda p, b: jtf.loss_fn(p, b, jcfg)))(params, batch)
    n = _reference_counts(jaxpr.jaxpr)
    assert (n["pallas_call"], n["dot_general"]) == (pallas, dots)


def test_unknown_remat_policy_raises():
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32,
                                     remat_policy="everything")
    params = ttf.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="everything"):
        ttf.loss_fn(params, {"tokens": torch.zeros((1, 9), dtype=torch.long)},
                    cfg)


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


@pytest.mark.parametrize("lean", [False, True])
def test_moe_train_step_matches_jax(lean):
    """Three ShardedTrainStep steps of the MoE model (capacity factor
    1.25, full remat) against the reference's, with the tolerances of
    test_train_step_matches_jax: the router and the three expert tensors
    are carried, differentiated and updated like every other param.
    Unfused CE, so that nothing rounds to bf16: the fused CE rounds x and
    dlogits to bf16, a value near a rounding boundary then differs by
    2^-8, and Adam divides each gradient by its own RMS, which carries a
    small expert gradient's error (an expert sees few tokens) into its
    update whole."""
    jcfg = _moe_jax(use_flash=True)
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
    assert tstate["opt_state"][1][0].mu["blocks"]["we_down"].shape == (
        2, 4, 64, 32)
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
    tol = 2 * 2.0 ** -7 * 1e-2 if lean else 1e-3 * 1e-2
    want, got = _flat(jstate["params"]), _port_flat(tstate["params"])
    assert set(want) == set(got)
    for name, w in want.items():
        moved = w - start[name]
        assert np.abs(moved).max() > 1e-3, name
        assert np.abs((got[name] - start[name]) - moved).max() <= tol, name


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


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so that
    lm_logits takes its card branch."""

    @property
    def is_cuda(self):
        return True


def test_lm_logits_under_autograd_takes_a_differentiable_product(
        monkeypatch):
    """On a bf16 CUDA tensor lm_logits uses mm's fp32-output form only
    where no gradient flows: that form has no derivative, and the
    unfused cross-entropy's bf16 train step on the card raised "derivative
    for aten::mm is not implemented" (ROADMAP Queue C).  Under
    autograd it takes the widened product, so its logits and gradients
    are the CPU path's bit for bit.  The fp32-output form is stood in for
    by the widened product without a graph."""
    cfg = ttf.TransformerConfig.tiny()
    assert cfg.dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, cfg.hidden_size, generator=gen)
    w = torch.randn(cfg.vocab_size, cfg.hidden_size, generator=gen)
    real_mm = torch.mm
    fp32_out = []

    def mm(a, b, *args, **kw):
        fp32_out.append("out_dtype" in kw)
        if "out_dtype" in kw:
            with torch.no_grad():
                return real_mm(a.float(), b.float())
        return real_mm(a, b, *args, **kw)

    monkeypatch.setattr(torch, "mm", mm)
    with torch.no_grad():
        ttf.lm_logits(torch.Tensor._make_subclass(_OnCard, x),
                      torch.Tensor._make_subclass(_OnCard, w), cfg)
    assert fp32_out == [True]
    wc = torch.Tensor._make_subclass(_OnCard, w, True)
    got = ttf.lm_logits(torch.Tensor._make_subclass(_OnCard, x), wc, cfg)
    assert fp32_out == [True]  # the card branch took no fp32-output mm
    wp = w.clone().requires_grad_()
    want = ttf.lm_logits(x, wp, cfg)
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    (got * want.detach()).sum().backward()
    (want * want.detach()).sum().backward()
    assert torch.equal(wc.grad.as_subclass(torch.Tensor), wp.grad)


@pytest.mark.parametrize("mesh", [{"fsdp": 2}, {"stage": 1}])
def test_sharded_meshes_raise_until_ported(mesh):
    """stage waits for its slice (NotImplementedError); fsdp is ported
    (tests/test_torch_sharded_train.py trains it on gloo ranks), and in
    one process {fsdp: 2} names two devices, which is no one-process
    mesh (ValueError)."""
    if "fsdp" in mesh:
        with pytest.raises(ValueError, match="not divisible"):
            tts.ShardedTrainStep(ttf.TransformerConfig.tiny(), mesh=mesh,
                                 device="cpu")
        return
    with pytest.raises(NotImplementedError, match="pipeline slice"):
        tts.ShardedTrainStep(ttf.TransformerConfig.tiny(), mesh=mesh,
                             device="cpu")


def test_bench_run_once_on_cpu():
    """The bench's step loop at the tiny config on the CPU: finite loss,
    positive rates."""
    mfu, tok_s, loss = tbench._run_once(ttf.TransformerConfig.tiny(), 2, 32,
                                        2, "cpu")
    assert np.isfinite(loss) and tok_s > 0 and mfu > 0


def test_bench_peak_table(monkeypatch):
    """The bench reads its peak from device_stats' table, by torch's
    device name, longest key first."""
    assert tbench._peak_flops(torch.device("cpu")) == 1e12
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA H100 PCIe", 756e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, name=name: name)
        assert tbench._peak_flops(torch.device("cuda")) == peak
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other GPU")
    with pytest.raises(ValueError):
        tbench._peak_flops(torch.device("cuda"))
