"""The port's fused cross-entropy against the JAX reference, on the CPU.

Same x, w and targets (numpy, from a seed) through
ray_tpu.ops.fused_ce.fused_ce_nll and its port: the NLL and its
gradients in x and w.  Both round x and dlogits to bf16 and take fp32
products of the bf16 operands, so what differs is summation order:
nll to 1e-5 relative, dx and dw to 1e-4 of their largest magnitude.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import fused_ce as jce

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
tce = importlib.import_module(f"{PORT}.ops.fused_ce")


@pytest.mark.parametrize("vocab", [1, 7, 4096, 5000, 8192, 12289, 32000,
                                   50257, 128256])
def test_pick_chunks_matches_reference(vocab):
    assert tce._pick_chunks(vocab) == jce._pick_chunks(vocab)
    assert vocab % tce._pick_chunks(vocab) == 0


def test_pick_chunks_headline_vocab():
    assert tce._pick_chunks(32000) == 5  # 5 chunks of 6400


@pytest.mark.parametrize("w_dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("V", [8200, 300])
def test_fused_ce_matches_jax(V, w_dtype):
    """V = 8200 walks two chunks of 4100, V = 300 one; weights per row
    stand in for a mask and a mean; w in fp32 (the master) or bf16."""
    rng = np.random.default_rng(V)
    T, h = 24, 32
    x = rng.standard_normal((T, h)).astype(np.float32)
    w = (rng.standard_normal((V, h)) / np.sqrt(h)).astype(np.float32)
    tgt = rng.integers(0, V, size=T).astype(np.int32)
    tgt[0], tgt[1] = 0, V - 1  # the first and last rows of the table
    row_w = rng.random(T).astype(np.float32)
    jw = jnp.asarray(w, dtype=jnp.bfloat16 if w_dtype == "bfloat16"
                     else jnp.float32)

    def jloss(x, w):
        nll = jce.fused_ce_nll(x, w, jnp.asarray(tgt))
        return jnp.sum(nll * row_w), nll

    (_, jnll), (jdx, jdw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jw)

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        torch.bfloat16 if w_dtype == "bfloat16" else torch.float32
    ).requires_grad_(True)
    nll = tce.fused_ce_nll(tx, tw, torch.from_numpy(tgt))
    assert nll.dtype == torch.float32 and nll.shape == (T,)
    (nll * torch.from_numpy(row_w)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jnll),
                               rtol=1e-5)
    assert tx.grad.dtype == torch.float32 and tw.grad.dtype == tw.dtype
    for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max() + (
            2 ** -8 * np.abs(want).max() if tw.dtype == torch.bfloat16
            else 0.0), err
