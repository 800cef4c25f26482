"""The port's transformer against the JAX reference, on the CPU.

Same inputs (made with numpy from a seed) and the same weights (the JAX
params carried across with params_from_numpy) go through
ray_tpu.models.transformer and its port.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
ttf = importlib.import_module(f"{PORT}.models.transformer")

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_config(jcfg):
    """The port's TransformerConfig with the reference config's fields."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jtf.TransformerConfig)}
    kw["dtype"] = _DTYPES[kw["dtype"]]
    kw["param_dtype"] = _DTYPES[kw["param_dtype"]]
    return ttf.TransformerConfig(**kw)


def tiny_jax(dtype=jnp.float32, use_flash=False):
    return jtf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64, dtype=dtype,
        use_flash=use_flash)


def port_params(jparams, tcfg):
    return ttf.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_matches_jax_fp32(monkeypatch, use_flash):
    """fp32 logits within 1e-4: the same float32 arithmetic summed in
    another order (JAX's flash path runs the Pallas kernel in interpret
    mode, the port's CPU path its plain version)."""
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    jcfg = tiny_jax(use_flash=use_flash)
    tcfg = port_config(jcfg)
    jparams = jtf.init_params(jcfg, jax.random.key(0))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    want = np.asarray(jtf.forward(jparams, jnp.asarray(tokens), jcfg))
    got = ttf.forward(port_params(jparams, tcfg), torch.from_numpy(tokens),
                      tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_forward_matches_jax_bf16():
    """bf16 activations: the two frameworks round matmul outputs and
    norms to bf16 at slightly different points, so logits agree to 3%
    of their largest magnitude (bf16 keeps 8 mantissa bits, ~0.4%
    per rounding, over two layers of rounded residual updates)."""
    jcfg = tiny_jax(dtype=jnp.bfloat16)
    tcfg = port_config(jcfg)
    jparams = jtf.init_params(jcfg, jax.random.key(1))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = np.asarray(jtf.forward(jparams, jnp.asarray(tokens), jcfg))
    got = ttf.forward(port_params(jparams, tcfg), torch.from_numpy(tokens),
                      tcfg).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.03 * scale


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm_matches_jax(dtype):
    """Exact in fp32 up to summation order (1e-6); bf16 results are
    rounded to bf16 after the same fp32 statistics (one bf16 ulp)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(jtf.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w),
                                   1e-5).astype(jnp.float32))
    tdt = _DTYPES[dtype]
    got = ttf.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                       1e-5).float().numpy()
    tol = 1e-6 if dtype == jnp.float32 else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_rope_freqs_and_apply_rope_match_jax():
    """cos/sin tables to 1e-5 (fp32 pow/cos/sin libraries differ in the
    last ulps at angles up to max_len); the rotation to 1e-5."""
    cos_j, sin_j = jtf.rope_freqs(16, 64, 10000.0)
    cos_t, sin_t = ttf.rope_freqs(16, 64, 10000.0, device="cpu")
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-5)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-5)

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 64, size=(2, 7)).astype(np.int32)
    want = np.asarray(jtf.apply_rope(jnp.asarray(x), cos_j, sin_j,
                                     jnp.asarray(pos)))
    got = ttf.apply_rope(torch.from_numpy(x), cos_t, sin_t,
                         torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # bf16 in, fp32 rotation, bf16 out.
    xb = torch.from_numpy(x).bfloat16()
    assert ttf.apply_rope(xb, cos_t, sin_t,
                          torch.from_numpy(pos)).dtype == torch.bfloat16


@pytest.mark.parametrize("preset", ["llama2_7b", "tiny"])
def test_num_params_and_flops_match_reference(preset):
    jcfg = getattr(jtf.TransformerConfig, preset)()
    tcfg = getattr(ttf.TransformerConfig, preset)()
    assert ttf.num_params(tcfg) == jtf.num_params(jcfg)
    assert ttf.flops_per_token(tcfg, 1024) == jtf.flops_per_token(jcfg, 1024)
    if preset == "llama2_7b":  # Llama-2-7B with its head tied to the embedding
        assert ttf.num_params(tcfg) == 6_607_343_616


def test_init_params_layout_matches_reference():
    jcfg = tiny_jax()
    tcfg = port_config(jcfg)
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jtf.init_params(jcfg, jax.random.key(0)))
    tparams = ttf.init_params(tcfg, seed=0, device="cpu",
                              dtype=torch.bfloat16)
    tshapes = {"tok_embed": tuple(tparams["tok_embed"].shape),
               "final_norm": tuple(tparams["final_norm"].shape),
               "blocks": {k: tuple(v.shape)
                          for k, v in tparams["blocks"].items()}}
    assert tshapes == jshapes
    assert tparams["blocks"]["wq"].dtype == torch.bfloat16
    again = ttf.init_params(tcfg, seed=0, device="cpu", dtype=torch.bfloat16)
    assert torch.equal(again["blocks"]["w_down"],
                       tparams["blocks"]["w_down"])


def test_entry_points_need_a_device_or_an_explicit_cpu():
    """With no CUDA device, the default device raises instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.init_params(ttf.TransformerConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.rope_freqs(16, 8, 10000.0)


@pytest.mark.parametrize("kw", [dict(ring_attention=True)])
def test_later_slices_raise_not_implemented(kw):
    """Ring attention raises as soon as params are made."""
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, **kw)
    with pytest.raises(NotImplementedError):
        params = ttf.init_params(cfg, device="cpu")
        ttf.loss_fn(params, {"tokens": torch.zeros((1, 5), dtype=torch.long)},
                    cfg)
