"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `cuda` marker and skips, from inside the
`cuda` fixture, on a host without a CUDA device.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Shapes are small and odd on purpose (page 4, KD = 32, prime batches, head
dims that are not powers of two), beside one Llama-2-7B-shaped case per
kernel.  The last tests hold the decode's CUDA graphs to the eager
functions bit for bit, count kernel launches through replays, show that
the engine's dispatches wait on nothing (sync debug mode "error") and run
the pipelined and speculative engines against the classic one; the same
holds for an MoE model (replay = eager, dispatches without a sync), and
the exact MoE route's graph-safe form meets the gathering form at bf16.
Training: a tiny train step (dense and MoE) on the card against the
CPU, and each remat policy's gradients and flash launches.  Last, the
port's runtime on the card: a num_gpus=1 task sees the card and a CPU
task none, CUDA tensors come back from the object store bit for bit, and
a fresh GPU actor's first torch_trace holds kernels; then the serve plane:
a tiny bf16 LLMServer replica's handle and HTTP streams agree, and a bf16
KV bundle crosses between two replicas that share the card; then the
Train library: a num_gpus=1 TorchTrainer worker launches the Hopper flash
kernels with the test process's losses, load_pytree puts a state back on
the card bit for bit, and a placement group's GPU bundle gives a worker
that sees the card.
"""

import ctypes
import dataclasses
import importlib
import json
import math
import os

import numpy as np
import pytest
import torch


# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
ttf = importlib.import_module(f"{PORT}.models.transformer")
tat = importlib.import_module(f"{PORT}.ops.attention")
tpa = importlib.import_module(f"{PORT}.ops.paged_attention")
tse = importlib.import_module(f"{PORT}.serve.llm_engine")
tce = importlib.import_module(f"{PORT}.ops.fused_ce")
tts = importlib.import_module(f"{PORT}.train.train_state")
toptim = importlib.import_module(f"{PORT}.train.optim")
_build = importlib.import_module(f"{PORT}.ops._build")
tds = importlib.import_module(f"{PORT}.util.device_stats")

pytestmark = pytest.mark.cuda

# Tolerances, kernel vs plain version on the same inputs.  float32: the
# two sum in different orders (~1e-6 relative).  bfloat16: both round p
# to 8 mantissa bits before P*V, the kernel against its running max and
# the plain version against the row's max, and both round the output.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # Every kernel built before a test starts (a no-op once built), so
    # that no engine's first step waits on nvcc past its queue timeout.
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, device):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


def _launches(kernels):
    """Launches of one op, summed over the kernels that compute it."""
    return sum(k.launches for k in kernels)


def _bwd_launches():
    return (_launches(tat.FLASH_BWD_DQ_KERNELS),
            _launches(tat.FLASH_BWD_DKV_KERNELS))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,D,page,W", [
    (7, 4, 2, 16, 4, 5),       # KD = 32, page 4, prime batch
    (5, 8, 1, 32, 4, 3),       # G = 8
    (3, 12, 1, 48, 8, 4),      # G = 12: two head chunks, D not pow-2
    (4, 32, 32, 128, 128, 3),  # Llama-2-7B heads
    (3, 16, 4, 128, 16, 6),    # GQA serve shape
    (3, 8, 2, 64, 16, 40),     # 640-token tables: three context splits
])
def test_paged_decode_matches_plain(cuda, dtype, B, H, KVH, D, page, W):
    rng = np.random.default_rng(B * 100 + D)
    P = B * W + 2
    q = _rand(rng, (B, H, D), dtype, cuda)
    kp = _rand(rng, (P, page, KVH * D), dtype, cuda)
    vp = _rand(rng, (P, page, KVH * D), dtype, cuda)
    tables = torch.from_numpy(rng.permutation(P - 1)[:B * W].reshape(
        B, W).astype(np.int32)).to(cuda)
    ctx = rng.integers(1, W * page + 1, size=B).astype(np.int32)
    ctx[0] = 0  # a row with no context returns zeros
    ctx = torch.from_numpy(ctx).to(cuda)
    got = tpa.paged_attention(q, kp, vp, tables, ctx)
    torch.cuda.synchronize()
    want = tpa.paged_attention_plain(q, kp, vp, tables, ctx)
    assert got.dtype == dtype and got.shape == (B, H, D)
    assert torch.all(got[0] == 0)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_on_flat_layer_view(cuda, dtype):
    """Layer l of a [L, P, page, KD] cache through its flat [L*P, ...]
    view with tables + l*P, as decode_step calls it."""
    rng = np.random.default_rng(3)
    L, P, page, KVH, D, B = 3, 9, 4, 2, 16, 5
    cache = _rand(rng, (L, P, page, KVH * D), dtype, cuda)
    flat = cache.view(L * P, page, KVH * D)
    q = _rand(rng, (B, 2 * KVH, D), dtype, cuda)
    tables = torch.from_numpy(
        rng.integers(0, P, size=(B, 2)).astype(np.int32)).to(cuda)
    ctx = torch.from_numpy(
        rng.integers(1, 2 * page + 1, size=B).astype(np.int32)).to(cuda)
    for layer in range(L):
        got = tpa.paged_attention(q, flat, flat, tables + layer * P, ctx)
        want = tpa.paged_attention_plain(q, cache[layer], cache[layer],
                                         tables, ctx)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dtype], (layer, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KVH,D,page", [(7, 2, 16, 4), (11, 32, 128, 128),
                                          (5, 3, 5, 4)])
def test_row_write_bit_exact(cuda, dtype, B, KVH, D, page):
    """Bit-identical to index_put_ everywhere but the scratch page FP-1,
    where the dropped rows race."""
    rng = np.random.default_rng(B)
    W, FP = 3, 3 * B + 2
    kp = _rand(rng, (FP, page, KVH * D), dtype, cuda)
    vp = _rand(rng, (FP, page, KVH * D), dtype, cuda)
    kn = _rand(rng, (B, KVH, D), dtype, cuda)
    vn = _rand(rng, (B, KVH, D), dtype, cuda)
    tables = torch.from_numpy(rng.permutation(FP - 1)[:B * W].reshape(
        B, W).astype(np.int32)).to(cuda)
    pos = rng.integers(0, W * page, size=B).astype(np.int32)
    pos[1] = -1  # dropped: goes to the scratch page
    pos = torch.from_numpy(pos).to(cuda)
    k2, v2 = kp.clone(), vp.clone()
    tpa.write_token_rows(kp, vp, kn, vn, tables, pos)
    tpa.write_token_rows_plain(k2, v2, kn, vn, tables, pos)
    torch.cuda.synchronize()
    assert torch.equal(kp[:-1], k2[:-1]) and torch.equal(vp[:-1], v2[:-1])


ROPE_CASES = {
    # name: (B, H, KVH, D, page, W); 16-byte vectors unless noted.
    "gqa_prime": (7, 4, 2, 16, 4, 3),
    "narrow": (5, 4, 2, 8, 4, 3),        # bf16 halves of 8 bytes: scalar
    "odd_half": (3, 2, 1, 6, 4, 2),      # D / 2 = 3: scalar in both dtypes
    "llama_classic": (8, 32, 32, 128, 128, 8),
    "llama_pipelined": (16, 32, 32, 128, 128, 16),
    "gqa_serve": (11, 16, 4, 128, 16, 6),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ROPE_CASES))
def test_rope_row_write_bit_exact(cuda, dtype, case):
    """The rotating row write against its plain version, bit for bit:
    the rotated q, and every page but the scratch page FP-1 (where the
    rows with pos = -1 race).  Idle rows (pos = -1) and one row past its
    table (clamped to the last column) included."""
    B, H, KVH, D, page, W = ROPE_CASES[case]
    rng = np.random.default_rng(B * D)
    FP, max_len = W * B + 2, W * page + 8
    cos, sin = (t.to(cuda) for t in ttf.rope_freqs(D, max_len, 10000.0,
                                                   device="cpu"))
    q = _rand(rng, (B, H, D), dtype, cuda)
    k = _rand(rng, (B, KVH, D), dtype, cuda)
    v = _rand(rng, (B, KVH, D), dtype, cuda)
    kp = _rand(rng, (FP, page, KVH * D), dtype, cuda)
    vp = _rand(rng, (FP, page, KVH * D), dtype, cuda)
    tables = torch.from_numpy(rng.permutation(FP - 1)[:B * W].reshape(
        B, W).astype(np.int32)).to(cuda)
    pos = rng.integers(0, W * page, size=B).astype(np.int32)
    pos[1] = -1
    pos[-1] = W * page + 3  # past the table
    if B > 8:
        pos[5] = -1
    pos = torch.from_numpy(pos).to(cuda)
    k2, v2 = kp.clone(), vp.clone()
    before = tpa.ROPE_ROW_WRITE.launches
    got = tpa.rope_write_token_rows(q, k, v, cos, sin, kp, vp, tables, pos)
    assert tpa.ROPE_ROW_WRITE.launches == before + 1
    want = tpa.rope_write_token_rows_plain(q, k, v, cos, sin, k2, v2,
                                           tables, pos)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(kp[:-1], k2[:-1]) and torch.equal(vp[:-1], v2[:-1])


def test_captured_decode_replays_the_rotating_row_write(cuda):
    """A captured decode step replays the rotating row write, once per
    layer, and never the plain row write; the replay waits on nothing
    (sync debug mode "error"), and equals the eager step."""
    graphs, cache = _graph_setup(cuda, torch.bfloat16)
    snap = _snapshot(graphs, cache)
    graphs.decode_step(8)  # warm-up, capture (synchronizes), replay
    _restore(graphs, cache, snap)
    kernels = (tpa.ROPE_ROW_WRITE, tpa.ROW_WRITE, tpa.PAGED_DECODE)
    before = [k.launches for k in kernels]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed = graphs.decode_step(8).clone()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 0, 2]
    _restore(graphs, cache, snap)
    eager = graphs._step(graphs.state, 8)
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)


FLASH_CASES = {
    # name: (b, sq, sk, h, hk, d, q_off, kv_off, causal)
    "causal": (2, 64, 64, 4, 4, 64, 0, 0, True),
    "noncausal": (2, 64, 64, 4, 4, 64, 0, 0, False),
    "ragged_gqa": (1, 37, 37, 8, 2, 80, 0, 0, True),
    "end_aligned": (1, 40, 100, 2, 2, 16, 60, 0, True),
    "offsets": (1, 48, 64, 2, 1, 32, 100, 70, True),
    "future": (1, 32, 64, 2, 2, 32, 0, 500, True),
    "llama": (1, 200, 200, 32, 32, 128, 0, 0, True),
    # Head dims the bf16 tensor-core kernel does not take (CUDA-core path).
    "odd_dim": (1, 50, 70, 4, 2, 24, 20, 0, True),
    "wide_dim": (1, 40, 40, 2, 2, 192, 0, 0, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_matches_plain(cuda, dtype, case):
    b, sq, sk, h, hk, d, q_off, kv_off, causal = FLASH_CASES[case]
    rng = np.random.default_rng(sq + d)
    q = _rand(rng, (b, sq, h, d), dtype, cuda)
    k = _rand(rng, (b, sk, hk, d), dtype, cuda)
    v = _rand(rng, (b, sk, hk, d), dtype, cuda)
    out, lse = tat.flash_attention_chunk(q, k, v, q_off, kv_off, causal)
    torch.cuda.synchronize()
    o_ref, l_ref = tat.flash_attention_chunk_plain(q, k, v, q_off, kv_off,
                                                   causal)
    masked = l_ref <= tat._NEG_INF / 2
    assert torch.equal(lse <= tat._NEG_INF / 2, masked)
    assert torch.all(lse[masked] == tat._NEG_INF)
    rows = masked.reshape(b, h, sq).any(dim=1)  # [b, sq]
    assert torch.all(out[rows] == 0)
    err = (out.float() - o_ref.float()).abs().max().item()
    assert err <= TOL[dtype], err
    if (~masked).any():
        lerr = (lse[~masked] - l_ref[~masked]).abs().max().item()
        assert lerr <= 1e-4 * math.log(sk + 1) + TOL[dtype], lerr
    if case == "future":
        assert bool(masked.all())


def test_wrappers_raise_on_shapes_they_do_not_take(cuda):
    q = torch.zeros(2, 4, 300, device=cuda)
    pages = torch.zeros(3, 4, 600, device=cuda)
    tables = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    ctx = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention(q, pages, pages, tables, ctx)
    half = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tat.flash_attention(half, half, half)


def test_engine_on_cuda_matches_cpu(cuda):
    """The whole classic path (prefill, prefix-cache chunked prefill,
    decode) through the kernels gives the CPU engine's greedy tokens at
    fp32, and launches every kernel."""
    cfg = ttf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64,
        dtype=torch.float32)
    params = ttf.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 64, size=8).tolist()
    prompts = [rng.integers(0, 64, size=n).tolist() for n in (3, 9, 13)]
    prompts += [prefix + [1, 2], prefix + [3]]
    kw = dict(page_size=4, num_pages=48, max_batch=2)
    want = tse.LLMEngine(cfg, params, device="cpu", **kw).generate(prompts, 7)
    kernels = ((tpa.PAGED_DECODE,), (tpa.ROPE_ROW_WRITE,),
               tat.FLASH_FWD_KERNELS)
    before = [_launches(k) for k in kernels]
    eng = tse.LLMEngine(cfg, params, device=cuda, **kw)
    got = eng.generate(prompts, 7)
    assert got == want
    assert eng.prefix_cache.hits >= 1
    assert all(_launches(k) > b for k, b in zip(kernels, before))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_on_cuda_matches_cpu(cuda, dtype):
    """`forward` with use_flash runs the flash kernel on the card and the
    plain version on the CPU: logits agree to fp32 summation order, or in
    bf16 to 3% of their largest magnitude (bf16 rounding of activations
    at different points in the two attention paths)."""
    cfg = ttf.TransformerConfig.tiny(dtype=dtype, max_seq_len=256)
    params = ttf.init_params(cfg, seed=1, device="cpu", dtype=dtype)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 100)).astype(np.int64))
    on_card = {k: ({n: t.to(cuda) for n, t in v.items()}
                   if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    before = _launches(tat.FLASH_FWD_KERNELS)
    got = ttf.forward(on_card, tokens.to(cuda), cfg)
    want = ttf.forward(params, tokens, cfg)
    assert _launches(tat.FLASH_FWD_KERNELS) == before + cfg.num_layers
    err = (got.cpu() - want).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 0.03 * want.abs().max().item()
    assert err <= tol, err


BWD_CASES = {
    # name: (b, sq, sk, h, hk, d, q_off, kv_off, causal)
    "causal": (2, 128, 128, 4, 4, 64, 0, 0, True),
    "noncausal": (1, 72, 100, 2, 2, 64, 0, 0, False),
    "gqa": (2, 130, 130, 16, 4, 128, 0, 0, True),
    "end_aligned": (1, 40, 100, 2, 2, 32, 60, 0, True),
    # Rows 0..99 see no key (lse = -1e30): zero gradient, no NaN.
    "masked_rows": (1, 160, 96, 4, 2, 64, 100, 200, True),
    "future": (1, 32, 64, 2, 2, 32, 0, 500, True),
    # Head dims the bf16 tensor-core kernels do not take.
    "odd_dim": (1, 50, 70, 4, 2, 24, 20, 0, True),
    "wide_dim": (1, 40, 40, 2, 2, 192, 0, 0, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_matches_plain(cuda, dtype, case):
    """dq, dk, dv of the kernels against flash_attention_chunk_bwd_plain
    on the same saved (out, lse) and cotangents, with a nonzero dlse.
    Tolerance relative to the largest plain gradient: fp32 1e-5 (sums in
    another order); bf16 1e-2 (both round p and ds to bf16 at the same
    points, then the fp32 sums, taken in another order, round to bf16:
    one bf16 ulp, 2^-8, of the largest value)."""
    b, sq, sk, h, hk, d, q_off, kv_off, causal = BWD_CASES[case]
    rng = np.random.default_rng(sq * 7 + d)
    q = _rand(rng, (b, sq, h, d), dtype, cuda)
    k = _rand(rng, (b, sk, hk, d), dtype, cuda)
    v = _rand(rng, (b, sk, hk, d), dtype, cuda)
    dout = _rand(rng, (b, sq, h, d), dtype, cuda)
    dlse = _rand(rng, (b * h, sq), torch.float32, cuda)
    out, lse = tat.flash_attention_chunk(q, k, v, q_off, kv_off, causal)
    scale = 1.0 / math.sqrt(d)
    before = _bwd_launches()
    got = tat._flash_chunk_bwd_cuda(q, k, v, out, lse, dout, dlse, q_off,
                                    kv_off, causal, scale)
    torch.cuda.synchronize()
    assert _bwd_launches() == (before[0] + 1, before[1] + 1)
    want = tat.flash_attention_chunk_bwd_plain(q, k, v, out, lse, dout, dlse,
                                               q_off, kv_off, causal, scale)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    dead = (lse <= tat._NEG_INF / 2).reshape(b, h, sq).all(1)  # [b, sq]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert not torch.isnan(g).any(), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rel * max(w.float().abs().max().item(), 1.0), (name,
                                                                     err)
    assert torch.all(got[0][dead] == 0)
    if case == "future":
        assert all(torch.all(g == 0) for g in got)


def test_flash_backward_through_autograd_on_cuda(cuda):
    """The autograd Function on CUDA tensors launches both backward
    kernels once per call, through out and lse."""
    rng = np.random.default_rng(11)
    q, k, v = (_rand(rng, (1, 64, 4, 64), torch.bfloat16, cuda)
               .requires_grad_() for _ in range(3))
    before = _bwd_launches()
    out, lse = tat.flash_attention_chunk(q, k, v, 0, 0)
    (out.float().square().sum() + lse.sum()).backward()
    assert _bwd_launches() == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


def test_backward_never_allocates_s_by_s(cuda):
    """A causal backward at s = 8192 stays far below the b*h*s^2*4 bytes
    of one fp32 score matrix (the card counterpart of
    tests/test_ops_attention.py::test_backward_never_materializes_s_by_s)."""
    b, s, h, d = 1, 8192, 2, 64
    rng = np.random.default_rng(12)
    q, k, v = (_rand(rng, (b, s, h, d), torch.bfloat16, cuda)
               .requires_grad_() for _ in range(3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = tat.flash_attention(q, k, v, causal=True)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak < b * h * s * s * 4 / 16, peak


def test_train_step_on_cuda_matches_cpu(cuda):
    """ShardedTrainStep at the tiny config in fp32 (full remat, unfused CE
    so that nothing rounds to bf16): two steps on the card (flash
    forward, dq and dk/dv kernels) and two on the CPU (their plain
    versions) from the same params and batches.  Losses to rtol 1e-5
    (fp32, sums in other orders); params to 1e-3 of the learning rate
    (Adam divides each gradient by its own RMS, so a small gradient's
    summation-order error reaches its update)."""
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32)
    opt = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    on_cpu = tts.ShardedTrainStep(cfg, device="cpu",
                                  optimizer=tts.default_optimizer(**opt))
    on_card = tts.ShardedTrainStep(cfg, device=cuda,
                                   optimizer=tts.default_optimizer(**opt))
    cpu_state = on_cpu.init(0)
    params = toptim.tree_map(lambda t: t.to(cuda), cpu_state["params"])
    card_state = {"params": params,
                  "opt_state": on_card.optimizer.init(params), "step": 0}
    kernels = (tat.FLASH_FWD_KERNELS, tat.FLASH_BWD_DQ_KERNELS,
               tat.FLASH_BWD_DKV_KERNELS)
    before = [_launches(k) for k in kernels]
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 65))}
        cpu_state, cm = on_cpu.step(cpu_state, batch)
        card_state, gm = on_card.step(card_state, batch)
        np.testing.assert_allclose(gm["loss"].item(), cm["loss"].item(),
                                   rtol=1e-5)
    L = cfg.num_layers  # forward + remat recompute, then the backward
    assert [_launches(k) - b for k, b in zip(kernels, before)] == [
        4 * L, 2 * L, 2 * L]
    for a, b in zip(toptim.tree_leaves(card_state["params"]),
                    toptim.tree_leaves(cpu_state["params"])):
        assert (a.cpu() - b).abs().max().item() <= 1e-5


def test_fused_ce_on_cuda_matches_cpu(cuda):
    """fused_ce_nll on the card (fp32-output products of bf16 operands)
    against the CPU (bf16 operands widened to fp32): the products are
    exact on both, the sums run in other orders, so nll agrees to 1e-5
    relative; dlogits round to bf16 before the backward products, where
    an order difference can flip a rounding, so dx and dw agree to one
    bf16 ulp (2^-8) of their largest magnitude."""
    rng = np.random.default_rng(5)
    T, h, V = 64, 96, 12800  # two chunks of 6400
    x = _rand(rng, (T, h), torch.bfloat16, "cpu")
    w = _rand(rng, (V, h), torch.float32, "cpu") / math.sqrt(h)
    tgt = torch.from_numpy(rng.integers(0, V, size=T))
    out = {}
    for dev in ("cpu", cuda):
        xd = x.detach().to(dev).requires_grad_()
        wd = w.detach().to(dev).requires_grad_()
        nll = tce.fused_ce_nll(xd, wd, tgt.to(dev))
        nll.sum().backward()
        out[str(dev)] = [t.detach().float().cpu()
                         for t in (nll, xd.grad, wd.grad)]
    (n0, dx0, dw0), (n1, dx1, dw1) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(n1.numpy(), n0.numpy(), rtol=1e-5)
    for a, b in ((dx1, dx0), (dw1, dw0)):
        assert (a - b).abs().max() <= 2 ** -8 * b.abs().max()


def test_moe_train_step_on_cuda_matches_cpu(cuda):
    """test_train_step_on_cuda_matches_cpu for the tiny MoE model (4
    experts, top 2, capacity factor 1.25): two steps on the card and two
    on the CPU from the same params and batches, the same tolerances."""
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, num_experts=4,
                                     num_experts_per_token=2)
    opt = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    on_cpu = tts.ShardedTrainStep(cfg, device="cpu",
                                  optimizer=tts.default_optimizer(**opt))
    on_card = tts.ShardedTrainStep(cfg, device=cuda,
                                   optimizer=tts.default_optimizer(**opt))
    cpu_state = on_cpu.init(0)
    params = toptim.tree_map(lambda t: t.to(cuda), cpu_state["params"])
    card_state = {"params": params,
                  "opt_state": on_card.optimizer.init(params), "step": 0}
    rng = np.random.default_rng(1)
    for _ in range(2):
        batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 65))}
        cpu_state, cm = on_cpu.step(cpu_state, batch)
        card_state, gm = on_card.step(card_state, batch)
        np.testing.assert_allclose(gm["loss"].item(), cm["loss"].item(),
                                   rtol=1e-5)
    for a, b in zip(toptim.tree_leaves(card_state["params"]),
                    toptim.tree_leaves(cpu_state["params"])):
        assert (a.cpu() - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("experts", [0, 4])
@pytest.mark.parametrize("policy", ["full", "dots", "save_attn",
                                    "dots_no_mlp"])
def test_remat_policies_on_cuda(cuda, policy, experts, dtype):
    """Each remat policy on the card: loss and every gradient the same
    bits as with no remat (the re-run computes what the forward did, with
    the same kernels), and the flash forward launched once per layer in
    the forward plus once more in the backward under "full" and "dots"
    (they run it again), not under "save_attn" and "dots_no_mlp" (they
    keep its out and lse); dq and dk/dv once per layer."""
    cfg = ttf.TransformerConfig.tiny(dtype=dtype, fused_ce=True,
                                     num_experts=experts,
                                     remat_policy=policy)
    params = ttf.init_params(cfg, seed=2, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 65))).to(cuda)

    def loss_and_grads(c):
        live = toptim.tree_map(lambda p: p.detach().requires_grad_(),
                               params)
        loss = ttf.loss_fn(live, {"tokens": tokens}, c)
        return loss, torch.autograd.grad(loss, toptim.tree_leaves(live))

    l0, g0 = loss_and_grads(dataclasses.replace(cfg, remat=False))
    kernels = (tat.FLASH_FWD_KERNELS, tat.FLASH_BWD_DQ_KERNELS,
               tat.FLASH_BWD_DKV_KERNELS)
    before = [_launches(k) for k in kernels]
    loss, grads = loss_and_grads(cfg)
    L = cfg.num_layers
    forwards = 2 if policy in ("full", "dots") else 1
    assert [_launches(k) - b for k, b in zip(kernels, before)] == [
        forwards * L, L, L]
    assert torch.equal(loss, l0)
    assert all(torch.equal(a, b) for a, b in zip(grads, g0))


# ---------------------------------------------------------------------------
# The Hopper kernels (TMA-fed wgmma): csrc/flash_fwd_sm90.cu,
# csrc/flash_bwd_dq_sm90.cu and csrc/flash_bwd_sm90.cu, bf16 with head dim
# 64 or 128.
# ---------------------------------------------------------------------------

WGMMA_TILE_TEST = _build.Kernel(
    "flash_fwd_sm90", "wgmma_tile_test",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("mn_major", [False, True])
def test_wgmma_tile_product(cuda, n, mn_major):
    """One 64 x n x 64 product through the kernels' TMA loads, swizzled
    descriptors and wgmma: B K-major from shared memory (as K in Q K^T)
    or MN-major with the transpose bit and A from registers (as V in
    P V).  The products of bf16 values are exact in fp32; only the
    summation order differs from torch.matmul's."""
    rng = np.random.default_rng(n + mn_major)
    a = _rand(rng, (64, 64), torch.bfloat16, cuda)
    b = _rand(rng, (64, n) if mn_major else (n, 64), torch.bfloat16, cuda)
    c = torch.empty((64, n), dtype=torch.float32, device=cuda)
    WGMMA_TILE_TEST.launch(cuda, a.data_ptr(), b.data_ptr(), c.data_ptr(), n,
                           int(mn_major))
    torch.cuda.synchronize()
    want = a.float() @ (b.float() if mn_major else b.float().t())
    assert (c - want).abs().max().item() <= 1e-4 * want.abs().max().item()


SM90_CASES = {
    # name: (b, sq, sk, h, hk, q_off, kv_off, causal); d = 64 and 128.
    # Lengths off the 64/128-row tiles, where TMA fills the edge with zeros.
    "len1": (2, 1, 1, 4, 4, 0, 0, True),
    "len63": (2, 63, 63, 4, 2, 0, 0, True),
    "len65_end_aligned": (1, 65, 129, 4, 4, 64, 0, True),
    "len129_noncausal": (1, 129, 65, 2, 2, 0, 0, False),
    "len1000_gqa2": (1, 1000, 1000, 2, 1, 0, 0, True),
    "noncausal_1000x129": (2, 1000, 129, 4, 4, 0, 0, False),
    # sq < sk with offsets.
    "offsets": (1, 200, 300, 4, 4, 500, 370, True),
    "gqa_32_8": (1, 256, 256, 32, 8, 0, 0, True),
    # Rows 0..99 see no key: out 0, lse -1e30, zero gradient.
    "masked_rows": (1, 160, 96, 4, 2, 100, 200, True),
    # No row sees a key: blocks write the sentinels and load nothing.
    "future": (1, 64, 128, 2, 2, 0, 500, True),
    "no_keys": (1, 33, 0, 2, 2, 0, 0, True),
    # 32 key tiles: the two-stage ring wraps 16 times.
    "long_4096": (1, 4096, 4096, 2, 2, 0, 0, True),
    # 512 forward blocks, 512 dk/dv blocks: several waves on 132 SMs.
    "many_blocks": (4, 512, 512, 32, 32, 0, 0, True),
}


def _sm90_inputs(case, d, device):
    b, sq, sk, h, hk, q_off, kv_off, causal = SM90_CASES[case]
    rng = np.random.default_rng(sq * 31 + sk + d)
    q = _rand(rng, (b, sq, h, d), torch.bfloat16, device)
    k = _rand(rng, (b, sk, hk, d), torch.bfloat16, device)
    v = _rand(rng, (b, sk, hk, d), torch.bfloat16, device)
    return q, k, v, q_off, kv_off, causal


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_sm90_forward_matches_plain(cuda, case, d):
    q, k, v, q_off, kv_off, causal = _sm90_inputs(case, d, cuda)
    b, sq, h = q.shape[:3]
    sk = k.shape[1]
    before = (tat.FLASH_FWD_SM90.launches, tat.FLASH_FWD.launches)
    out, lse = tat.flash_attention_chunk(q, k, v, q_off, kv_off, causal)
    torch.cuda.synchronize()
    assert (tat.FLASH_FWD_SM90.launches, tat.FLASH_FWD.launches) == (
        before[0] + 1, before[1])
    if sk:
        o_ref, l_ref = tat.flash_attention_chunk_plain(q, k, v, q_off,
                                                       kv_off, causal)
    else:  # no keys: every row gets the sentinels (the plain version
        # cannot reduce an empty row)
        o_ref = torch.zeros_like(q)
        l_ref = torch.full((b * h, sq), tat._NEG_INF, device=cuda)
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    masked = l_ref <= tat._NEG_INF / 2
    assert torch.equal(lse <= tat._NEG_INF / 2, masked)
    assert torch.all(lse[masked] == tat._NEG_INF)
    rows = masked.reshape(b, h, sq).any(dim=1)
    assert torch.all(out[rows] == 0)
    err = (out.float() - o_ref.float()).abs().max().item()
    assert err <= TOL[torch.bfloat16], err
    if (~masked).any():
        lerr = (lse[~masked] - l_ref[~masked]).abs().max().item()
        assert lerr <= 1e-4 * math.log(sk + 1) + TOL[torch.bfloat16], lerr
    if case in ("future", "no_keys"):
        assert bool(masked.all())
    if case == "masked_rows":
        assert bool(rows.any())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_sm90_dkv_matches_plain(cuda, case, d):
    """dq, dk and dv (both through the Hopper kernels) against the plain
    backward with a nonzero lse cotangent; tolerance as
    test_flash_bwd_matches_plain's bf16 (1e-2 of the largest plain
    gradient)."""
    q, k, v, q_off, kv_off, causal = _sm90_inputs(case, d, cuda)
    b, sq, h = q.shape[:3]
    sk = k.shape[1]
    rng = np.random.default_rng(d)
    dout = _rand(rng, q.shape, torch.bfloat16, cuda)
    dlse = _rand(rng, (b * h, sq), torch.float32, cuda)
    out, lse = tat.flash_attention_chunk(q, k, v, q_off, kv_off, causal)
    scale = 1.0 / math.sqrt(d)
    kernels = (tat.FLASH_BWD_DKV_SM90, tat.FLASH_BWD_DKV,
               tat.FLASH_BWD_DQ_SM90, tat.FLASH_BWD_DQ)
    before = [kn.launches for kn in kernels]
    got = tat._flash_chunk_bwd_cuda(q, k, v, out, lse, dout, dlse, q_off,
                                    kv_off, causal, scale)
    torch.cuda.synchronize()
    assert [kn.launches - b for kn, b in zip(kernels, before)] == [
        int(sk > 0), 0, 1, 0]
    want = tat.flash_attention_chunk_bwd_plain(q, k, v, out, lse, dout, dlse,
                                               q_off, kv_off, causal, scale)
    dead = (lse <= tat._NEG_INF / 2).reshape(b, h, sq).all(1)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and not torch.isnan(g).any(), name
        if not g.numel():  # no keys: dk and dv are empty
            continue
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 1e-2 * max(w.float().abs().max().item(), 1.0), (name,
                                                                      err)
    assert torch.all(got[0][dead] == 0)
    if case == "future":
        assert all(torch.all(g == 0) for g in got)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(SM90_CASES))
def test_sm90_dq_matches_plain(cuda, case, d):
    """The Hopper dq alone against the plain backward's dq, with a
    nonzero lse cotangent, within 1e-2 of the largest plain dq (both round
    ds to bf16 at the same point; p is not rounded for dq; the fp32 sums,
    taken in another order, round to bf16 once).  Rows that see no key
    come out exactly 0; no NaN."""
    q, k, v, q_off, kv_off, causal = _sm90_inputs(case, d, cuda)
    b, sq, h = q.shape[:3]
    rng = np.random.default_rng(d + 1)
    dout = _rand(rng, q.shape, torch.bfloat16, cuda)
    dlse = _rand(rng, (b * h, sq), torch.float32, cuda)
    out, lse = tat.flash_attention_chunk(q, k, v, q_off, kv_off, causal)
    corr = tat._bwd_corr(out, dout, dlse, b, h, sq)
    scale = 1.0 / math.sqrt(d)
    before = (tat.FLASH_BWD_DQ_SM90.launches, tat.FLASH_BWD_DQ.launches)
    got = tat.flash_bwd_dq(q, k, v, dout, lse, corr, q_off, kv_off, causal,
                           scale)
    torch.cuda.synchronize()
    assert (tat.FLASH_BWD_DQ_SM90.launches, tat.FLASH_BWD_DQ.launches) == (
        before[0] + 1, before[1])
    want = tat.flash_attention_chunk_bwd_plain(q, k, v, out, lse, dout, dlse,
                                               q_off, kv_off, causal,
                                               scale)[0]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert not torch.isnan(got).any()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err
    dead = (lse <= tat._NEG_INF / 2).reshape(b, h, sq).permute(0, 2, 1)
    assert torch.all(got[dead] == 0)
    if case in ("future", "no_keys"):
        assert bool(dead.all()) and torch.all(got == 0)
    if case == "masked_rows":
        assert bool(dead.any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_main_path_shape_takes_the_hopper_kernels(cuda, dtype):
    """A forward and backward at d = 128 launch the Hopper forward, dq and
    dk/dv kernels in bf16 and the older kernels in fp32, never both."""
    rng = np.random.default_rng(13)
    q, k, v = (_rand(rng, (2, 96, 4, 128), dtype, cuda).requires_grad_()
               for _ in range(3))
    kernels = (tat.FLASH_FWD_SM90, tat.FLASH_FWD, tat.FLASH_BWD_DKV_SM90,
               tat.FLASH_BWD_DKV, tat.FLASH_BWD_DQ_SM90, tat.FLASH_BWD_DQ)
    before = [kn.launches for kn in kernels]
    out, lse = tat.flash_attention_chunk(q, k, v, 0, 0)
    (out.float().square().sum() + lse.sum()).backward()
    torch.cuda.synchronize()
    got = [kn.launches - b for kn, b in zip(kernels, before)]
    sm90 = dtype == torch.bfloat16
    assert got == [int(sm90), int(not sm90)] * 3


# ---------------------------------------------------------------------------
# CUDA graphs of the decode step and the pipelined engine
# ---------------------------------------------------------------------------

tdec = importlib.import_module(f"{PORT}.models.decoding")
tdg = importlib.import_module(f"{PORT}.models.decode_graph")
tmoe = importlib.import_module(f"{PORT}.models.moe")


def _graph_setup(cuda, dtype, **cfg_kw):
    """DecodeGraphs over a 2-layer, head-dim-128 model with a filled
    cache and three live slots of a five-slot batch (two idle, one of
    them with an EOS that may fire)."""
    cfg = ttf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=512,
        intermediate_size=256, vocab_size=128, max_seq_len=256,
        dtype=dtype, **cfg_kw)
    params = ttf.init_params(cfg, seed=1, device=cuda, dtype=dtype)
    page, num_pages, B = 16, 40, 5
    gen = torch.Generator(device=cuda).manual_seed(2)
    cache = tdec.init_kv_pages(cfg, num_pages, page, device=cuda)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
    graphs = tdg.DecodeGraphs(params, cache, cfg, B, 256 // page, cuda)
    ctx = np.array([20, 70, 0, 100, 0], dtype=np.int32)
    live = ctx > 0
    state = np.stack([np.array([5, 9, 0, 77, 0]),
                      np.where(live, ctx, -1), ctx + 1,
                      np.where(live, ctx + 40, -1),
                      np.array([-1, 3, -1, -1, -1])]).astype(np.int32)
    tables = np.zeros((B, 16), dtype=np.int32)
    tables[live] = np.arange(1, 1 + 16 * 3).reshape(3, 16) % (num_pages - 1)
    tdg.upload(graphs.state, state)
    tdg.upload(graphs.tables, tables)
    return graphs, cache


def _snapshot(graphs, cache):
    return [t.clone() for t in (graphs.state, cache["k"], cache["v"])]


def _restore(graphs, cache, snap):
    for t, s in zip((graphs.state, cache["k"], cache["v"]), snap):
        t.copy_(s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["decode_step", "decode_multi_step"])
def test_graph_replay_equals_eager_bit_for_bit(cuda, dtype, kind):
    """A replay of the captured graph and the eager function, on the same
    state, tables and cache at two W buckets: outputs, state and every
    page but the scratch page identical to the bit."""
    _check_replay_equals_eager(*_graph_setup(cuda, dtype), kind)


def _check_replay_equals_eager(graphs, cache, kind):
    L, P = cache["k"].shape[:2]
    for W in (16, 8):
        snap = _snapshot(graphs, cache)
        if kind == "decode_step":
            replayed = graphs.decode_step(W).clone()
        else:
            replayed = graphs.multi_step(W, 6).clone()
        after = _snapshot(graphs, cache)
        _restore(graphs, cache, snap)
        if kind == "decode_step":
            eager = graphs._step(graphs.state, W)
        else:
            eager = graphs._chunk(graphs.state, W, 6, True)
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager), (W, kind)
        for a, b in zip(after[:1], (graphs.state,)):
            assert torch.equal(a, b)
        for a, b in zip(after[1:], (cache["k"], cache["v"])):
            assert torch.equal(a.view(L * P, -1)[:-1], b.view(L * P, -1)[:-1])
        _restore(graphs, cache, snap)
    assert graphs.captures == 2 <= graphs.bucket_bound()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["decode_step", "decode_multi_step"])
def test_moe_decode_replay_equals_eager_bit_for_bit(cuda, dtype, kind):
    """As test_graph_replay_equals_eager_bit_for_bit with 8 experts, top
    2: the exact route (every expert on every slot, top-k, the chosen
    outputs combined) replays bit for bit as it runs eagerly."""
    _check_replay_equals_eager(*_graph_setup(cuda, dtype, num_experts=8),
                               kind)


def test_replay_counts_each_kernel_launch(cuda):
    """A replay adds the launches its capture recorded: after the first
    call (warm-up, capture, replay), n replays count n x the launches of
    one eager call, and the capture alone counts none."""
    graphs, _ = _graph_setup(cuda, torch.bfloat16)
    kernels = (tpa.PAGED_DECODE, tpa.ROPE_ROW_WRITE)
    before = [k.launches for k in kernels]
    graphs._chunk(graphs.state.clone(), 8, 4, False)
    per_call = [k.launches - b for k, b in zip(kernels, before)]
    assert per_call == [2 * 4, 2 * 4]  # 2 layers x 4 steps, one each
    before = [k.launches for k in kernels]
    graphs.multi_step(8, 4)  # warm-up (real launches), capture, replay
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [2 * n for n in per_call]
    before = [k.launches for k in kernels]
    for _ in range(3):
        graphs.multi_step(8, 4)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [3 * n for n in per_call]


def _card_engine(cuda, **kw):
    cfg = ttf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=512,
        intermediate_size=256, vocab_size=128, max_seq_len=128,
        dtype=torch.float32)
    params = ttf.init_params(cfg, seed=4, device=cuda, dtype=torch.float32)
    return tse.LLMEngine(cfg, params, device=cuda,
                         **{**dict(page_size=8, num_pages=64, max_batch=4),
                            **kw})


def test_dispatches_never_synchronize(cuda):
    """Under torch.cuda.set_sync_debug_mode("error") a packed wave and a
    chunk dispatch run (graphs of every bucket captured beforehand, as
    the capture itself synchronizes); the streams then finish as the
    classic engine's."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (12, 9, 14)]
    want = _card_engine(cuda).generate(prompts, 10)
    eng = _card_engine(cuda, multi_step=4)
    eng.graphs.state[1].fill_(-1)  # dead slots while capturing
    for W in (1, 2, 4, 8, 16):
        eng.graphs.multi_step(W, 4)
    ids = [eng.add_request(p, 10) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert eng._dispatch_prefill_wave() == 3
        assert eng._dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    done = {}
    while eng.has_work():
        done.update(eng.step())
    assert [done[i] for i in ids] == want
    assert eng.graphs.captures == 5


def test_capture_all_leaves_no_capture_to_the_run(cuda):
    """capture_all captures the decode-step graph of every pow-2 table
    width (bucket_bound of them) once; the classic engine's run after it
    captures nothing and gives the streams of an engine that captured
    lazily."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (12, 40, 5)]
    want = _card_engine(cuda).generate(prompts, 30)
    eng = _card_engine(cuda)
    eng.graphs.state[1].fill_(-1)  # dead slots while capturing
    assert eng.graphs.capture_all() == eng.graphs.bucket_bound() == 5
    assert eng.graphs.capture_all() == 0
    assert eng.generate(prompts, 30) == want
    assert eng.graphs.captures == 5


def test_write_page_tokens_never_synchronizes(cuda):
    """The prefill write with pad rows waits on nothing, and matches its
    CPU run outside the scratch page."""
    rng = np.random.default_rng(6)
    P, page, KD = 9, 4, 32
    kp = _rand(rng, (P, page, KD), torch.float32, cuda)
    kn = _rand(rng, (2, 6, 2, 16), torch.float32, cuda)
    tables = torch.tensor([[3, 1], [5, 2]], dtype=torch.int32, device=cuda)
    pos = torch.tensor([[0, 1, 2, 3, 4, -1], [-1] * 6], dtype=torch.int32,
                       device=cuda)
    want = kp.cpu()
    tpa.write_page_tokens(want, want.clone(), kn.cpu(), kn.cpu(),
                          tables.cpu(), pos.cpu())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tpa.write_page_tokens(kp, kp.clone(), kn, kn, tables, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(kp.cpu()[:-1], want[:-1])


def test_pipelined_engine_equals_classic_on_card(cuda):
    """fp32: pipelined chunks with packed admission (depth 2), and the
    speculative engine, give the classic engine's greedy streams on the
    card, every decode a graph replay."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 128, size=n).tolist()
               for n in (12, 30, 5, 17, 9, 22)]
    prompts.append(([4, 5, 6] * 8)[:20])
    want = _card_engine(cuda).generate(prompts, 12)
    launches = tpa.PAGED_DECODE.launches
    eng = _card_engine(cuda, multi_step=4)
    assert eng.generate(prompts, 12) == want
    assert eng.waves_dispatched >= 1 and eng.prefill_reconciles >= 1
    assert tpa.PAGED_DECODE.launches > launches
    assert eng.graphs.captures <= eng.graphs.bucket_bound()
    spec = _card_engine(cuda, speculative_k=4)
    assert spec.generate(prompts, 12) == want
    assert spec.spec_steps > 0


def test_device_stats_on_card(cuda, monkeypatch):
    """The pipelined engine with the step sampler on: the ledger reads
    "cuda" with torch's device name and the engine's pools, the decode
    graphs' captures are the compile counts, and sampled steps have a
    roofline fraction above 0 and at most 1 against the card's peak."""
    monkeypatch.setenv("RAY_TPU_SERVE_STEP_SAMPLE_EVERY", "2")
    tds.reset()
    tds.set_enabled(True)
    rng = np.random.default_rng(8)
    eng = _card_engine(cuda, multi_step=4)
    for n in (12, 30, 5, 17):
        eng.add_request(rng.integers(0, 128, size=n).tolist(), 24)
    samples = []
    while eng.has_work():
        eng.step()
        s = eng.engine_sample
        if s is not None and (not samples or s is not samples[-1]):
            samples.append(s)
    led = tds.ledger()
    assert led["backend"] == "cuda"
    assert led["device_kind"] == torch.cuda.get_device_name(0)
    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    weights, kv = nbytes(eng.params), nbytes(eng.cache)
    assert led["components"] == {"weights": weights, "kv_pages": kv}
    assert led["used_bytes"] >= weights + kv
    captured = sum(v["count"] for k, v in tds.compile_counts().items()
                   if k.startswith("decode_graph."))
    assert captured == eng.graphs.captures > 0
    fracs = [s["roofline_fraction"] for s in samples
             if s.get("tokens_per_s", 0) > 0]
    assert fracs and all(0 < f <= 1 for f in fracs), fracs
    assert tds.last_step()["plane"] == "serve"
    tds.reset()


def _moe_card_engine(cuda, **kw):
    """_card_engine's model with 8 experts, top 2, at capacity factor 8.0
    (nothing dropped, so every mode gives the classic streams)."""
    cfg = ttf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=512,
        intermediate_size=256, vocab_size=128, max_seq_len=128,
        num_experts=8, num_experts_per_token=2, capacity_factor=8.0,
        dtype=torch.float32)
    params = ttf.init_params(cfg, seed=4, device=cuda, dtype=torch.float32)
    return tse.LLMEngine(cfg, params, device=cuda,
                         **{**dict(page_size=8, num_pages=64, max_batch=4),
                            **kw})


def test_moe_dispatches_never_synchronize(cuda):
    """test_dispatches_never_synchronize with an MoE model: the packed
    wave (capacity route, pad rows kept out of routing) and a chunk
    (exact route, replayed) run under set_sync_debug_mode("error"); the
    streams then finish as the classic engine's."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, size=n).tolist() for n in (12, 9, 14)]
    want = _moe_card_engine(cuda).generate(prompts, 10)
    eng = _moe_card_engine(cuda, multi_step=4)
    eng.graphs.state[1].fill_(-1)  # dead slots while capturing
    for W in (1, 2, 4, 8, 16):
        eng.graphs.multi_step(W, 4)
    ids = [eng.add_request(p, 10) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert eng._dispatch_prefill_wave() == 3
        assert eng._dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    done = {}
    while eng.has_work():
        done.update(eng.step())
    assert [done[i] for i in ids] == want
    assert eng.graphs.captures == 5


def test_moe_gather_forms_agree_bf16(cuda):
    """The exact route's graph-safe form (every expert on every token)
    against the plain form that gathers each token's expert matrices, at
    bf16 and 16 slots: the same routing (one fp32 router on the same
    inputs) and the same combine; the expert products come from other
    matmul kernels, so outputs agree to two bf16 ulps of the largest
    output, 2^-6 x max |plain|.  Neither waits on the card."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    T, h, m, E = 16, 512, 1024, 8
    bf = torch.bfloat16

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=cuda)
                / math.sqrt(shape[-2])).to(bf)

    x, router = torch.randn((T, h), generator=gen, device=cuda).to(bf), w(h, E)
    wg, wu, wd = w(E, h, m), w(E, h, m), w(E, m, h)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tmoe.moe_ffn_gather(x, router, wg, wu, wd, dtype=bf)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = tmoe.moe_ffn_gather_plain(x, router, wg, wu, wd, dtype=bf)
    assert got.dtype == bf and got.shape == (T, h)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -6 * want.float().abs().max().item(), err


# -- the port's runtime on the card ------------------------------------------


@pytest.fixture
def cuda_cluster(cuda):
    rt = importlib.import_module(PORT)
    rt.init(num_cpus=2, log_to_driver=False)
    try:
        yield rt
    finally:
        rt.shutdown()


def test_gpu_task_sees_the_card_and_cpu_task_none(cuda_cluster):
    """The GPU resource counts torch's devices; a num_gpus=1 task sees the
    driver's card, a CPU task (CUDA_VISIBLE_DEVICES="") sees none."""
    rt = cuda_cluster
    assert rt.cluster_resources()["GPU"] == torch.cuda.device_count()

    def probe():
        import os

        import torch

        return (torch.cuda.is_available()
                and torch.cuda.get_device_name(0),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    gpu = rt.get(rt.remote(num_gpus=1)(probe).remote(), timeout=300)
    cpu = rt.get(rt.remote(num_cpus=1)(probe).remote(), timeout=300)
    assert gpu[0] == torch.cuda.get_device_name(0)
    assert cpu == (False, "")


def test_cuda_tensors_survive_put_get(cuda_cluster):
    """A CUDA tensor (top level and nested, bf16 and fp32) comes back from
    the object store on the card, bit for bit, also through a GPU task."""
    rt = cuda_cluster
    gen = torch.Generator(device="cuda").manual_seed(0)
    value = {"w": torch.randn(300, 517, generator=gen, device="cuda"
                              ).to(torch.bfloat16),
             "b": torch.randn(1000, generator=gen, device="cuda")}
    top = torch.randn(64, 65, generator=gen, device="cuda")

    def echo(x):
        return x

    for got, want in ((rt.get(rt.put(top), timeout=60), top),
                      (rt.get(rt.put(value), timeout=60)["w"], value["w"]),
                      (rt.get(rt.remote(num_gpus=1)(echo).remote(value),
                              timeout=300)["b"], value["b"])):
        assert got.is_cuda and got.dtype == want.dtype
        assert torch.equal(got.view(torch.int16) if got.dtype
                           == torch.bfloat16 else got.view(torch.int32),
                           want.view(torch.int16) if want.dtype
                           == torch.bfloat16 else want.view(torch.int32))


def test_torch_trace_of_an_idle_card_says_it_failed(cuda, tmp_path):
    """A torch_trace that asked for CUDA activity and recorded no device
    event (the card idle) returns a "profile failed" string; one taken
    while another thread runs kernels returns a Chrome trace that holds
    them."""
    import threading

    runtime = importlib.import_module(f"{PORT}.core.runtime")
    torch.cuda.synchronize()
    idle = runtime._torch_trace(str(tmp_path / "idle"), 0.2)
    assert idle.startswith("profile failed: no CUDA event in "), idle
    stop = threading.Event()

    def work():
        x = torch.randn(1024, 1024, device="cuda")
        while not stop.is_set():
            x = x @ x / 1024
            torch.cuda.synchronize()

    th = threading.Thread(target=work)
    th.start()
    try:
        path = runtime._torch_trace(str(tmp_path / "busy"), 0.5)
    finally:
        stop.set()
        th.join()
    assert os.path.isfile(path), path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


def test_first_torch_trace_of_a_busy_gpu_actor_holds_kernels(cuda_cluster):
    """The first torch_trace of a fresh num_gpus=1 actor, taken through
    the control plane's profile op while a thread of the actor replays a
    CUDA graph, returns a Chrome trace that holds kernel events: the
    actor names that thread with set_profile_runner, so the session
    starts and stops between two replays (GPU-class workers also run
    with TEARDOWN_CUPTI=0); no trace before it."""
    rt = cuda_cluster

    class Busy:
        def __init__(self):
            import collections
            import threading

            import torch

            runtime = importlib.import_module(f"{PORT}.core.runtime")
            a = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
            outs = [torch.empty_like(a) for _ in range(8)]

            def body():
                x = a
                for o in outs:
                    torch.matmul(x, a, out=o)
                    x = o

            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                body()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                body()
            torch.cuda.synchronize()
            self.replays = 0
            self.calls = collections.deque()
            self.stop = threading.Event()
            threading.Thread(target=self._loop, daemon=True).start()
            runtime.set_profile_runner(self._on_loop)

        def _on_loop(self, fn):
            import concurrent.futures

            fut = concurrent.futures.Future()
            self.calls.append((fn, fut))
            return fut.result(timeout=300)

        def _loop(self):
            import torch

            while not self.stop.is_set():
                while self.calls:
                    fn, fut = self.calls.popleft()
                    try:
                        fut.set_result(fn())
                    except BaseException as e:  # noqa: BLE001
                        fut.set_exception(e)
                self.graph.replay()
                torch.cuda.synchronize()
                self.replays += 1

        def info(self):
            import os

            return (rt.get_runtime_context().worker_id, self.replays,
                    os.environ.get("TEARDOWN_CUPTI"))

        def halt(self):
            self.stop.set()
            return self.replays

    actor = rt.remote(num_gpus=1, max_concurrency=2)(Busy).remote()
    worker, replays, teardown = rt.get(actor.info.remote(), timeout=300)
    assert teardown == "0"
    drv = importlib.import_module(f"{PORT}.core.runtime").get_runtime()
    path = drv.core.client.call(
        {"op": "profile_worker", "worker_hex": worker, "kind": "torch_trace",
         "duration_s": 1.0, "timeout_s": 300.0}, timeout=330)
    assert rt.get(actor.halt.remote(), timeout=60) > replays
    assert isinstance(path, str) and os.path.isfile(path), path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("cat") == "kernel" for e in events) > 0


_SERVE_TINY = dict(num_layers=2, num_heads=4, num_kv_heads=2,
                   hidden_size=512, intermediate_size=256, vocab_size=128,
                   max_seq_len=128, dtype=torch.bfloat16)


@pytest.fixture
def cuda_serve(cuda_cluster):
    serve = importlib.import_module(f"{PORT}.serve")
    try:
        serve.start()
        yield cuda_cluster, serve
    finally:
        serve.shutdown()


def test_llm_server_replica_generate_and_http_stream_agree(cuda_serve):
    """A tiny bf16 LLMServer in a num_gpus=1 replica: handle.generate and
    an HTTP stream through a chat ingress give the same tokens."""
    import http.client
    from urllib.parse import urlparse

    rt, serve = cuda_serve
    tllm = importlib.import_module(f"{PORT}.serve.llm")

    class Chat:
        def __init__(self, llm):
            self.llm = llm

        def __call__(self, request):
            body = request.json()
            for tok in self.llm.options(
                    stream=True, method_name="generate_stream").remote(
                        body["prompt"], body["n"]):
                yield {"token": tok}

    llm = tllm.LLMServer.options(ray_actor_options={"num_gpus": 1}).bind(
        config_kwargs=_SERVE_TINY, page_size=8, num_pages=64, max_batch=4)
    serve.run(serve.deployment(name="chat")(Chat).bind(llm), name="tiny",
              route_prefix="/tiny", blocking_timeout_s=300)
    h = serve.get_deployment_handle("llm_server", app_name="tiny")
    prompt = list(range(3, 40))
    want = h.generate.remote(prompt, 12).result(timeout_s=300)
    u = urlparse(serve.proxy_address())
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=300)
    conn.request("POST", "/tiny", body=json.dumps(
        {"prompt": prompt, "n": 12}).encode(),
        headers={"X-Serve-Stream": "1", "Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    got = [json.loads(x)["token"] for x in resp.read().splitlines() if x]
    conn.close()
    assert len(want) == 12 and got == want
    st = h.stats.remote().result(timeout_s=60)
    assert st["active"] == 0 and st["waiting"] == 0


def test_llm_replica_first_trace_names_the_decode_kernel(cuda_serve):
    """The first torch_trace of a tiny bf16 LLMServer replica, taken
    while it decodes (requests sent again and again until the trace is
    back), names the paged decode kernel: the server's engine thread
    starts and stops the session."""
    import threading

    rt, serve = cuda_serve
    tllm = importlib.import_module(f"{PORT}.serve.llm")

    class Traced(tllm.LLMServer.func_or_class):
        def worker(self):
            return rt.get_runtime_context().worker_id

    h = serve.run(serve.deployment(name="llm_server")(Traced).options(
        ray_actor_options={"num_gpus": 1}).bind(
            config_kwargs=_SERVE_TINY, page_size=8, num_pages=64,
            max_batch=4), name="traced", route_prefix=None,
        blocking_timeout_s=300)
    worker = h.worker.remote().result(timeout_s=60)
    stop, done = threading.Event(), []

    def load():
        while not stop.is_set():
            rs = [h.generate.remote(list(range(3, 20 + i)), 64)
                  for i in range(4)]
            done.extend(r.result(timeout_s=300) for r in rs)

    th = threading.Thread(target=load)
    th.start()
    drv = importlib.import_module(f"{PORT}.core.runtime").get_runtime()
    try:
        path = drv.core.client.call(
            {"op": "profile_worker", "worker_hex": worker,
             "kind": "torch_trace", "duration_s": 1.0, "timeout_s": 300.0},
            timeout=330)
    finally:
        stop.set()
        th.join(600)
    assert not th.is_alive() and done
    assert isinstance(path, str) and os.path.isfile(path), path
    with open(path) as f:
        assert "paged_decode_kernel" in f.read()


def test_bf16_handoff_across_half_card_replicas(cuda_serve):
    """Two num_gpus=0.5 replicas of a tiny bf16 model share the card; a
    bf16 KV bundle goes prefill_only -> object plane -> decode_from and
    the decode leg continues it without a fallback."""
    rt, serve = cuda_serve
    tllm = importlib.import_module(f"{PORT}.serve.llm")
    kw = dict(config_kwargs=_SERVE_TINY, page_size=8, num_pages=64,
              max_batch=4)
    pre = serve.run(tllm.LLMServer.options(
        role="prefill", ray_actor_options={"num_gpus": 0.5}).bind(**kw),
        name="pre", route_prefix=None, blocking_timeout_s=300)
    dec = serve.run(tllm.LLMServer.options(
        role="decode", ray_actor_options={"num_gpus": 0.5}).bind(**kw),
        name="dec", route_prefix=None, blocking_timeout_s=300)
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    prompt = list(range(5, 30))
    kv = pre.prefill_only.remote(prompt, 10).result(timeout_s=300)
    assert kv["op"] == "serve_kv_import" and kv["size"] > 0
    got = dec.decode_from.remote(prompt, kv, 10).result(timeout_s=300)
    want = pre.generate.remote(prompt, 10).result(timeout_s=300)
    assert len(got) == 10 and got == want
    st = dec.stats.remote().result(timeout_s=60)
    assert st["kv_imports"] == 1 and st["handoff_fallbacks"] == 0


# -- the Train library on the card -------------------------------------------


def test_train_worker_launches_the_hopper_flash_kernels(cuda_cluster,
                                                        tmp_path):
    """TorchTrainer with one num_gpus=1 worker: the loop's device is the
    card, its tiny bf16 steps (head dim 128, the Hopper kernels' shape)
    launch the Hopper forward, dq and dk/dv (and no other flash kernel),
    and its losses are the test process's own on the same card, bit for
    bit."""
    train = importlib.import_module(f"{PORT}.train")
    port = PORT
    tiny = _SERVE_TINY

    def steps(device, n):
        """n steps from init(0) on one batch: losses, flash launches
        by kernel, layers."""
        import importlib as _il

        import numpy as _np

        tf = _il.import_module(f"{port}.models.transformer")
        ta = _il.import_module(f"{port}.ops.attention")
        cfg = tf.TransformerConfig.tiny(**tiny)
        ts = _il.import_module(f"{port}.train.train_state").ShardedTrainStep(
            cfg, device=device)
        state = ts.init(0)
        batch = {"tokens": _np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 65))}
        kernels = {k.symbol: k for k in ta.FLASH_FWD_KERNELS
                   + ta.FLASH_BWD_DQ_KERNELS + ta.FLASH_BWD_DKV_KERNELS}
        before = {name: k.launches for name, k in kernels.items()}
        losses = []
        for _ in range(n):
            state, m = ts.step(state, batch)
            losses.append(m["loss"].item())
        return losses, {name: k.launches - before[name]
                        for name, k in kernels.items()
                        if k.launches != before[name]}, cfg.num_layers

    def loop(config):
        import importlib as _il

        tr = _il.import_module(f"{port}.train")
        dev = _il.import_module(f"{port}.train.torch_backend").get_device()
        losses, launches, layers = steps(dev, 2)
        tr.report({"device": str(dev), "losses": losses,
                   "launches": launches, "layers": layers})

    res = train.TorchTrainer(
        loop, scaling_config=train.ScalingConfig(num_workers=1,
                                                 use_gpu=True),
        run_config=train.RunConfig(storage_path=str(tmp_path),
                                   name="card")).fit()
    m = res.metrics
    L = m["layers"]
    assert m["device"] == "cuda:0"
    assert m["launches"] == {"flash_fwd_sm90": 4 * L,
                             "flash_bwd_dq_sm90": 2 * L,
                             "flash_bwd_dkv_sm90": 2 * L}
    want, _, _ = steps(torch.device("cuda"), 2)
    assert m["losses"] == want


def test_load_pytree_to_the_card_bit_for_bit(cuda, tmp_path):
    """A train state of CUDA tensors (fp32 params, bf16 moments, counts)
    saved by save_pytree and save_pytree_async comes back on the card
    with load_pytree(map_location="cuda"), bit for bit."""
    tck = importlib.import_module(f"{PORT}.train.checkpoint")
    cfg = ttf.TransformerConfig.tiny()
    ts = tts.ShardedTrainStep(cfg, device=cuda, optimizer=tts.default_optimizer(
        mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16))
    state, _ = ts.step(ts.init(0), {"tokens": np.random.default_rng(0)
                                    .integers(0, cfg.vocab_size, (2, 33))})
    paths = [tck.save_pytree(state, str(tmp_path), step=1),
             tck.save_pytree_async(state, str(tmp_path), step=2).wait()]
    want = toptim.tree_leaves(state["params"]) + toptim.tree_leaves(
        state["opt_state"][1][0].mu)

    def bits(t):
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])

    for path in paths:
        back = tck.load_pytree(path, map_location="cuda")
        assert back["step"] == 1 and back["opt_state"][1][0].count == 1
        got = toptim.tree_leaves(back["params"]) + toptim.tree_leaves(
            back["opt_state"][1][0].mu)
        for a, b in zip(got, want):
            assert a.is_cuda and a.dtype == b.dtype
            assert torch.equal(bits(a), bits(b))


def test_gpu_bundle_gives_a_worker_that_sees_the_card(cuda_cluster):
    """A placement group bundle {"CPU": 1, "GPU": 1} and an actor in it
    asking for those resources, as the train worker group does: a
    GPU-class worker that sees the driver's card."""
    rt = cuda_cluster
    util = importlib.import_module(f"{PORT}.util")
    pg = util.placement_group([{"CPU": 1, "GPU": 1}])
    try:
        assert pg.wait(60)

        class Probe:
            def look(self):
                import os

                import torch

                return (torch.cuda.is_available()
                        and torch.cuda.get_device_name(0),
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

        actor = rt.remote(Probe).options(
            resources={"CPU": 1.0, "GPU": 1.0},
            scheduling_strategy=util.PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=0)).remote()
        name, visible = rt.get(actor.look.remote(), timeout=300)
        assert name == torch.cuda.get_device_name(0)
        assert visible != ""
        assert pg.state()["bundles"][0]["reserved"]["GPU"] == 1.0
    finally:
        util.remove_placement_group(pg)


# -- ring attention on the card -----------------------------------------------

# A ring's chunks: (b, s, h, hk, d, q_off, kv_off), causal.  A past chunk
# sees every key; a future chunk none (out 0, lse -1e30, gradients 0).
RING_CHUNKS = {"ring_past": (1, 128, 4, 4, 128, 128, 0),
               "ring_future": (1, 128, 4, 4, 128, 0, 128)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(RING_CHUNKS))
def test_ring_chunks_match_plain(cuda, dtype, case):
    """The forward and both backward kernels at a ring's past and future
    chunk offsets against their plain versions (the tolerances of
    test_flash_matches_plain and test_flash_bwd_matches_plain)."""
    b, s, h, hk, d, q_off, kv_off = RING_CHUNKS[case]
    rng = np.random.default_rng(s + q_off)
    q = _rand(rng, (b, s, h, d), dtype, cuda)
    k = _rand(rng, (b, s, hk, d), dtype, cuda)
    v = _rand(rng, (b, s, hk, d), dtype, cuda)
    dout = _rand(rng, (b, s, h, d), dtype, cuda)
    dlse = _rand(rng, (b * h, s), torch.float32, cuda)
    out, lse = tat.flash_attention_chunk(q, k, v, q_off, kv_off, True)
    want_out, want_lse = tat.flash_attention_chunk_plain(q, k, v, q_off,
                                                         kv_off, True)
    assert (out.float() - want_out.float()).abs().max().item() <= TOL[dtype]
    scale = 1.0 / math.sqrt(d)
    got = tat._flash_chunk_bwd_cuda(q, k, v, out, lse, dout, dlse, q_off,
                                    kv_off, True, scale)
    want = tat.flash_attention_chunk_bwd_plain(q, k, v, out, lse, dout, dlse,
                                               q_off, kv_off, True, scale)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert not torch.isnan(g).any(), name
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rel * max(w.float().abs().max().item(), 1.0), (name,
                                                                     err)
    if case == "ring_future":
        assert torch.all(out == 0) and torch.all(lse <= tat._NEG_INF / 2)
        assert all(torch.all(g == 0) for g in got)
    else:
        assert torch.all(lse > tat._NEG_INF / 2)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


def test_two_rank_ring_on_the_card_matches_flash_attention(cuda_cluster,
                                                           tmp_path):
    """Two num_gpus=0.5 TorchTrainer ranks (gloo, K/V staged through
    pinned host buffers) run ring attention over their halves of a bf16
    sequence on cuda:0; each rank's out and gradients (of a seeded
    N(0, 1) cotangent) equal one-process flash_attention's over the
    whole sequence on the rank's own slice, to 1e-2 in norm and 5e-2 of
    the slice's largest value (each chunk's out rounds to bf16 before
    the merge, and a rank's gradients sum two bf16 partials)."""
    train = importlib.import_module(f"{PORT}.train")
    backend = importlib.import_module(f"{PORT}.train.torch_backend")
    port = PORT
    shape = (1, 256, 4, 2, 128)  # b, s, h, kvh, d

    def inputs(dev):
        gen = torch.Generator(device=dev).manual_seed(3)
        b, s, h, kvh, d = shape
        return [torch.randn((b, s, n, d), generator=gen, device=dev).to(
            torch.bfloat16) for n in (h, kvh, kvh, h)]

    def loop(config):
        import importlib as _il
        import os as _os

        import torch.distributed as dist

        ring = _il.import_module(f"{port}.ops.ring_attention")
        mesh_mod = _il.import_module(f"{port}.parallel.mesh")
        comm = _il.import_module(f"{port}.parallel.comm")
        dev = _il.import_module(f"{port}.train.torch_backend").get_device()
        mesh = mesh_mod.build_mesh(axes={"seq": 2})
        s_loc = shape[1] // 2
        off = mesh.axis_index("seq") * s_loc
        q, k, v, dout = (t[:, off:off + s_loc].clone()
                         for t in inputs(dev))
        for t in (q, k, v):
            t.requires_grad_()
        out = ring.ring_attention_sharded(q, k, v, mesh, causal=True)
        out.backward(dout)
        torch.save({"off": off, "device": str(dev),
                    "transport": comm.transport(mesh.get_group("seq"), dev),
                    "out": out.detach().cpu(), "dq": q.grad.cpu(),
                    "dk": k.grad.cpu(), "dv": v.grad.cpu()},
                   _os.path.join(config["dir"], f"{dist.get_rank()}.pt"))

    train.TorchTrainer(
        loop, train_loop_config={"dir": str(tmp_path)},
        backend_config=backend.TorchConfig(backend="gloo"),
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=True,
                                           gpus_per_worker=0.5),
        run_config=train.RunConfig(storage_path=str(tmp_path),
                                   name="ring")).fit()
    dev = torch.device("cuda")
    q, k, v, dout = inputs(dev)
    for t in (q, k, v):
        t.requires_grad_()
    ref = tat.flash_attention(q, k, v, causal=True)
    ref.backward(dout)
    want = {"out": ref.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    for r in range(2):
        got = torch.load(os.path.join(str(tmp_path), f"{r}.pt"),
                         weights_only=True)
        assert got["device"] == "cuda:0" and got["transport"] == "gloo-host"
        off, n = got["off"], shape[1] // 2
        for name, w in want.items():
            wl = w[:, off:off + n].float()
            diff = got[name].to(dev).float() - wl
            assert (diff.norm() / wl.norm()).item() <= 1e-2, (r, name)
            assert (diff.abs().max() / wl.abs().max()).item() <= 5e-2, (
                r, name)


def test_two_rank_reduce_scatter_and_all_gather_on_the_card(cuda_cluster,
                                                            tmp_path):
    """Two num_gpus=0.5 TorchTrainer ranks on an fsdp axis (gloo, CUDA
    tensors staged through pinned host buffers): comm.reduce_scatter of
    each rank's seeded fp32 and bf16 tensor along dim 1 is, on each rank,
    its block of the plain sum, and comm.all_gather of the blocks is the
    plain concatenation, bit for bit (two operands: one rounding)."""
    train = importlib.import_module(f"{PORT}.train")
    backend = importlib.import_module(f"{PORT}.train.torch_backend")
    port = PORT
    shape = (3, 256, 40)

    def inputs(dev, rank, dtype):
        gen = torch.Generator(device=dev).manual_seed(11 + rank)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def loop(config):
        import importlib as _il
        import os as _os

        import torch.distributed as dist

        mesh_mod = _il.import_module(f"{port}.parallel.mesh")
        comm = _il.import_module(f"{port}.parallel.comm")
        dev = _il.import_module(f"{port}.train.torch_backend").get_device()
        mesh = mesh_mod.build_mesh(axes={"fsdp": 2})
        group, ranks = mesh.get_group("fsdp"), mesh.axis_ranks("fsdp")
        out = {"device": str(dev), "transport": comm.transport(group, dev)}
        for dtype in (torch.float32, torch.bfloat16):
            x = inputs(dev, dist.get_rank(), dtype)
            block = comm.reduce_scatter(x, ranks, group, 1)
            whole = comm.all_gather(block, ranks, group, 1)
            out[str(dtype)] = (block.cpu(), whole.cpu(), str(block.device))
        torch.save(out, _os.path.join(config["dir"],
                                      f"{dist.get_rank()}.pt"))

    train.TorchTrainer(
        loop, train_loop_config={"dir": str(tmp_path)},
        backend_config=backend.TorchConfig(backend="gloo"),
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=True,
                                           gpus_per_worker=0.5),
        run_config=train.RunConfig(storage_path=str(tmp_path),
                                   name="fsdp_comm")).fit()
    dev = torch.device("cuda")
    for r in range(2):
        got = torch.load(os.path.join(str(tmp_path), f"{r}.pt"),
                         weights_only=True)
        assert got["device"] == "cuda:0" and got["transport"] == "gloo-host"
        for dtype in (torch.float32, torch.bfloat16):
            block, whole, where = got[str(dtype)]
            assert where == "cuda:0"
            total = inputs(dev, 0, dtype) + inputs(dev, 1, dtype)
            half = shape[1] // 2
            assert torch.equal(block.to(dev),
                               total[:, r * half:(r + 1) * half]), (r, dtype)
            assert torch.equal(whole.to(dev), total), (r, dtype)


def test_two_rank_tensor_collectives_on_the_card(cuda_cluster, tmp_path):
    """Two num_gpus=0.5 TorchTrainer ranks on a tensor axis (gloo, CUDA
    tensors staged through pinned host buffers): the tensor-parallel
    model's collectives on each rank's seeded fp32 and bf16 tensor.
    reduce_from_tensor's forward is the plain sum and its backward the
    gradient itself; copy_to_tensor's forward is its input and its
    backward the plain sum of the ranks' gradients; gather_last's
    forward is the plain concatenation along the last dim and its
    backward the rank's block of the gradient; each call counted in the
    mesh's tensor_comm.  Bit for bit: two operands, one rounding."""
    train = importlib.import_module(f"{PORT}.train")
    backend = importlib.import_module(f"{PORT}.train.torch_backend")
    port = PORT
    shape = (3, 64, 40)

    def inputs(dev, rank, dtype, seed=11):
        gen = torch.Generator(device=dev).manual_seed(seed + rank)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def loop(config):
        import importlib as _il
        import os as _os

        import torch.distributed as dist

        mesh_mod = _il.import_module(f"{port}.parallel.mesh")
        comm = _il.import_module(f"{port}.parallel.comm")
        dev = _il.import_module(f"{port}.train.torch_backend").get_device()
        mesh = mesh_mod.build_mesh(axes={"tensor": 2})
        rank = dist.get_rank()
        out = {"device": str(dev),
               "transport": comm.transport(mesh.get_group("tensor"), dev)}
        for dtype in (torch.float32, torch.bfloat16):
            got = {}
            x = inputs(dev, rank, dtype).requires_grad_()
            y = comm.reduce_from_tensor(x, mesh)
            y.backward(inputs(dev, rank, dtype, 31))
            got["reduce"], got["reduce_grad"] = y.detach(), x.grad
            x = inputs(dev, rank, dtype).requires_grad_()
            y = comm.copy_to_tensor(x, mesh)
            y.backward(inputs(dev, rank, dtype, 31))
            got["copy"], got["copy_grad"] = y.detach(), x.grad
            x = inputs(dev, rank, dtype).requires_grad_()
            y = comm.gather_last(x, mesh)
            y.backward(torch.cat([inputs(dev, r, dtype, 31)
                                  for r in (0, 1)], dim=-1))
            got["gather"], got["gather_grad"] = y.detach(), x.grad
            out[str(dtype)] = {k: v.cpu() for k, v in got.items()}
            out[str(dtype) + " devices"] = {str(v.device)
                                            for v in got.values()}
        out["stats"] = dict(mesh.tensor_comm)
        torch.save(out, _os.path.join(config["dir"], f"{rank}.pt"))

    train.TorchTrainer(
        loop, train_loop_config={"dir": str(tmp_path)},
        backend_config=backend.TorchConfig(backend="gloo"),
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=True,
                                           gpus_per_worker=0.5),
        run_config=train.RunConfig(storage_path=str(tmp_path),
                                   name="tensor_comm")).fit()
    dev = torch.device("cuda")
    numel = math.prod(shape)
    for r in range(2):
        got = torch.load(os.path.join(str(tmp_path), f"{r}.pt"),
                         weights_only=True)
        assert got["device"] == "cuda:0" and got["transport"] == "gloo-host"
        for dtype in (torch.float32, torch.bfloat16):
            g = {k: v.to(dev) for k, v in got[str(dtype)].items()}
            assert got[str(dtype) + " devices"] == {"cuda:0"}
            mine, grad = inputs(dev, r, dtype), inputs(dev, r, dtype, 31)
            total = inputs(dev, 0, dtype) + inputs(dev, 1, dtype)
            grads = inputs(dev, 0, dtype, 31) + inputs(dev, 1, dtype, 31)
            assert torch.equal(g["reduce"], total), (r, dtype)
            assert torch.equal(g["reduce_grad"], grad), (r, dtype)
            assert torch.equal(g["copy"], mine), (r, dtype)
            assert torch.equal(g["copy_grad"], grads), (r, dtype)
            assert torch.equal(g["gather"], torch.cat(
                [inputs(dev, 0, dtype), inputs(dev, 1, dtype)], dim=-1))
            assert torch.equal(g["gather_grad"], grad), (r, dtype)
        # Per dtype: the reduce's forward, the copy's backward (numel
        # each) and the gather's output (2 x numel).
        assert got["stats"]["calls"] == 6
        assert got["stats"]["bytes"] == sum(4 * numel * size
                                            for size in (4, 2))
