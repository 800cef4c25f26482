"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            (from the repository root)

Phases, each of which raises (exit code != 0) if it fails:

  1. the card: name and power limit (nvidia-smi) and torch's device name;
  2. build every CUDA kernel of ray_tpu_torch/csrc/ with nvcc, in
     parallel, and print each kernel's registers and spills; the Hopper
     kernels (flash_fwd_sm90, flash_bwd_dq_sm90, flash_bwd_dkv_sm90) must
     not spill, and their code (cuobjdump -sass) must hold wgmma (HGMMA)
     and TMA loads (UTMALDG);
  3. hold each kernel against its plain PyTorch version, in bf16 and
     fp32, at Llama-2-7B shapes (H = KVH = 32, D = 128, page 128) and at
     a GQA shape (H = 16, KVH = 4): ragged contexts with a zero row,
     dropped write rows, sq < sk, offsets and a fully masked chunk; bf16
     flash forwards through both the Hopper and the older kernel; the
     rotating row write (rope_row_write: rotary embedding of q and k and
     the K/V row write in one launch) bit-exact at the classic (B = 8,
     W = 8) and the pipelined (B = 16, W = 16, idle slots) shapes; the
     same checks once more on the draws of PR 7's first call, and the
     fp32 packed wave on more seeds, each fp32 wave also against a
     float64 reference (pad rows held to a derived bound, PERF.md);
  4. the classic path: LLMEngine serving 12 greedy requests on
     Llama-2-7B at full width and depth with random bf16 weights, every
     decode step a CUDA-graph replay, with every kernel's launch count
     read around that run (every forward through the Hopper kernel;
     one rotating row write and one paged decode per layer and step, the
     plain row write never);
  5. the engine's prefill and decode rates, the card's busy share and
     busiest kernels over an admission step and a few decode steps
     (torch.profiler), and each kernel's time at the
     main path's shapes beside its bound, its plain version's time and
     one PyTorch call computing the same function where one exists; the
     card's per-launch floor (a one-element add_) beside the row
     writes; the rotating row write at B = 8 and 16 also beside the
     sequence it replaced (two apply_rope and the row-write kernel);
  5b. the pipelined path (`[pipelined]`): LLMEngine(multi_step=16,
     pipeline_depth=2, packed_admit=True, page 128, 192 pages, 16 slots)
     on the same weights, 16 requests of 100-1,000 tokens (two sharing a
     256-token prefix) and 8 more after the third step, 64-128 new
     tokens each, with launch counts through replays, graph captures,
     decode and wave-prefill rates; `[graph]`: one decode_step (B = 8)
     and one 16-step chunk (B = 16) eager against replay, and the card's
     busy share of a replayed chunk; the chunk replayed before (captured
     with the unfused rotary embedding and row write) and after, timed in
     turns, with its launches by kind; at bf16 the share of pipelined
     streams equal to the classic engine's and a speculative run's
     drafted / accepted counts (reported, not gated);
  5c. the engine's observability plane (`[obs]`): [pipelined]'s engine,
     weights and 24 requests with the step sampler every 2 steps and
     every other request traced: one SLO sample per request (TTFT and
     TPOT p50 / p99 printed, the ttft and tpot histograms count 24),
     serve.queue / serve.prefill / serve.decode spans that tile for the
     traced requests and none for the others, sampled roofline fractions
     in (0, 1] with MFU > 0, the HBM ledger's weights and kv_pages equal
     to the engine's bytes, decode_graph.* compile counts equal to the
     captures, streams and every kernel's launches equal to
     [pipelined]'s; then the same run twice with telemetry off, and the
     host ms per 16-step chunk on and off;
  6. the kernel path against the plain path, teacher-forced: bf16 at
     full depth (prefill and decode logits) and fp32 with 2 layers
     (greedy tokens identical for 16 steps); at fp32, 2 layers, full
     width: a replayed 16-step chunk equal to the eager one bit for bit
     (also bf16), pipelined and speculative streams equal to the
     classic engine's, and a request exported mid-run from a pipelined
     engine continuing exactly in another;
  6b. mixture of experts (`[moe]`) at Mixtral-8x7B widths, 16 of its 32
     layers: paged decode, the rotating row write and the packed-wave
     flash forward at its attention shape (32 query over 8 KV heads),
     bf16 and fp32; the same 24 requests through the pipelined engine
     (bf16, random weights; launches, captures, decode and wave rates;
     one engine_sample, its roofline fraction in (0, 1] and MFU > 0);
     one layer's exact route against the reference's gathering form; a
     replayed 16-step chunk against the weights-only bound and its busy
     share by kind; at fp32 with 2 layers, kernel path = plain path
     tokens, replay = eager bit for bit (also bf16), and at capacity
     factor 8.0 pipelined (with and without packed admission),
     speculative and handoff streams = classic;
  7. the flash backward kernels (dq, dk/dv) against their plain version,
     in bf16 and fp32, at the training shape (b = 8, H = KVH = 14,
     D = 128, s = 2048, causal; the forward there too), a GQA shape,
     sq < sk, a non-causal chunk and an offset chunk with fully masked
     rows and a nonzero lse cotangent (bf16 dq and dk/dv through both
     the Hopper and the older kernels); then the Hopper forward, dq and
     dk/dv at the serving prefill shape and at edge cases (lengths off
     the tiles, offsets, GQA 32 / 8, masked rows, no keys, s = 4096), at
     head dims 128 and 64, the older dq beside the Hopper one;
  8. the training path: ShardedTrainStep on the 0.9B headline config of
     ray_tpu_torch/bench.py (16 layers, hidden 1792, 14 heads, full
     remat, fused CE, AdamW with bf16 moments) at b = 8, s = 2048 with
     random weights from seed 0: a warm-up step, 6 timed steps, tokens/s,
     train_mfu, peak memory, the card's busy share over a step, and the
     flash kernels' launches per step read around the run (32 Hopper
     forwards, 16 Hopper dq, 16 Hopper dk/dv, none of the older variants);
  8b. the same config under each remat policy (`[train-remat]`: "full",
     "dots", "save_attn", "dots_no_mlp"), each from the same state and
     batch: ms per step, tokens/s, train_mfu, peak memory of a step and
     of the loss and gradients alone, the flash launches per step (32
     forwards under "full" and "dots", 16 under the two that keep the
     kernel's out and lse; 16 dq and 16 dk/dv), and the first step's
     loss and grad norm the same bits under all four;
  9. the training path with its flash kernels against the plain path on
     the card: loss and every gradient at full width with 2 layers, bf16
     and fp32;
  9b. MoE training (`[moe-train]`) at Mixtral-8x7B widths cut to 1 layer
     (the eager optimizer's peak, PERF.md), full remat, fused CE, AdamW
     with bf16 moments, b = 2, s = 4096: timed steps on one batch whose
     loss falls, ms, tokens/s, peak memory, train_mfu by the reference's
     flops_per_token and by active parameters, flash launches, the
     optimizer's ms and the card's busy share by kind; at fp32 with 2
     layers and s = 256, loss and every gradient of the kernel path
     against the plain path, and every gradient under each policy
     against no remat, bit for bit;
 10. the training kernels' times at the training shape beside their
     bounds, achieved TFLOP/s and PR 2's times, the plain backward's time
     and one PyTorch backward of the same attention; the older forward,
     dq and dk/dv kernels are timed beside the Hopper ones.

The last lines: a JSON object of the kernels, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import bench as tbench
from ray_tpu_torch.models import decode_graph as tdg
from ray_tpu_torch.models import decoding as tdec
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    num_params,
)
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as tat
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve import llm_engine as tsrv
from ray_tpu_torch.serve.llm_engine import LLMEngine
from ray_tpu_torch.train import optim as toptim
from ray_tpu_torch.train.train_state import ShardedTrainStep, default_optimizer
from ray_tpu_torch.util import device_stats as tds
from ray_tpu_torch.util import metrics as tmetrics
from ray_tpu_torch.util import tracing as ttracing

HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain version on the same inputs.  fp32: summation order.
# bf16: both round p to 8 mantissa bits before P*V (kernel against its
# running max, plain version against the row max) and round the output.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Full-depth bf16 logits, kernel path vs plain path: the attention ops'
# bf16 rounding differences (~2^-9 relative per layer) feed 32 layers of
# residual updates; logits must agree to 5% of their largest magnitude.
DEPTH_REL_TOL = 0.05

KERNELS = {
    "paged_decode_attention": dict(
        kernel=tpa.PAGED_DECODE, source="ray_tpu_torch/csrc/paged_decode.cu",
        replaces="ray_tpu/ops/paged_attention.py:155"),
    "row_write": dict(
        kernel=tpa.ROW_WRITE, source="ray_tpu_torch/csrc/row_write.cu",
        replaces="ray_tpu/ops/paged_attention.py:414"),
    # The row write folded into the decode step's rotary embedding: the
    # decode path's kernel; row_write above keeps write_token_rows.
    "rope_row_write": dict(
        kernel=tpa.ROPE_ROW_WRITE, source="ray_tpu_torch/csrc/row_write.cu",
        replaces="ray_tpu/ops/paged_attention.py:414"),
    "flash_fwd": dict(
        kernel=tat.FLASH_FWD, source="ray_tpu_torch/csrc/flash_fwd.cu",
        replaces="ray_tpu/ops/attention.py:92"),
    "flash_bwd_dq": dict(
        kernel=tat.FLASH_BWD_DQ, source="ray_tpu_torch/csrc/flash_bwd.cu",
        replaces="ray_tpu/ops/attention.py:223"),
    "flash_bwd_dkv": dict(
        kernel=tat.FLASH_BWD_DKV, source="ray_tpu_torch/csrc/flash_bwd.cu",
        replaces="ray_tpu/ops/attention.py:267"),
    # The Hopper kernels that take over bf16 head dims 64 and 128 from the
    # three rows above (flash_variant); those keep fp32 and other dims.
    "flash_fwd_sm90": dict(
        kernel=tat.FLASH_FWD_SM90,
        source="ray_tpu_torch/csrc/flash_fwd_sm90.cu",
        replaces="ray_tpu/ops/attention.py:92"),
    "flash_bwd_dq_sm90": dict(
        kernel=tat.FLASH_BWD_DQ_SM90,
        source="ray_tpu_torch/csrc/flash_bwd_dq_sm90.cu",
        replaces="ray_tpu/ops/attention.py:223"),
    "flash_bwd_dkv_sm90": dict(
        kernel=tat.FLASH_BWD_DKV_SM90,
        source="ray_tpu_torch/csrc/flash_bwd_sm90.cu",
        replaces="ray_tpu/ops/attention.py:267"),
}
# The kernels each main path runs (flash_fwd_sm90 runs on both), and the
# older variants that must not run there (both paths are bf16, d = 128).
SERVE_KERNELS = ("paged_decode_attention", "rope_row_write",
                 "flash_fwd_sm90")
TRAIN_KERNELS = ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90")
REPLACED = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SM90_KERNELS = {"flash_fwd_sm90": "flash_fwd_sm90_kernel",
                "flash_bwd_dq_sm90": "flash_bwd_dq_sm90_kernel",
                "flash_bwd_sm90": "flash_bwd_dkv_sm90_kernel"}
# The PR 2 kernels' device ms at the timed shapes (PERF.md, NVIDIA H100
# 80GB HBM3, 700 W), printed beside this run's times of both variants.
PR2_MS = {"flash_fwd (prefill shape)": 0.4372,
          "flash_fwd (training shape)": 1.4257,
          "flash_bwd_dkv": 1.9133, "flash_bwd_dq": 1.6271}
# Backward kernels vs their plain version, relative to the largest plain
# gradient.  fp32: sums in another order.  bf16: both round p and ds to
# bf16 at the same points; the fp32 sums, taken in another order, round
# to bf16 at the end (one bf16 ulp, 2^-8, of the largest value).
BWD_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# Training path with kernels vs plain path, 2 layers at full width: loss
# and every gradient relative to the largest plain gradient.  bf16: the
# attention ops round differently (a bf16 ulp per op) and the backward
# carries that through two layers; fp32: summation order (with the
# unfused CE: the fused CE rounds x and dlogits to bf16, as the reference
# does, which turns fp32 order differences into bf16 rounding flips).
TRAIN_DEPTH_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
TRAIN = dict(batch=8, seq=2048, steps=6)
# [train-remat]: timed steps per policy, after one step at learning rate 0.
REMAT_STEPS = 3
# [moe-train] at Mixtral-8x7B widths: depth, batch, sequence and timed
# steps (PERF.md has the depth's reckoning), and the fp32 checks' depth
# and batch.
MOE_TRAIN = dict(layers=1, batch=2, seq=4096, steps=3)
MOE_TRAIN_FP32 = dict(layers=2, batch=2, seq=256)
# Device time by kind of kernel, matched on the kernel's name in order.
PROFILE_GROUPS = [
    ("flash kernels (port)", r"flash_(fwd|bwd)"),
    ("paged decode / row write (port)", r"paged_decode|row_write"),
    ("matmul (cuBLAS)", r"nvjet|gemm|cutlass|sm90_xmma"),
    # The MoE router's softmax and top-k (which sorts its k values in
    # place) and the capacity route's running count (cumsum); not the
    # radix sort and cub scan of the embedding's backward.
    ("MoE routing", r"softmax|[Tt]op[Kk]|SortKVInPlace|tensor_kernel_scan"),
    ("copy / cast", r"copy|CatArrayBatched"),
    ("reduction", r"reduce_kernel"),
    ("gather", r"gather|index_elementwise"),
    ("elementwise", r"elementwise|index"),
]
# Packed-wave views [nseg, seg_len] of the pipelined run's waves.
PACKED_WAVES = ((16, 128), (16, 512), (8, 1024))
# The valid prefixes of the fp32 gqa_serve [8, 1024] wave in PR 7's first
# call, whose pad rows read 2.325e-5 against TOL on an NVIDIA H100 80GB
# HBM3 at 700.00 W (PERF.md, "Pad rows").
PR7_WAVE = [1024, 695, 1016, 572, 766, 583, 888, 0]
SHAPES = {"llama2_7b": dict(H=32, KVH=32, D=128, page=128),
          "gqa_serve": dict(H=16, KVH=4, D=128, page=128)}
# The [moe] phase's attention shape: Mixtral-8x7B's 32 query heads over 8
# KV heads.
MIXTRAL_SHAPE = dict(H=32, KVH=8, D=128, page=128)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _events_ms(run, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_ms(fn, n):
    """(device ms, eager ms) per call of fn over n calls, by CUDA events.

    Device: n calls captured in one CUDA graph and replayed, so the time
    is the card's alone.  Eager: n calls issued from Python one by one,
    which includes the host's cost per call where the host is slower
    than the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    _build.take_captured()  # timing replays count as no launches
    graph.replay()
    device = _events_ms(graph.replay, n)

    def eager():
        for _ in range(n):
            fn()

    eager()
    return device, _events_ms(eager, n)


@contextlib.contextmanager
def plain_ops():
    """Route the decoding module's kernel entry points to the kernels'
    plain PyTorch versions, for the plain side of a comparison."""
    saved = (tdec.flash_attention, tdec.paged_attention,
             tdec.rope_write_token_rows)

    def flash_plain(q, k, v, causal=True):
        return tat.flash_attention_chunk_plain(
            q, k, v, k.shape[1] - q.shape[1], 0, causal)[0]

    tdec.flash_attention = flash_plain
    tdec.paged_attention = tpa.paged_attention_plain
    tdec.rope_write_token_rows = tpa.rope_write_token_rows_plain
    try:
        yield
    finally:
        (tdec.flash_attention, tdec.paged_attention,
         tdec.rope_write_token_rows) = saved


def unfused_rope_row_write(q, k, v, cos, sin, k_pages, v_pages,
                           block_tables, positions):
    """What a decode layer ran before the rotating row write existed:
    apply_rope on q and on k at max(pos, 0), then the row-write kernel
    (about 22 launches).  The [time] and [graph] phases time it beside
    the rotating row write."""
    safe = positions.clamp_min(0)[:, None]
    q = ttf.apply_rope(q[:, None], cos, sin, safe)[:, 0]
    k = ttf.apply_rope(k[:, None], cos, sin, safe)[:, 0]
    tpa.write_token_rows(k_pages, v_pages, k, v, block_tables, positions)
    return q


@contextlib.contextmanager
def unfused_decode():
    """Route the decoding module's rotating row write to the sequence it
    replaced (on the card: PyTorch's kernels and the row-write kernel),
    for a before/after comparison in one run."""
    saved = tdec.rope_write_token_rows
    tdec.rope_write_token_rows = unfused_rope_row_write
    try:
        yield
    finally:
        tdec.rope_write_token_rows = saved


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[card] {smi} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {name} | devices "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, name


def phase_build():
    """Build every kernel source; print each kernel's registers and
    spills, and for the Hopper kernels their wgmma (HGMMA) and TMA load
    (UTMALDG) instructions in the built code.  Raises if a Hopper kernel
    spills or has none of either."""
    t0 = time.perf_counter()
    report = _build.build(force=True)
    print(f"[build] {len(report)} sources in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc)")
    spilled = {}
    for src, info in sorted(report.items()):
        print(f"[build] {src}.cu {info['seconds']:.1f} s")
        entry, spills = None, ""
        for line in info["log"].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:  # mangled name -> "kernel_name I<template args>E"
                t = re.search(r"\d+([a-z_][a-z0-9_]*_kernel)(I\w*?E)?E",
                              m.group(1))
                entry = (t.group(1) + (t.group(2) or "")) if t else m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and entry:
                spills = f"spills {m.group(1)}/{m.group(2)} B"
                spilled[entry] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                print(f"[build]   {entry}: {m.group(1)} registers, {spills}; "
                      f"{line.strip()}")
                entry = None
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for src, kernel in SM90_KERNELS.items():
        bad = [e for e, n in spilled.items() if e.startswith(kernel) and n]
        check(not bad, f"{bad} spill registers")
        sass = subprocess.run([cuobjdump, "-sass", _build.library_path(src)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = [0, 0]
            elif fn:
                counts[fn][0] += "HGMMA" in line
                counts[fn][1] += "UTMALDG" in line
        mine = {f: c for f, c in counts.items() if kernel in f}
        check(mine, f"{kernel} not found in {src}'s code")
        for f, (hgmma, utmaldg) in sorted(mine.items()):
            print(f"[build]   {src} {f}: {hgmma} HGMMA, {utmaldg} UTMALDG "
                  f"instructions (cuobjdump -sass)")
            check(hgmma > 0 and utmaldg > 0,
                  f"{f} runs without wgmma or TMA")


def check_flash_fwd(kname, tag, q, k, v, q_off, kv_off, causal, sm90):
    """One forward variant against the plain version: out to TOL, lse
    to 1e-3 + TOL, rows that see no key exactly out = 0 and lse = -1e30,
    no NaN.  Returns the largest out error."""
    dtype, (b, sq, H, D) = q.dtype, q.shape
    out, lse = tat._flash_chunk_cuda(q, k, v, q_off, kv_off, causal,
                                     1.0 / math.sqrt(D), sm90=sm90)
    torch.cuda.synchronize()
    if k.shape[1]:
        o_ref, l_ref = tat.flash_attention_chunk_plain(q, k, v, q_off,
                                                       kv_off, causal)
    else:  # no keys: the plain version cannot reduce an empty row (ROADMAP)
        o_ref = torch.zeros_like(q)
        l_ref = torch.full((b * H, sq), tat._NEG_INF, device=q.device)
    check(not (torch.isnan(out).any() or torch.isnan(lse).any()).item(),
          f"{kname} {tag}: NaN")
    masked = l_ref <= tat._NEG_INF / 2
    check(torch.equal(lse <= tat._NEG_INF / 2, masked)
          and torch.all(lse[masked] == tat._NEG_INF),
          f"{kname} {tag}: flash lse sentinel rows differ")
    rows = masked.reshape(b, H, sq).any(dim=1)
    check(torch.all(out[rows] == 0), f"{kname} {tag}: masked rows not zero")
    err_f = (out.float() - o_ref.float()).abs().max().item()
    err_l = ((lse - l_ref)[~masked].abs().max().item()
             if (~masked).any() else 0.0)
    print(f"[kernel] {kname} {tag}: max_abs_err out {err_f:.3e} lse "
          f"{err_l:.3e} (tolerance {TOL[dtype]:g}); masked rows "
          f"{int(masked.sum())}")
    check(err_f <= TOL[dtype] and err_l <= 1e-3 + TOL[dtype],
          f"{kname} {tag}: flash forward disagrees")
    return err_f


def check_paged_decode(gen, tag, dtype, dev, s, B, W, ctx_list):
    """Paged decode at B slots over W-page tables with contexts
    `ctx_list` (0: an idle slot, whose row must be zero) against the
    plain version.  Returns (error, q, pages, tables, ctx) for the row
    write check."""
    H, KVH, D, page = s["H"], s["KVH"], s["D"], s["page"]
    P = B * W + 1
    q = rand(gen, (B, H, D), dtype, dev)
    kp = rand(gen, (P, page, KVH * D), dtype, dev)
    vp = rand(gen, (P, page, KVH * D), dtype, dev)
    tables = torch.randperm(P - 1, generator=gen, device=dev)[
        :B * W].reshape(B, W).int()
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
    got = tpa.paged_attention(q, kp, vp, tables, ctx)
    torch.cuda.synchronize()
    want = tpa.paged_attention_plain(q, kp, vp, tables, ctx)
    err = (got.float() - want.float()).abs().max().item()
    check(torch.all(got[ctx == 0] == 0), f"{tag}: ctx 0 row not zero")
    print(f"[kernel] paged_decode_attention {tag} B={B} W={W}: max_abs_err "
          f"{err:.3e} (tolerance {TOL[dtype]:g})")
    check(err <= TOL[dtype], "paged decode disagrees")
    return err, kp, vp, tables, ctx


def check_rope_row_write(gen, tag, dtype, dev, s, kp, vp, tables, pos,
                         cfg=None):
    """The rotating row write against its plain version on fresh q, k, v
    at positions `pos` (< 0: idle), with the rope tables of `cfg`
    (default Llama-2-7B's): the rotated q and every page but the scratch
    page must be bit-exact.  Writes into kp, vp."""
    H, KVH, D = s["H"], s["KVH"], s["D"]
    B = pos.shape[0]
    cos, sin = tdec.rope_tables(cfg or TransformerConfig.llama2_7b(), dev)
    q = rand(gen, (B, H, D), dtype, dev)
    k = rand(gen, (B, KVH, D), dtype, dev)
    v = rand(gen, (B, KVH, D), dtype, dev)
    k2, v2 = kp.clone(), vp.clone()
    got = tpa.rope_write_token_rows(q, k, v, cos, sin, kp, vp, tables, pos)
    torch.cuda.synchronize()
    want = tpa.rope_write_token_rows_plain(q, k, v, cos, sin, k2, v2,
                                           tables, pos)
    exact = (torch.equal(got, want) and torch.equal(kp[:-1], k2[:-1])
             and torch.equal(vp[:-1], v2[:-1]))
    print(f"[kernel] rope_row_write {tag} B={B} W={tables.shape[1]} "
          f"positions {int(pos.min())}..{int(pos.max())} "
          f"({int((pos < 0).sum())} idle): rotated q and pages bit-exact "
          f"outside the scratch page: {exact} (tolerance: bit-exact)")
    check(exact, "rotating row write differs from its plain version")


def attention_fp64(q, k, v):
    """Causal attention in float64 (GQA heads repeated): the exact
    reference that both sides of an fp32 comparison round away from."""
    rep = q.shape[2] // k.shape[2]
    q, k, v = (t.double() for t in (q, k.repeat_interleave(rep, 2),
                                    v.repeat_interleave(rep, 2)))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    n = s.shape[-1]
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=q.device)
                      .triu(1), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def check_packed_wave(gen, tag, dtype, dev, s, nseg, seg_len):
    """The flash forward as a packed wave calls it: causal on the
    [nseg, seg_len] view, each segment a valid prefix of ragged length
    followed by pad rows (one row repeated, as a pad token gives), the
    last segment all pad (an unused one).  Every row against the plain
    version: valid rows to TOL; in fp32, pad rows to TOL plus
    pad_row_bound, since a pad row's trailing keys are copies of one key
    (PERF.md, "pad rows").  In fp32 both sides are also held against a
    float64 reference, to show which of them carries the error.
    Returns the largest error and the valid prefixes."""
    H, KVH, D = s["H"], s["KVH"], s["D"]
    q = rand(gen, (nseg, seg_len, H, D), dtype, dev)
    k = rand(gen, (nseg, seg_len, KVH, D), dtype, dev)
    v = rand(gen, (nseg, seg_len, KVH, D), dtype, dev)
    valid = torch.randint(seg_len // 2 + 1 if seg_len > 128 else 1,
                          seg_len + 1, (nseg,), generator=gen, device=dev)
    valid[-1] = 0
    valid[0] = seg_len
    pad = torch.arange(seg_len, device=dev)[None] >= valid[:, None]
    for t in (q, k, v):
        t[pad] = t[0, 0].clone()
    got = tat.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = tat.flash_attention_chunk_plain(q, k, v, 0, 0, True)[0]
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    err_valid = diff[~pad].max().item()
    err_pad = diff[pad].max().item() if pad.any() else 0.0
    kname = ("flash_fwd_sm90" if tat.flash_variant(dtype, D, True) == "sm90"
             else "flash_fwd")
    text = (f"[kernel] {kname} {tag} packed wave [{nseg}, {seg_len}] valid "
            f"{valid.tolist()}: max_abs_err {err:.3e}, on valid rows "
            f"{err_valid:.3e} (tolerance {TOL[dtype]:g}), on pad rows "
            f"{err_pad:.3e}")
    ok = err_valid <= TOL[dtype]
    if dtype == torch.float32:
        bound = TOL[dtype] + pad_row_bound(v, want)
        exact = attention_fp64(q, k, v)
        e_kern = (got.double() - exact).abs()
        e_plain = (want.double() - exact).abs()
        rows = [("valid", ~pad), ("pad", pad)] if pad.any() else [
            ("valid", ~pad)]
        text += (f" (pad-row bound {bound[pad].min().item():.3e}.."
                 f"{bound[pad].max().item():.3e}, largest share of it "
                 f"{(diff / bound[..., None, None])[pad].max().item():.3f})"
                 if pad.any() else "") + "; against float64: " + ", ".join(
            f"{name} rows kernel {e_kern[m].max().item():.3e} plain "
            f"{e_plain[m].max().item():.3e}" for name, m in rows)
        ok = ok and bool((diff <= bound[..., None, None]).all())
    else:
        ok = ok and err <= TOL[dtype]
    print(text)
    check(not torch.isnan(got).any().item() and ok,
          "flash forward disagrees on a packed wave")
    return err, valid.tolist()


# The unit roundoff of float32.
FP32_U = 2.0 ** -24


def pad_row_bound(v, out):
    """Per row of a causal [nseg, seg_len] fp32 attention, what two fp32
    evaluations that sum the row's n keys in different orders may
    differ by, beyond the order-independent part TOL covers: a row's
    output is A / l with A = sum_j p_j v_j and l = sum_j p_j over its
    n = row + 1 keys.  A sum of n terms carries at most (n - 1) u
    sum |terms| of rounding error in any order (u = 2^-24), so A is off
    by at most n u max|v| l and l by n u l, and A / l by
    n u (max|v| + |out|); two evaluations differ by twice that.  Rows
    whose keys are random reach a small part of it (the errors of
    independent terms cancel); a pad row's trailing keys are copies of
    one key, whose additions round alike and add up.  Returns
    [nseg, seg_len]."""
    n = torch.arange(1, v.shape[1] + 1, device=v.device, dtype=torch.float64)
    vmax = v.double().abs().amax(dim=(1, 2, 3))[:, None]
    omax = out.double().abs().amax(dim=(2, 3))
    return 2 * n[None] * FP32_U * (vmax + omax)


def phase_kernels(dev, pr7_draws=False):
    """Each kernel against its plain version, at the classic path's
    shapes and at those the pipelined path gives it (paged decode at
    B = 16 over 16-page tables, the flash forward on packed-wave views);
    returns the largest bf16 error per kernel at the main path's
    (Llama-2-7B) shapes (0 for the row write, which must be bit-exact).

    pr7_draws: the rotating row write draws from the shared generator,
    as in PR 7's first call, which gives every later check the inputs it
    had there (the fp32 gqa_serve [8, 1024] wave's valid prefixes were
    PR7_WAVE); otherwise it has a generator of its own, and the packed
    wave check runs on a few more seeds."""
    gen = torch.Generator(device=dev).manual_seed(1)
    # The rotating row write draws its q, k, v from a generator of its
    # own, so that the other checks keep their inputs.
    gen_rope = (gen if pr7_draws
                else torch.Generator(device=dev).manual_seed(7))
    worst = {k: 0.0 for k in KERNELS}
    for shape_name, s in SHAPES.items():
        H, KVH, D, page = s["H"], s["KVH"], s["D"], s["page"]
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{shape_name} {str(dtype)[6:]}"
            main = shape_name == "llama2_7b" and dtype == torch.bfloat16
            # Paged decode: ragged contexts including an empty row; then
            # the pipelined run's batch and table width (contexts up to
            # its longest prompt + new tokens, two idle slots).
            B = 8
            err, kp, vp, tables, ctx = check_paged_decode(
                gen, tag, dtype, dev, s, B, 8,
                [0, 1, 127, 128, 129, 500, 777, 1024])
            err16, kp16, vp16, tables16, ctx16 = check_paged_decode(
                gen, tag, dtype, dev, s, 16, 16,
                [0, 1, 100, 127, 128, 129, 255, 256, 257, 500, 640, 777,
                 0, 1000, 1100, 1128])
            if main:
                worst["paged_decode_attention"] = max(err, err16)
            # Rotating row write, bit-exact: the classic shape (one
            # dropped row) and the pipelined one (idle slots, pos = -1).
            pos = ctx.clone() - 1
            pos[3] = -1
            check_rope_row_write(gen_rope, tag, dtype, dev, s, kp, vp,
                                 tables, pos)
            check_rope_row_write(gen_rope, tag, dtype, dev, s, kp16, vp16,
                                 tables16, ctx16 - 1)
            # Row write, one dropped row: bit-exact but for page P-1.
            kn = rand(gen, (B, KVH, D), dtype, dev)
            vn = rand(gen, (B, KVH, D), dtype, dev)
            pos = ctx.clone() - 1
            pos[3] = -1
            k2, v2 = kp.clone(), vp.clone()
            tpa.write_token_rows(kp, vp, kn, vn, tables, pos)
            tpa.write_token_rows_plain(k2, v2, kn, vn, tables, pos)
            torch.cuda.synchronize()
            exact = torch.equal(kp[:-1], k2[:-1]) and torch.equal(
                vp[:-1], v2[:-1])
            print(f"[kernel] row_write {tag}: bit-exact outside the "
                  f"scratch page: {exact} (tolerance: bit-exact)")
            check(exact, "row write differs from index_put_")
            # Flash forward: ragged causal, sq < sk, offsets, future chunk.
            cases = [(2, 300, 300, 0, 0, True), (1, 128, 300, 172, 0, True),
                     (1, 256, 320, 200, 100, True),
                     (1, 64, 128, 0, 1000, True), (1, 100, 300, 0, 0, False)]
            # bf16 through both forward variants (the Hopper kernel the
            # wrapper picks, and the older one forced), fp32 the older one.
            variants = ([True, False] if dtype == torch.bfloat16
                        else [False])
            for b, sq, sk, q_off, kv_off, causal in cases:
                qf = rand(gen, (b, sq, H, D), dtype, dev)
                kf = rand(gen, (b, sk, KVH, D), dtype, dev)
                vf = rand(gen, (b, sk, KVH, D), dtype, dev)
                for sm90 in variants:
                    kname = "flash_fwd_sm90" if sm90 else "flash_fwd"
                    err_f = check_flash_fwd(
                        kname, f"{tag} b={b} sq={sq} sk={sk} q_off={q_off} "
                        f"kv_off={kv_off} causal={causal}", qf, kf, vf,
                        q_off, kv_off, causal, sm90)
                    if main:
                        worst[kname] = max(worst[kname], err_f)
            # Packed waves of the pipelined run: 1,024-token rows of
            # 128-, 512- and 1,024-token segments (the wrapper's kernel).
            for nseg, seg_len in PACKED_WAVES:
                err_w, valid = check_packed_wave(gen, tag, dtype, dev, s,
                                                 nseg, seg_len)
                if pr7_draws and (shape_name, dtype, nseg) == (
                        "gqa_serve", torch.float32, 8):
                    print(f"[kernel] PR 7's draws reproduced (valid "
                          f"prefixes {PR7_WAVE}): {valid == PR7_WAVE}")
                if main:
                    worst["flash_fwd_sm90"] = max(worst["flash_fwd_sm90"],
                                                  err_w)
    if not pr7_draws:
        for seed in (2, 3, 4):
            check_packed_wave(torch.Generator(device=dev).manual_seed(seed),
                              f"gqa_serve float32 seed {seed}",
                              torch.float32, dev, SHAPES["gqa_serve"], 8,
                              1024)
    return worst


def check_decode_launches(launches, cfg, phase):
    """Every decode step (eager, replayed, or a step of a chunk) runs one
    rotating row write and one paged decode per layer, and the plain row
    write never."""
    rope, paged = launches["rope_row_write"], launches["paged_decode_attention"]
    check(launches["row_write"] == 0,
          f"{phase} the plain row write ran on the decode path")
    check(rope == paged and rope % cfg.num_layers == 0,
          f"{phase} {rope} rotating row writes for {paged} paged decodes "
          f"({cfg.num_layers} layers): not one each per layer and step")
    print(f"{phase} rotating row write: {rope} launches = "
          f"{rope // cfg.num_layers} decode steps x {cfg.num_layers} layers "
          f"(one per layer and step, as paged decode); row_write 0")


def make_prompts(rng, lens, prefix_len, prefixed):
    prefix = rng.integers(1, 32000, size=prefix_len).tolist()
    prompts = [rng.integers(1, 32000, size=n).tolist() for n in lens]
    prompts += [prefix + rng.integers(1, 32000, size=n).tolist()
                for n in prefixed]
    return prompts


def phase_main_path(dev, params, cfg):
    """LLMEngine on Llama-2-7B, 12 requests; returns launches per kernel,
    the engine, the prompts and the rates."""
    eng = LLMEngine(cfg, params, device=dev, page_size=128, num_pages=96,
                    max_batch=8)
    rng = np.random.default_rng(0)
    # 10 prompts of 60-1000 tokens, then two that share a 256-token
    # (two-page) prefix: the second is served from the prefix cache.
    prompts = make_prompts(rng, [1000, 60, 777, 333, 900, 128, 640, 512,
                                 257, 64], 256, [100, 37])
    max_new = rng.integers(32, 65, size=len(prompts)).tolist()

    admit_s, decode_s, decode_tokens = [0.0], [0.0], [0]
    inner_admit, inner_decode = eng._admit, eng._decode

    def timed_admit():
        t = time.perf_counter()
        out = inner_admit()
        torch.cuda.synchronize()
        admit_s[0] += time.perf_counter() - t
        return out

    def timed_decode():  # graph captures excluded (printed apart)
        n = eng.num_active
        c0 = eng.graphs.capture_seconds
        t = time.perf_counter()
        out = inner_decode()
        torch.cuda.synchronize()
        decode_s[0] += time.perf_counter() - t - (
            eng.graphs.capture_seconds - c0)
        decode_tokens[0] += n
        return out

    eng._admit, eng._decode = timed_admit, timed_decode
    for spec in KERNELS.values():
        spec["kernel"].launches = 0
    t0 = time.perf_counter()
    ids = [eng.add_request(p, n) for p, n in zip(prompts, max_new)]
    done, steps = {}, 0
    while eng.has_work():
        done.update(eng.step())
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: spec["kernel"].launches
                for name, spec in KERNELS.items()}
    eng._admit, eng._decode = inner_admit, inner_decode

    for rid, n in zip(ids, max_new):
        toks = done.get(rid)
        check(toks is not None and len(toks) == n
              and all(0 <= t < cfg.vocab_size for t in toks),
              f"request {rid} did not finish with {n} tokens")
    check(eng.prefix_cache.hits >= 1, "the shared prefix never hit")
    check(eng.allocator.num_free + eng.prefix_cache.num_idle
          == eng.allocator.num_pages - 1, "pages leaked")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched on the main path")
    check_decode_launches(launches, cfg, "[main]")
    for name in REPLACED:  # every forward is bf16 at d = 128
        check(launches[name] == 0,
              f"{name} ran on the main path beside its Hopper kernel")
    prompt_tokens = sum(map(len, prompts)) - eng.prefix_cache.tokens_saved
    rates = dict(prefill_tok_s=prompt_tokens / admit_s[0],
                 decode_tok_s=decode_tokens[0] / decode_s[0])
    print(f"[main] {len(prompts)} requests, {steps} steps, {wall:.2f} s; "
          f"prompt tokens computed {prompt_tokens} (prefix cache saved "
          f"{eng.prefix_cache.tokens_saved}); prefill {admit_s[0]:.3f} s, "
          f"decode {decode_tokens[0]} tokens in {decode_s[0]:.3f} s")
    print(f"[main] launches {json.dumps(launches)}")
    return launches, eng, prompts, max_new, rates


def phase_depth_bf16(dev, params, cfg):
    """Teacher-forced, bf16, full depth: prefill + 4 decode steps on the
    kernel path and on the plain path, same input tokens."""
    rng = np.random.default_rng(2)
    prompts = make_prompts(rng, [60, 333, 700, 1000], 0, [])
    B, S, page, npg = 4, 1024, 128, 40
    tokens = np.zeros((B, S), dtype=np.int32)
    positions = np.full((B, S), -1, dtype=np.int32)
    tables = np.zeros((B, 16), dtype=np.int32)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = p
        positions[r, :len(p)] = np.arange(len(p))
        tables[r, :9] = np.arange(r * 9, r * 9 + 9)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    caches = [tdec.init_kv_pages(cfg, npg, page, device=dev)
              for _ in range(2)]

    def run(cache, step_tokens, pos, ctx):
        if step_tokens is None:
            return tdec.prefill(params, t(tokens), t(positions), cache,
                                t(tables), cfg)[0]
        return tdec.decode_step(params, t(step_tokens), cache,
                                t(tables[:, :9]), t(pos), t(ctx), cfg)[0]

    lens = np.array([len(p) for p in prompts], dtype=np.int32)
    step_tokens, worst_rel, agree = None, 0.0, []
    for step in range(5):
        pos, ctx = lens + step - 1, lens + step
        kern = run(caches[0], step_tokens, pos, ctx)
        with plain_ops():
            plain = run(caches[1], step_tokens, pos, ctx)
        rel = ((kern - plain).abs().max() / plain.abs().max()).item()
        worst_rel = max(worst_rel, rel)
        agree.append(float((kern.argmax(-1) == plain.argmax(-1))
                           .float().mean()))
        step_tokens = kern.argmax(-1).int().cpu().numpy()
    print(f"[depth] bf16 32 layers, prefill + 4 decode steps: max |kernel "
          f"- plain| / max |plain| = {worst_rel:.3e} (tolerance "
          f"{DEPTH_REL_TOL}); argmax agreement per step {agree}")
    check(worst_rel <= DEPTH_REL_TOL, "bf16 kernel path drifts from plain")


def phase_depth_fp32(dev, cfg=None, params=None, tag="[depth]"):
    """fp32, full width, 2 layers (default Llama-2-7B's): greedy tokens
    of the kernel path and the plain path identical for 16 steps,
    through the classic LLMEngine."""
    if cfg is None:
        cfg = TransformerConfig.llama2_7b(num_layers=2, dtype=torch.float32)
        params = init_params(cfg, seed=3, device=dev, dtype=torch.float32)
    prompts = make_prompts(np.random.default_rng(3), [60, 333, 700, 1000],
                           0, [])
    kw = dict(device=dev, page_size=128, num_pages=40, max_batch=4)
    kern = LLMEngine(cfg, params, **kw).generate(prompts, 16)
    with plain_ops():
        plain = LLMEngine(cfg, params, **kw).generate(prompts, 16)
    same = kern == plain
    print(f"{tag} fp32 2 layers, 16 greedy steps x {len(prompts)} "
          f"requests: tokens identical {same}")
    check(same, f"{tag} fp32 kernel path tokens differ from the plain path")


def profiled(fn, calls, label, smi, show=None):
    """Run fn `calls` times under torch.profiler; print the wall time per
    call, the card's busy time (its kernels' total) and its device time
    and launches by kind of kernel, and the kernels of kind `show` by
    name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e6
    share = f"{busy / wall:.1%}" if on_card else "not measured"
    print(f"[profile] {label} on {smi} (profiler on): "
          f"{wall / calls * 1e3:.2f} ms per step, card busy "
          f"{busy / calls * 1e3:.2f} ms per step ({share})")
    groups, counts = {}, {}
    for e in on_card:
        kind = next((g for g, pat in PROFILE_GROUPS if re.search(pat, e.key)),
                    "other")
        groups[kind] = groups.get(kind, 0.0) + e.self_device_time_total
        counts[kind] = counts.get(kind, 0) + e.count
    print("[profile]   by kind, ms per step: " + ", ".join(
        f"{g} {t / 1e3 / calls:.2f}" for g, t in sorted(
            groups.items(), key=lambda kv: -kv[1])))
    print(f"[profile]   launches per step {sum(counts.values()) / calls:.0f}"
          f", by kind: " + ", ".join(
              f"{g} {n / calls:.0f}" for g, n in sorted(
                  counts.items(), key=lambda kv: -kv[1])))
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total):
        if show and re.search(dict(PROFILE_GROUPS)[show], e.key):
            print(f"[profile]   {show}: {e.key[:90]}: "
                  f"{e.self_device_time_total / 1e3 / calls:.3f} ms and "
                  f"{e.count / calls:.0f} launches per step")
    return counts


def phase_profile(eng, smi):
    """Where the time goes: an admission step (8 fresh prompts, 4,350
    tokens, prefilled by length bucket, then one decode step), then 4
    pure decode steps at 8 active requests."""
    prompts = make_prompts(np.random.default_rng(5), [1000, 60, 777, 333,
                                                      900, 128, 640, 512],
                           0, [])
    for p in prompts:
        eng.add_request(p, 24)
    profiled(eng.step, 1, "admission step (prefill of 8 prompts + 1 "
             "decode)", smi)
    profiled(eng.step, 4, "decode step at 8 active requests", smi)
    while eng.has_work():
        eng.step()


def phase_timings(dev, eng, prompts, max_new, smi):
    """Each kernel at the main path's shapes: its time, its plain
    version's, one PyTorch call's where one computes the same function,
    and its bound (the larger of bytes / memory rate and operations /
    peak rate)."""
    cfg, page = eng.config, eng.page_size
    H, D, KVH = cfg.num_heads, cfg.head_dim_, cfg.num_kv_heads
    KD, bf = KVH * D, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = {}

    # Decode: the batch of the first 8 requests at their final lengths.
    lens = [len(p) + n for p, n in zip(prompts[:8], max_new[:8])]
    B = len(lens)
    W = 1 << (math.ceil(max(lens) / page) - 1).bit_length()
    ck, cv, L, P = tdec._flat_cache(eng.cache)
    tables = torch.randperm(L * P - 1, generator=gen, device=dev)[
        :B * W].reshape(B, W).int()
    ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = rand(gen, (B, H, D), bf, dev)
    cases["paged_decode_attention"] = dict(
        kernel=lambda: tpa.paged_attention(q, ck, cv, tables, ctx),
        plain=lambda: tpa.paged_attention_plain(q, ck, cv, tables, ctx),
        library=None, n=(200, 20),
        bytes=sum(lens) * KD * 2 * 2 + 2 * q.numel() * 2
        + tables.numel() * 4 + B * 4,
        flops=4 * sum(lens) * H * D,
        shape=f"B={B} H={H} KVH={KVH} D={D} page={page} W={W} ctx={lens}")

    # Row write into the engine's whole flat cache, one row per slot.
    kn = rand(gen, (B, KVH, D), bf, dev)
    vn = rand(gen, (B, KVH, D), bf, dev)
    pos = ctx - 1
    slot = (pos.long() // page).clamp_max(W - 1)
    pg = tables.long().gather(1, slot[:, None])[:, 0]
    off = pos.long() % page
    rows_k, rows_v = kn.reshape(B, KD), vn.reshape(B, KD)

    def index_put():
        ck.index_put_((pg, off), rows_k)
        cv.index_put_((pg, off), rows_v)

    cases["row_write"] = dict(
        kernel=lambda: tpa.write_token_rows(ck, cv, kn, vn, tables, pos),
        plain=lambda: tpa.write_token_rows_plain(ck, cv, kn, vn, tables,
                                                 pos),
        library=index_put, n=(200, 50),
        bytes=4 * B * KD * 2 + B * 4 + B * W * 4, flops=0,
        shape=f"B={B} KD={KD} into [{L * P}, {page}, {KD}]")

    # Rotating row write, at the classic batch and table width (the
    # kernels line's row) and at the pipelined run's (B = 16 over 16-page
    # tables, two idle slots), beside the sequence it replaced (two
    # apply_rope and the row-write kernel, replayed like the kernel).
    # Bytes: q, k and v read, q and the K and V rows written, the cos and
    # sin rows of B positions and one table entry and position per row;
    # operations: 4 products and 2 sums per rotated pair, in fp32.
    cos, sin = tdec.rope_tables(cfg, dev)
    pipe_ctx = [0, 1, 100, 127, 128, 129, 255, 256, 257, 500, 640, 777,
                0, 1000, 1100, 1128]
    tables16 = torch.randperm(L * P - 1, generator=gen, device=dev)[
        :16 * 16].reshape(16, 16).int()
    pos16 = torch.tensor(pipe_ctx, dtype=torch.int32, device=dev) - 1
    for name, rb, rtables, rpos in (("rope_row_write", B, tables, pos),
                                    ("rope_row_write B=16", 16, tables16,
                                     pos16)):
        rq = rand(gen, (rb, H, D), bf, dev)
        rk = rand(gen, (rb, KVH, D), bf, dev)
        rv = rand(gen, (rb, KVH, D), bf, dev)
        args = (rq, rk, rv, cos, sin, ck, cv, rtables, rpos)
        cases[name] = dict(
            kernel=lambda args=args: tpa.rope_write_token_rows(*args),
            plain=lambda args=args: tpa.rope_write_token_rows_plain(*args),
            replaced=lambda args=args: unfused_rope_row_write(*args),
            library=None, n=(200, 50),
            bytes=(2 * rb * H * D + 4 * rb * KD) * 2 + rb * D * 4 + rb * 8,
            flops=6 * rb * (H + KVH) * (D // 2), peak=PEAK_FLOPS[torch.float32],
            shape=f"B={rb} H={H} KVH={KVH} D={D} W={rtables.shape[1]} "
            f"positions {int(rpos.min())}..{int(rpos.max())} into "
            f"[{L * P}, {page}, {KD}]")

    # Flash forward: the main path's 1024-token prefill bucket.
    b = sum(1 for p in prompts[:8] if 512 < len(p) <= 1024)
    b, s = 1 << (b - 1).bit_length(), 1024
    qf = rand(gen, (b, s, H, D), bf, dev)
    kf = rand(gen, (b, s, KVH, D), bf, dev)
    vf = rand(gen, (b, s, KVH, D), bf, dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (qf, kf, vf))
    scale = 1.0 / math.sqrt(D)
    for kname, sm90 in (("flash_fwd_sm90", True), ("flash_fwd", False)):
        cases[kname] = dict(
            kernel=lambda sm90=sm90: tat._flash_chunk_cuda(
                qf, kf, vf, 0, 0, True, scale, sm90=sm90),
            plain=lambda: tat.flash_attention_chunk_plain(qf, kf, vf, 0, 0),
            library=lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True),
            n=(20, 5),
            bytes=(2 * b * s * H * D + 2 * b * s * KVH * D) * 2
            + b * H * s * 4,
            flops=4 * b * H * D * s * (s + 1) // 2,
            pr2="flash_fwd (prefill shape)",
            shape=f"b={b} s={s} H={H} KVH={KVH} D={D} causal")

    out = {}
    for name, c in cases.items():
        n_kernel, n_plain = c["n"]
        ms, eager = time_ms(c["kernel"], n_kernel)
        plain_ms, plain_eager = time_ms(c["plain"], n_plain)
        lib = time_ms(c["library"], n_kernel) if c["library"] else None
        t_bytes = c["bytes"] / HBM_BYTES_S * 1e3
        t_ops = c["flops"] / c.get("peak", PEAK_FLOPS[bf]) * 1e3
        out[name] = r = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib and lib[0],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        if "replaced" in c:
            r["replaced_ms"], rep_eager = time_ms(c["replaced"], n_plain)
        lib_text = ("none (no single PyTorch call)" if lib is None
                    else f"{lib[0]:.4f} ms (eager {lib[1]:.4f})")
        extra = ""
        if c["flops"]:
            extra = f", {c['flops'] / ms / 1e9:.1f} TFLOP/s"
        if "pr2" in c:
            extra += f", PR 2 kernel {PR2_MS[c['pr2']]:.4f} ms (PERF.md)"
        if "replaced" in c:
            extra += (f", the sequence it replaced (2 x apply_rope + "
                      f"row_write) {r['replaced_ms']:.4f} ms (eager "
                      f"{rep_eager:.4f}), {r['replaced_ms'] / ms:.2f}x")
        print(f"[time] {name} [{c['shape']}] on {smi}: device {ms:.4f} ms "
              f"(eager, host included: {eager:.4f}{extra}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{plain_ms:.4f} ms (eager {plain_eager:.4f}), library "
              f"{lib_text}")
    # The card's per-launch floor: the least device time of any kernel,
    # timed by the same graph replay (a launch that does almost nothing).
    one = torch.zeros(1, device=dev)
    floor_ms, floor_eager = time_ms(lambda: one.add_(1.0), 200)
    print(f"[time] launch floor [one-element in-place add_] on {smi}: "
          f"device {floor_ms:.4f} ms per launch (eager, host included: "
          f"{floor_eager:.4f}); " + "; ".join(
              f"{k} {out[k]['ms']:.4f} ms is {out[k]['ms'] / floor_ms:.2f}x "
              f"the floor" for k in ("row_write", "rope_row_write",
                                     "rope_row_write B=16")))
    return out


# ---------------------------------------------------------------------------
# Pipelined multi-step decode under CUDA graphs
# ---------------------------------------------------------------------------

# The pipelined engine at the repo's serving guidance (page >= 64,
# multi_step 16-32 with pipelined dispatch): 192 pages x 64 MB of KV.
PIPE = dict(page_size=128, num_pages=192, max_batch=16, multi_step=16,
            pipeline_depth=2, packed_admit=True)


def pipelined_requests(rng):
    """16 prompts of 100-1,000 tokens (the last two share a 256-token
    prefix), 8 more for later, and 64-128 new tokens each."""
    prefix = rng.integers(1, 32000, size=256).tolist()
    first = [rng.integers(1, 32000, size=n).tolist()
             for n in rng.integers(100, 1001, size=14)]
    first += [prefix + rng.integers(1, 32000, size=n).tolist()
              for n in (60, 150)]
    later = [rng.integers(1, 32000, size=n).tolist()
             for n in rng.integers(100, 1001, size=8)]
    max_new = rng.integers(64, 129, size=24).tolist()
    return first, later, max_new


def host_ms(fn, n):
    """Median host ms of one call of fn followed by a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return float(np.median(times)) * 1e3


def phase_pipelined(dev, params, cfg, smi, tag="[pipelined]",
                    model="Llama-2-7B bf16"):
    """The pipelined engine on `model` (Llama-2-7B at full width and
    depth; `[moe]`: Mixtral-8x7B widths): 16 requests at the start, 8
    more after the third step, every decode a replayed graph; returns
    launches per kernel, the engine, the requests and their streams."""
    eng = LLMEngine(cfg, params, device=dev, **PIPE)
    first, later, max_new = pipelined_requests(np.random.default_rng(10))
    reqs = {}

    def add(prompt, n):
        rid = eng.add_request(prompt, n)
        reqs[rid] = eng.waiting[-1]
        return rid

    def generated():
        return sum(len(r.generated) for r in reqs.values())

    # Device time of each wave (CUDA events around its dispatch, read at
    # the end: no wait on the card) and its prompt tokens; classic
    # admissions counted, so that decode steps are the steps without.
    waves, classic = [], [0]
    inner_wave, inner_admit = eng._dispatch_prefill_wave, eng._admit

    def wave():
        queue = list(eng.waiting)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        n = inner_wave()
        if n:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            waves.append((start, end, sum(len(r.prompt) for r in queue[:n])))
        return n

    def admit():
        classic[0] += 1
        return inner_admit()

    eng._dispatch_prefill_wave, eng._admit = wave, admit
    for spec in KERNELS.values():
        spec["kernel"].launches = 0
    t0 = time.perf_counter()
    ids = [add(p, n) for p, n in zip(first, max_new[:16])]
    done, steps, decode_s, decode_tokens = {}, 0, 0.0, 0
    while eng.has_work():
        if steps == 3:
            ids += [add(p, n) for p, n in zip(later, max_new[16:])]
        w0, a0, g0 = eng.waves_dispatched, classic[0], generated()
        c0 = eng.graphs.capture_seconds
        t = time.perf_counter()
        done.update(eng.step())
        dt = time.perf_counter() - t - (eng.graphs.capture_seconds - c0)
        if eng.waves_dispatched == w0 and classic[0] == a0:
            decode_s += dt
            decode_tokens += generated() - g0
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: spec["kernel"].launches
                for name, spec in KERNELS.items()}
    eng._dispatch_prefill_wave, eng._admit = inner_wave, inner_admit

    prompts = first + later
    for rid, n in zip(ids, max_new):
        toks = done.get(rid)
        check(toks is not None and len(toks) == n
              and all(0 <= t < cfg.vocab_size for t in toks),
              f"{tag} request {rid} did not finish with {n} tokens")
    check(eng.allocator.num_free + eng.prefix_cache.num_idle
          == eng.allocator.num_pages - 1, f"{tag} pages leaked")
    check(eng.prefix_cache.hits >= 1, f"{tag} the prefix never hit")
    check(eng.waves_dispatched >= 1 and eng.prefill_reconciles >= 1,
          f"{tag} no packed wave dispatched and reconciled")
    g = eng.graphs
    bound = len(tdg.KINDS) * g.bucket_bound()
    check(g.captures <= bound, f"{g.captures} captures, bound {bound}")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"{tag} kernel {name} never launched in the pipelined run")
    check_decode_launches(launches, cfg, tag)
    for name in REPLACED:
        check(launches[name] == 0,
              f"{tag} {name} ran beside its Hopper kernel")
    wave_ms = sum(a.elapsed_time(b) for a, b, _ in waves)
    wave_tokens = sum(n for _, _, n in waves)
    print(f"{tag} {model}, {json.dumps(PIPE)}, on {smi}: {len(ids)} "
          f"requests (8 added after step 3), {steps} steps, {wall:.2f} s; "
          f"{eng.waves_dispatched} waves ({wave_tokens} prompt tokens), "
          f"{classic[0]} classic admissions, prefix-cache hits "
          f"{eng.prefix_cache.hits}, prefill reconciles "
          f"{eng.prefill_reconciles}")
    print(f"{tag} graph captures {g.captures} (bound {bound}: "
          f"{len(tdg.KINDS)} kinds x {g.bucket_bound()} width buckets), "
          f"{g.capture_seconds:.2f} s in all on {smi} (warm-ups included; "
          f"left out of the decode rate)")
    print(f"{tag} launches, replays counted {json.dumps(launches)}")
    busy_s = wall - g.capture_seconds
    print(f"{tag} on {smi}: decode {decode_tokens / decode_s:.0f} "
          f"tok/s ({decode_tokens} tokens reconciled over {decode_s:.3f} s "
          f"of host time of the steps that admitted nothing); prefill "
          f"through waves {wave_tokens / wave_ms * 1e3:.0f} tok/s "
          f"({wave_tokens} tokens over {wave_ms:.1f} ms of device time, "
          f"CUDA events); all steps {generated()} tokens in {busy_s:.2f} s "
          f"({generated() / busy_s:.0f} tok/s, captures left out)")
    return launches, eng, prompts, max_new, [done[rid] for rid in ids]


def phase_pipelined_bf16_checks(dev, params, cfg, prompts, max_new,
                                streams):
    """Full width, bf16, reported and not gated (packing and speculation
    change matmul shapes, so bf16 rounding may part streams): the share
    of pipelined streams equal to the classic engine's, and a
    speculative run's drafted and accepted counts."""
    classic = LLMEngine(cfg, params, device=dev, page_size=128,
                        num_pages=192, max_batch=16)
    ids = [classic.add_request(p, n) for p, n in zip(prompts, max_new)]
    done = {}
    while classic.has_work():
        done.update(classic.step())
    same = sum(done[i] == s for i, s in zip(ids, streams))
    first_diff = [next((j for j, (a, b) in enumerate(zip(done[i], s))
                        if a != b), None) for i, s in zip(ids, streams)]
    print(f"[pipelined] bf16 32 layers: {same} of {len(ids)} pipelined "
          f"streams equal the classic engine's "
          f"({same / len(ids):.1%}); first differing token per stream "
          f"{first_diff}")
    del classic
    spec = LLMEngine(cfg, params, device=dev, page_size=128, num_pages=64,
                     max_batch=8, speculative_k=4)
    out = spec.generate(prompts[:8], 32)
    check(all(len(o) == 32 for o in out), "speculative run incomplete")
    print(f"[pipelined] bf16 32 layers, speculative_k=4, 8 requests x 32 "
          f"tokens: {spec.spec_steps} verify steps, drafted "
          f"{spec.spec_drafted}, accepted {spec.spec_accepted}")


# ---------------------------------------------------------------------------
# The engine's observability plane on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def env_var(name, value):
    """Set one environment variable for the block, then restore it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def obs_engine(dev, params, cfg, telemetry):
    """[pipelined]'s engine with the step sampler every 2 steps and the
    device stats on, or with both off (RAY_TPU_DEVICE_STATS=0, sampler 0)."""
    tds.set_enabled(telemetry)
    with env_var("RAY_TPU_SERVE_STEP_SAMPLE_EVERY", "2" if telemetry
                 else "0"):
        return LLMEngine(cfg, params, device=dev, **PIPE)


def obs_run(eng, traced):
    """[pipelined]'s 24 requests through `eng`, every other one traced
    when `traced`.  Returns the request ids, their streams, the engine
    samples seen, and the decode-only steps' (no admission, no capture)
    count, host seconds and seconds of that spent waiting on the card
    (the engine's `read` of a record)."""
    first, later, max_new = pipelined_requests(np.random.default_rng(10))
    waited = [0.0]
    inner_read = tsrv.read

    def timed_read(host, event):
        t = time.perf_counter()
        out = inner_read(host, event)
        waited[0] += time.perf_counter() - t
        return out

    ids = []

    def add(prompt, n):
        ctx = ((ttracing.new_span_id(), ttracing.new_span_id())
               if traced and len(ids) % 2 else None)
        ids.append(eng.add_request(prompt, n, trace_ctx=ctx))

    tsrv.read = timed_read
    try:
        for p, n in zip(first, max_new[:16]):
            add(p, n)
        done, samples, steps = {}, [], 0
        dec = dict(steps=0, wall=0.0, wait=0.0)
        while eng.has_work():
            if steps == 3:
                for p, n in zip(later, max_new[16:]):
                    add(p, n)
            w0, q0, c0 = eng.waves_dispatched, len(eng.waiting), \
                eng.graphs.captures
            wait0, t = waited[0], time.perf_counter()
            done.update(eng.step())
            dt = time.perf_counter() - t
            if (eng.waves_dispatched, len(eng.waiting),
                    eng.graphs.captures) == (w0, q0, c0):
                dec["steps"] += 1
                dec["wall"] += dt
                dec["wait"] += waited[0] - wait0
            s = eng.engine_sample
            if s is not None and (not samples or s is not samples[-1]):
                samples.append(s)
            steps += 1
        torch.cuda.synchronize()
    finally:
        tsrv.read = inner_read
    return ids, [done[i] for i in ids], samples, dec


def serve_hist_counts(name):
    snap = next(s for s in tmetrics.local_snapshots() if s["name"] == name)
    return sum(v[2] for v in snap["series"].values())


def percentiles(values):
    return (float(np.percentile(values, 50)),
            float(np.percentile(values, 99)))


def phase_obs(dev, params, cfg, smi, launches_ref, streams_ref):
    """[obs]: [pipelined]'s engine, weights and 24 requests with the
    sampler every 2 steps and every other request traced; checks the SLO
    samples, the phase spans, the sampler's roofline fraction and MFU,
    the HBM ledger and the capture counts, and that the streams and every
    kernel's launches equal [pipelined]'s; then the same run twice with
    telemetry off, for the host cost per chunk."""
    tds.reset()
    ttracing.clear_spans()
    ttft0 = serve_hist_counts("ray_tpu_serve_ttft_seconds")
    tpot0 = serve_hist_counts("ray_tpu_serve_tpot_seconds")
    eng = obs_engine(dev, params, cfg, telemetry=True)
    for spec in KERNELS.values():
        spec["kernel"].launches = 0
    ids, streams, samples, dec_on = obs_run(eng, traced=True)
    launches = {name: spec["kernel"].launches
                for name, spec in KERNELS.items()}
    check(streams == streams_ref,
          "[obs] token streams differ from [pipelined]'s")
    check(launches == launches_ref,
          f"[obs] launches {launches} differ from [pipelined]'s "
          f"{launches_ref}")

    # Requests: one SLO sample each.
    slo = [s for s in eng.slo_samples if "shed" not in s]
    check(len(slo) == len(ids) and len(eng.slo_samples) == len(ids),
          f"[obs] {len(eng.slo_samples)} SLO samples for {len(ids)} requests")
    check(sorted(s["tokens"] for s in slo) == sorted(map(len, streams)),
          "[obs] SLO samples' tokens differ from the streams' lengths")
    check(all(s["ttft"] > 0 and (s["tpot"] > 0 or s["tokens"] == 1)
              for s in slo), "[obs] an SLO sample has ttft or tpot 0")
    for name, before in (("ray_tpu_serve_ttft_seconds", ttft0),
                         ("ray_tpu_serve_tpot_seconds", tpot0)):
        got = serve_hist_counts(name) - before
        check(got == len(ids), f"[obs] {name} counted {got}")
    ttft = percentiles([s["ttft"] * 1e3 for s in slo])
    tpot = percentiles([s["tpot"] * 1e3 for s in slo])
    print(f"[obs] Llama-2-7B bf16, {json.dumps(PIPE)}, sampler every 2 "
          f"steps, on {smi}: {len(slo)} SLO samples; TTFT p50 "
          f"{ttft[0]:.1f} ms, p99 {ttft[1]:.1f} ms; TPOT p50 {tpot[0]:.2f} "
          f"ms, p99 {tpot[1]:.2f} ms (engine slo_samples, host clock)")

    # Spans: traced requests tile queue -> prefill -> decode.
    spans = {}
    for sp in ttracing.get_spans():
        if sp["name"].startswith("serve."):
            spans.setdefault(sp["attributes"]["req"], {})[sp["name"]] = sp
    traced = ids[1::2]
    check(sorted(spans) == sorted(traced),
          f"[obs] serve.* spans for requests {sorted(spans)}, traced "
          f"{sorted(traced)}")
    for rid in traced:
        j = spans[rid]
        check({"serve.queue", "serve.prefill", "serve.decode"} <= set(j)
              and j["serve.queue"]["end"] == j["serve.prefill"]["start"]
              and j["serve.prefill"]["end"] == j["serve.decode"]["start"],
              f"[obs] request {rid}'s phase spans do not tile: "
              f"{sorted(j)}")
    print(f"[obs] spans: {len(traced)} traced requests x serve.queue / "
          f"serve.prefill / serve.decode, tiling; {len(ids) - len(traced)} "
          f"untraced requests, no serve.* span")

    # The sampler.
    timed = [s for s in samples if s.get("tokens_per_s", 0) > 0]
    check(any(0 < s["roofline_fraction"] <= 1.0 and s["mfu"] > 0
              for s in timed), f"[obs] no sample with a roofline "
          f"fraction in (0, 1] and mfu > 0: {timed}")
    check(all(s["roofline_fraction"] <= 1.0 for s in timed),
          "[obs] a roofline fraction over 1.0: the modeled bytes are wrong")
    last = tds.last_step()
    check(last is not None and last["plane"] == "serve",
          f"[obs] last_step {last}")
    fracs = [s["roofline_fraction"] for s in timed]
    mfus = [s["mfu"] for s in timed]
    print(f"[obs] sampler on {smi}: {len(samples)} samples, {len(timed)} "
          f"with tokens; roofline fraction min {min(fracs):.4f} median "
          f"{float(np.median(fracs)):.4f} max {max(fracs):.4f}; mfu median "
          f"{float(np.median(mfus)):.4f}; a sample: {json.dumps(timed[-1])}")

    # The ledger.
    led = tds.ledger()
    seen = {}
    for t in toptim.tree_leaves(eng.params):
        seen[t.data_ptr()] = t.numel() * t.element_size()
    weights = sum(seen.values())
    kv = (PIPE["num_pages"] * PIPE["page_size"] * cfg.num_layers * 2
          * cfg.num_kv_heads * cfg.head_dim_
          * torch.empty((), dtype=cfg.dtype).element_size())
    check(led["backend"] == "cuda"
          and led["device_kind"] == torch.cuda.get_device_name(0),
          f"[obs] ledger backend {led['backend']} {led['device_kind']}")
    check(led["components"] == {"weights": weights, "kv_pages": kv},
          f"[obs] ledger components {led['components']}, want weights "
          f"{weights} and kv_pages {kv}")
    check(led["used_bytes"] >= weights + kv,
          f"[obs] ledger used {led['used_bytes']} < weights + KV")
    print(f"[obs] ledger on {smi}: weights {weights / 1e9:.3f} GB, "
          f"kv_pages {kv / 1e9:.3f} GB, used {led['used_bytes'] / 1e9:.3f} "
          f"GB, workspace {led['workspace_bytes'] / 1e9:.3f} GB, capacity "
          f"{led['capacity_bytes'] / 1e9:.3f} GB, watermark "
          f"{led['watermark_fraction']:.4f}")

    # Compile accounting: each capture is one decode_graph.* compilation.
    counts = {k: v["count"] for k, v in tds.compile_counts().items()}
    graphs = sum(n for k, n in counts.items()
                 if k.startswith("decode_graph."))
    check(graphs == eng.graphs.captures > 0,
          f"[obs] {graphs} decode_graph compilations, "
          f"{eng.graphs.captures} captures")
    print(f"[obs] compile counts {json.dumps(counts)}; recompiles after "
          f"warm-up {json.dumps(tds.recompiles_after_warmup())}")
    del eng
    gc.collect()

    # Telemetry off, twice: host ms per decode-only step (one replayed
    # 16-step chunk dispatched, one reconciled).
    runs = [("on", dec_on)]
    for i in range(2):
        eng = obs_engine(dev, params, cfg, telemetry=False)
        _, off_streams, off_samples, dec = obs_run(eng, traced=False)
        check(off_streams == streams_ref and not off_samples,
              "[obs] the telemetry-off run differs")
        runs.append((f"off{i + 1}", dec))
        del eng
        gc.collect()
    tds.set_enabled(True)
    torch.cuda.empty_cache()
    own = {k: (d["wall"] - d["wait"]) / d["steps"] * 1e3 for k, d in runs}
    wall = {k: d["wall"] / d["steps"] * 1e3 for k, d in runs}
    print(f"[obs] host ms per 16-step chunk (decode-only steps, replayed) "
          f"on {smi}: the host's own work (step wall minus its wait on the "
          f"card) " + ", ".join(f"{k} {own[k]:.3f}" for k, _ in runs)
          + "; step wall " + ", ".join(f"{k} {wall[k]:.2f}" for k, _ in runs)
          + f"; {runs[0][1]['steps']} / {runs[1][1]['steps']} / "
          f"{runs[2][1]['steps']} steps; telemetry's cost per chunk "
          f"{own['on'] - (own['off1'] + own['off2']) / 2:+.3f} ms (own "
          f"work, on minus the mean of off)")


def graph_state(graphs, ctx, limit, seed, page=128):
    """Live state for every slot at contexts `ctx` (random tokens, limits
    ctx + limit, no EOS), each slot's table on pages of its own for the
    positions it can reach; returns a copy of the state."""
    B = len(ctx)
    ctx = np.asarray(ctx, dtype=np.int32)
    rng = np.random.default_rng(seed)
    tdg.upload(graphs.state, np.stack([
        rng.integers(1, 32000, size=B), ctx, ctx + 1, ctx + limit,
        np.full(B, -1)]).astype(np.int32))
    cols = -(-int(ctx.max() + limit + 1) // page)
    P = graphs.cache["k"].shape[1]
    check(B * cols <= P - 1, "too few pages for distinct tables")
    tables = np.zeros(tuple(graphs.tables.shape), dtype=np.int32)
    tables[:, :cols] = rng.permutation(P - 1)[:B * cols].reshape(B, cols)
    tdg.upload(graphs.tables, tables)
    return graphs.state.clone()


def phase_graph_timings(main_eng, pipe_eng, smi):
    """Host time of one synchronized decode_step at B = 8 and of one
    16-step chunk at B = 16, eager against replay, and the card's busy
    share of a replayed chunk."""
    g8 = main_eng.graphs
    ctx = [1000, 60, 777, 333, 900, 128, 640, 512]
    snap8 = graph_state(g8, ctx, 64, 1)
    W8 = main_eng._table_width(max(ctx) + 1)

    def step(replay):
        g8.state.copy_(snap8)
        return g8.decode_step(W8) if replay else g8._step(g8.state, W8)

    step_eager = host_ms(lambda: step(False), 20)
    step_replay = host_ms(lambda: step(True), 20)
    print(f"[graph] decode_step B=8 W={W8} Llama-2-7B bf16 on {smi}: host "
          f"ms per synchronized call, eager {step_eager:.2f}, replay "
          f"{step_replay:.2f} ({step_eager / step_replay:.2f}x)")
    g16, n = pipe_eng.graphs, pipe_eng.multi_step
    ctx = np.random.default_rng(3).integers(100, 1001, size=16)
    snap16 = graph_state(g16, ctx, 4 * n, 2)
    W16 = pipe_eng._table_width(int(ctx.max()) + n)

    def chunk(replay):
        g16.state.copy_(snap16)
        return (g16.multi_step(W16, n) if replay
                else g16._chunk(g16.state, W16, n, True))

    chunk_eager = host_ms(lambda: chunk(False), 3)
    chunk_replay = host_ms(lambda: chunk(True), 5)
    print(f"[graph] {n}-step chunk B=16 W={W16} Llama-2-7B bf16 on {smi}: "
          f"host ms per synchronized call, eager {chunk_eager:.1f}, replay "
          f"{chunk_replay:.1f} ({chunk_eager / chunk_replay:.2f}x); per "
          f"step {chunk_replay / n:.2f} ms replayed, "
          f"{16 * n / chunk_replay * 1e3:.0f} tok/s at 16 slots")
    calls = 3
    after = profiled(lambda: chunk(True), calls,
                     f"replayed {n}-step chunk at 16 active requests", smi)

    # Before and after in one run: the same chunk captured with the
    # decode layers' sequence before the rotating row write (two
    # apply_rope and the row-write kernel), replays timed in turns.
    old = tdg.DecodeGraphs(g16.params, g16.cache, g16.config,
                           g16.state.shape[1], g16.max_pages_per_seq,
                           g16.device)
    old.tables.copy_(g16.tables)

    def old_chunk():
        old.state.copy_(snap16)
        return old.multi_step(W16, n)

    with unfused_decode():
        old_chunk()  # captured with the unfused sequence
    before_ms = [host_ms(old_chunk, 5)]
    after_ms = [host_ms(lambda: chunk(True), 5)]
    before_ms.append(host_ms(old_chunk, 5))
    print(f"[graph] {n}-step chunk B=16 W={W16} replayed on {smi}, before "
          f"(2 x apply_rope + row_write per layer) / after (rope_row_write)"
          f", host ms in turns: after {chunk_replay:.1f}, before "
          f"{before_ms[0]:.1f}, after {after_ms[0]:.1f}, before "
          f"{before_ms[1]:.1f}; per step before {np.mean(before_ms) / n:.2f}"
          f", after {np.mean([chunk_replay] + after_ms) / n:.2f} ms")
    before = profiled(old_chunk, calls, f"replayed {n}-step chunk at 16 "
                      f"active requests, before (unfused rope + row_write)",
                      smi)
    print(f"[profile] launches per replayed {n}-step chunk by kind, before "
          f"-> after: " + ", ".join(
              f"{k} {before.get(k, 0) // calls} -> {after.get(k, 0) // calls}"
              for k in sorted(set(before) | set(after),
                              key=lambda k: -before.get(k, 0)))
          + f"; all {sum(before.values()) // calls} -> "
          f"{sum(after.values()) // calls}")
    L = g16.config.num_layers
    per = {k: (before.get(k, 0) - after.get(k, 0)) / calls / (L * n)
           for k in ("gather", "elementwise", "copy / cast")}
    fewer = (sum(before.values()) - sum(after.values())) / calls / (L * n)
    print(f"[profile] per layer and step, launches fell by {fewer:.2f} "
          f"(gathers {per['gather']:.2f}, elementwise "
          f"{per['elementwise']:.2f}, copy / cast {per['copy / cast']:.2f})")
    # The rotary embedding's ~25 launches per layer and step became one.
    check(fewer >= 15, "the rotary embedding's launches did not leave the "
          "replayed chunk")
    del old


def replay_equals_eager(dev, cfg, params, tag="[graph]"):
    """One 16-step chunk, replayed and eager, on the same state, tables
    and cache: tokens, state and every page but the scratch page equal
    to the bit."""
    cache = tdec.init_kv_pages(cfg, 160, 128, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    g = tdg.DecodeGraphs(params, cache, cfg, 16, 32, dev)
    ctx = np.random.default_rng(4).integers(60, 1000, size=16)
    graph_state(g, ctx, 30, 5)
    g.state[1, 3], g.state[2, 3] = -1, 0  # an idle slot
    snap = g.state.clone()
    pages = [t.clone() for t in cache.values()]
    W = 8
    replayed = g.multi_step(W, 16).clone()
    after = [g.state.clone()] + [t.clone() for t in cache.values()]
    g.state.copy_(snap)
    for t, p in zip(cache.values(), pages):
        t.copy_(p)
    eager = g._chunk(g.state, W, 16, True)
    torch.cuda.synchronize()

    def flat(t):  # every flat page but the scratch page
        return t.view(-1, t.shape[-2] * t.shape[-1])[:-1]

    same = (torch.equal(replayed, eager) and torch.equal(after[0], g.state)
            and all(torch.equal(flat(a), flat(b))
                    for a, b in zip(after[1:], cache.values())))
    live = int((replayed >= 0).sum())
    print(f"{tag} replay vs eager, 16-step chunk at 16 slots, "
          f"{str(cfg.dtype)[6:]} 2 layers full width: identical {same} "
          f"({live} tokens; tolerance: bit for bit)")
    check(same, "a replayed chunk differs from the eager one")


def phase_pipelined_fp32(dev):
    """fp32, full width, 2 layers: replay equals eager (also bf16), the
    pipelined engine equals the classic one, speculative decoding equals
    plain greedy, and a handoff continues exactly."""
    cfg = TransformerConfig.llama2_7b(num_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=3, device=dev, dtype=torch.float32)
    replay_equals_eager(dev, cfg, params)
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16)
    replay_equals_eager(dev, bf, init_params(bf, seed=3, device=dev,
                                             dtype=bf.dtype))
    engine_identities(dev, cfg, params, "[pipelined]")


def engine_identities(dev, cfg, params, tag, unpacked=False):
    """fp32, 2 layers: the pipelined engine (packed admission; with
    `unpacked` also without it) gives the classic engine's streams,
    speculative decoding plain greedy's, and a request exported from a
    pipelined engine continues exactly in another."""
    rng = np.random.default_rng(6)
    prompts = make_prompts(rng, [60, 333, 700, 1000, 129, 257], 0, [])
    prompts.append((prompts[0][:7] * 40)[:280])  # repetitive: drafts
    kw = dict(device=dev, page_size=128, num_pages=64, max_batch=4)
    want = LLMEngine(cfg, params, **kw).generate(prompts, 24)
    for packed in (True, False) if unpacked else (True,):
        pipe = LLMEngine(cfg, params, multi_step=16, packed_admit=packed,
                         **kw)
        same = pipe.generate(prompts, 24) == want
        print(f"{tag} fp32 2 layers, {len(prompts)} requests x 24 "
              f"tokens, 4 slots: pipelined (multi_step 16, packed admission "
              f"{packed}, {pipe.waves_dispatched} waves) tokens identical "
              f"to classic {same}")
        check(same and (pipe.waves_dispatched >= 1) == packed,
              "fp32 pipelined tokens differ from the classic engine's")
    spec = LLMEngine(cfg, params, speculative_k=4, **kw)
    same = spec.generate(prompts, 24) == want
    print(f"{tag} fp32 2 layers: speculative_k=4 tokens identical to "
          f"plain greedy {same} ({spec.spec_steps} verify steps, drafted "
          f"{spec.spec_drafted}, accepted {spec.spec_accepted})")
    check(same and spec.spec_accepted > 0,
          "fp32 speculative tokens differ from plain greedy")
    pre = LLMEngine(cfg, params, multi_step=16, **kw)
    rid = pre.add_request(prompts[3], 64)
    pre.step()
    pre.step()  # a wave and two chunks in flight
    bundle = pre.export_kv(rid)
    dec = LLMEngine(cfg, params, **kw)
    rid2 = dec.import_kv(bundle, 64)
    got = {}
    while dec.has_work():
        got.update(dec.step())
    ref = LLMEngine(cfg, params, **kw).generate([prompts[3]], 64)[0]
    same = got[rid2] == ref
    print(f"{tag} fp32 2 layers: export_kv after "
          f"{len(bundle['generated'])} tokens from a pipelined engine, "
          f"import_kv into another: continuation identical {same}")
    check(same, "the imported request's continuation differs")


# ---------------------------------------------------------------------------
# Mixture of experts at Mixtral-8x7B widths
# ---------------------------------------------------------------------------

def mixtral_config(**kw):
    """Mixtral-8x7B's widths, from mistralai/Mixtral-8x7B-v0.1's
    config.json: vocab 32000, hidden 4096, intermediate 14336, 32 heads
    over 8 KV heads (head_dim 128), 8 experts with 2 per token, rope_theta
    1e6, rms_eps 1e-5, 32768 positions; the reference's capacity factor
    1.25 and its head tied to the embedding.  Cut to 16 of its 32 layers:
    32 layers of bf16 weights (93.1 GB) exceed the card's 80 GB, 16 take
    46.7 GB and leave room for the KV pages, the packed waves' expert
    buffers and the graphs' pool."""
    return TransformerConfig(**{**dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=16, num_heads=32, num_kv_heads=8, max_seq_len=32768,
        rope_theta=1e6, rms_eps=1e-5, num_experts=8,
        num_experts_per_token=2, capacity_factor=1.25), **kw})


def phase_moe_kernels(dev, smi):
    """The serving kernels at Mixtral's attention shape (H = 32 over
    KVH = 8, D = 128, page 128), bf16 and fp32, against their plain
    versions: paged decode and the rotating row write at the pipelined
    run's B = 16 over 16-page tables (idle slots), the flash forward on
    the packed-wave views.  Returns the largest bf16 error per kernel."""
    gen = torch.Generator(device=dev).manual_seed(13)
    cfg = mixtral_config()
    print(f"[moe] the serving kernels at Mixtral's attention shape "
          f"{MIXTRAL_SHAPE}, against their plain versions, on {smi}:")
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = f"mixtral {str(dtype)[6:]}"
        err, kp, vp, tables, ctx = check_paged_decode(
            gen, tag, dtype, dev, MIXTRAL_SHAPE, 16, 16,
            [0, 1, 100, 127, 128, 129, 255, 256, 257, 500, 640, 777, 0, 1000,
             1100, 1128])
        check_rope_row_write(gen, tag, dtype, dev, MIXTRAL_SHAPE, kp, vp,
                             tables, ctx - 1, cfg)
        err_w = max(check_packed_wave(gen, tag, dtype, dev, MIXTRAL_SHAPE,
                                      nseg, seg_len)[0]
                    for nseg, seg_len in PACKED_WAVES)
        if dtype == torch.bfloat16:
            worst = {"paged_decode_attention": err, "rope_row_write": 0.0,
                     "flash_fwd_sm90": err_w}
    return worst


def phase_moe(dev, smi):
    """Mixtral-8x7B widths, 16 layers, random bf16 weights, through the
    pipelined engine at [pipelined]'s settings and its 24 requests; then
    a replayed 16-step chunk at 16 slots against the weights-only bound,
    and the card's busy share of it by kind."""
    cfg = mixtral_config()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    leaves = toptim.tree_leaves(params)
    n = sum(p.numel() for p in leaves)
    weight_bytes = sum(p.numel() * p.element_size() for p in leaves)
    print(f"[moe] Mixtral-8x7B widths, {cfg.num_layers} of 32 layers, "
          f"random bf16 weights: {n:,} params, {weight_bytes / 1e9:.2f} GB "
          f"(num_params, the reference's dense formula: "
          f"{num_params(cfg):,}), made in {time.perf_counter() - t0:.1f} s "
          f"on {smi}; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    with env_var("RAY_TPU_SERVE_STEP_SAMPLE_EVERY", "8"):
        launches, eng, _, _, _ = phase_pipelined(
            dev, params, cfg, smi, tag="[moe]",
            model=f"Mixtral-8x7B widths, {cfg.num_layers} layers, bf16")
    sample = eng.engine_sample
    check(sample is not None and sample.get("tokens_per_s", 0) > 0
          and 0 < sample["roofline_fraction"] <= 1.0 and sample["mfu"] > 0,
          f"[moe] engine_sample {sample}: want tokens, a roofline fraction "
          f"in (0, 1] and mfu > 0")
    print(f"[moe] engine_sample (sampler every 8 steps) on {smi}: "
          f"{json.dumps(sample)}")
    print(f"[moe] peak device memory of the run on {smi} "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    exact_route_timings(dev, params, cfg, smi)
    g, steps = eng.graphs, eng.multi_step
    ctx = np.random.default_rng(3).integers(100, 1001, size=16)
    snap = graph_state(g, ctx, 4 * steps, 2)
    W = eng._table_width(int(ctx.max()) + steps)

    def chunk():
        g.state.copy_(snap)
        return g.multi_step(W, steps)

    chunk_ms = host_ms(chunk, 5)
    bound_ms = weight_bytes / HBM_BYTES_S * 1e3
    per_step = chunk_ms / steps
    print(f"[moe] {steps}-step chunk B=16 W={W} replayed on {smi}: "
          f"{chunk_ms:.1f} ms (host, synchronized), {per_step:.2f} ms per "
          f"step, {16 * steps / chunk_ms * 1e3:.0f} tok/s at 16 slots; "
          f"weights-only bound per step {bound_ms:.2f} ms "
          f"({weight_bytes / 1e9:.2f} GB / 3.35 TB/s), "
          f"{bound_ms / per_step:.1%} of it")
    profiled(chunk, 3, f"[moe] replayed {steps}-step chunk at 16 active "
             f"requests", smi, show="MoE routing")
    del chunk, snap, eng, g, params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def exact_route_timings(dev, params, cfg, smi):
    """One layer's exact route at the decode batch (16 slots), bf16:
    moe_ffn_gather (every expert on every slot) against
    moe_ffn_gather_plain, the reference's form that gathers each slot's
    expert matrices ([16, 2, 4096, 14336] per matrix), on the same
    inputs: agreement to two bf16 ulps of the largest output (other
    matmul kernels round the expert products), and device times."""
    bp = tdec._layer_params(params, 0)
    w = [bp[k] for k in ("router", "we_gate", "we_up", "we_down")]
    gen = torch.Generator(device=dev).manual_seed(14)
    x = rand(gen, (16, cfg.hidden_size), torch.bfloat16, dev)
    kw = dict(num_experts_per_token=cfg.num_experts_per_token,
              dtype=torch.bfloat16)
    got = tmoe.moe_ffn_gather(x, *w, **kw)
    want = tmoe.moe_ffn_gather_plain(x, *w, **kw)
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 ** -6 * want.float().abs().max().item()
    ms, _ = time_ms(lambda: tmoe.moe_ffn_gather(x, *w, **kw), 20)
    plain_ms = time_eager_ms(lambda: tmoe.moe_ffn_gather_plain(x, *w, **kw),
                             3)
    gbytes = sum(t.numel() * t.element_size() for t in w)
    print(f"[moe] exact route, one layer, 16 slots, bf16, on {smi}: "
          f"moe_ffn_gather {ms:.3f} ms (device, replayed; all "
          f"{gbytes / 1e9:.2f} GB of the layer's experts read once: bound "
          f"{gbytes / HBM_BYTES_S * 1e3:.3f} ms), the gathering form "
          f"{plain_ms:.3f} ms (eager); max |difference| {err:.3e} "
          f"(tolerance {tol:.3e}: 2^-6 x max |out|)")
    check(err <= tol, "[moe] the exact route's two forms disagree")


def phase_moe_fp32(dev):
    """fp32, Mixtral-8x7B widths, 2 layers: greedy tokens of the kernel
    path equal the plain path's (classic engine, capacity factor 1.25);
    one replayed 16-step chunk equals its eager run bit for bit (also
    bf16); at capacity factor 8.0, where nothing is dropped, the
    pipelined engine with and without packed admission gives the
    classic engine's streams, speculative decoding plain greedy's, and
    a handoff continues exactly."""
    cfg = mixtral_config(num_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=3, device=dev, dtype=torch.float32)
    phase_depth_fp32(dev, cfg, params, "[moe]")
    replay_equals_eager(dev, cfg, params, tag="[moe]")
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16)
    replay_equals_eager(dev, bf, init_params(bf, seed=3, device=dev,
                                             dtype=bf.dtype), tag="[moe]")
    engine_identities(dev, dataclasses.replace(cfg, capacity_factor=8.0),
                      params, "[moe] capacity factor 8.0:", unpacked=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Training path
# ---------------------------------------------------------------------------

# (name, b, sq, sk, H, KVH, q_off, kv_off, causal), D = 128.  "train" is
# the training path's shape, batch included.
BWD_CASES = [
    ("train", 8, 2048, 2048, 14, 14, 0, 0, True),
    ("gqa", 2, 512, 512, 16, 4, 0, 0, True),
    ("end_aligned", 1, 256, 640, 14, 14, 384, 0, True),
    ("noncausal", 1, 200, 300, 14, 14, 0, 0, False),
    ("masked_rows", 1, 320, 256, 14, 14, 100, 200, True),
]


def check_bwd(kname, tag, got, want, dtype=torch.bfloat16):
    """Gradients of one backward kernel against the plain version's, to
    BWD_REL_TOL of the largest plain value; no NaN.  Returns the largest
    error per gradient (0 for an empty one: no keys, no dk/dv)."""
    errs = []
    for g, w in zip(got, want):
        if not g.numel():
            errs.append(0.0)
            continue
        check(not torch.isnan(g).any().item(), f"{kname} {tag}: NaN")
        err = (g.float() - w.float()).abs().max().item()
        ref = max(w.float().abs().max().item(), 1.0)
        check(err <= BWD_REL_TOL[dtype] * ref,
              f"{kname} {tag}: disagrees with the plain backward ({err} vs "
              f"max {ref})")
        errs.append(err)
    return errs


def phase_kernels_bwd(dev):
    """dq and dk/dv against flash_attention_chunk_bwd_plain on the same
    (out, lse) and cotangents (do and a nonzero dlse), and at the training
    shape the forward's (out, lse) against its plain version too; returns
    the largest bf16 error of each kernel at the training shape."""
    gen = torch.Generator(device=dev).manual_seed(6)
    worst = {k: 0.0 for k in ("flash_bwd_dq", "flash_bwd_dkv",
                              "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90",
                              "flash_fwd", "flash_fwd_sm90")}
    D = 128
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, sq, sk, H, KVH, q_off, kv_off, causal in BWD_CASES:
            q = rand(gen, (b, sq, H, D), dtype, dev)
            k = rand(gen, (b, sk, KVH, D), dtype, dev)
            v = rand(gen, (b, sk, KVH, D), dtype, dev)
            do = rand(gen, (b, sq, H, D), dtype, dev)
            dlse = torch.randn((b * H, sq), generator=gen, device=dev)
            out, lse = tat.flash_attention_chunk(q, k, v, q_off, kv_off,
                                                 causal)
            scale = 1.0 / math.sqrt(D)
            got = tat._flash_chunk_bwd_cuda(q, k, v, out, lse, do, dlse,
                                            q_off, kv_off, causal, scale)
            torch.cuda.synchronize()
            tag = f"{name} {str(dtype)[6:]} b={b} sq={sq} sk={sk} H={H} " \
                  f"KVH={KVH} q_off={q_off} kv_off={kv_off} causal={causal}"
            if name == "train":
                for sm90 in ([True, False] if dtype == torch.bfloat16
                             else [False]):
                    kname = "flash_fwd_sm90" if sm90 else "flash_fwd"
                    err_f = check_flash_fwd(kname, tag, q, k, v, q_off,
                                            kv_off, causal, sm90)
                    worst[kname] = max(worst[kname], err_f)
            want = tat.flash_attention_chunk_bwd_plain(
                q, k, v, out, lse, do, dlse, q_off, kv_off, causal, scale)
            errs = check_bwd("flash_bwd", tag, got, want, dtype)
            dead = (lse <= tat._NEG_INF / 2).reshape(b, H, sq).all(1)
            check(torch.all(got[0][dead] == 0), f"{tag}: masked rows' dq")
            if name == "masked_rows":
                check(bool(dead.any()), f"{tag}: no fully masked row")
            print(f"[kernel] flash_bwd {tag}: max_abs_err dq {errs[0]:.3e} "
                  f"dk {errs[1]:.3e} dv {errs[2]:.3e} (tolerance "
                  f"{BWD_REL_TOL[dtype]:g} x max |plain|, max |plain dq| "
                  f"{want[0].float().abs().max().item():.3e}); fully "
                  f"masked rows {int(dead.sum())}; no NaN")
            if dtype == torch.bfloat16:
                # The older dq and dk/dv kernels, forced, on the same inputs.
                corr = tat._bwd_corr(out, do, dlse, b, H, sq)
                old = (tat.flash_bwd_dq(q, k, v, do, lse, corr, q_off,
                                        kv_off, causal, scale, sm90=False),
                       *tat.flash_bwd_dkv(q, k, v, do, lse, corr, q_off,
                                          kv_off, causal, scale,
                                          sm90=False))
                old_errs = check_bwd("flash_bwd (older kernels)", tag, old,
                                     want)
                print(f"[kernel] flash_bwd_dq, flash_bwd_dkv (older kernels) "
                      f"{tag}: max_abs_err dq {old_errs[0]:.3e} dk "
                      f"{old_errs[1]:.3e} dv {old_errs[2]:.3e}")
                if name == "train":
                    worst["flash_bwd_dq"] = old_errs[0]
                    worst["flash_bwd_dkv"] = max(old_errs[1:])
                del old, corr
            if name == "train" and dtype == torch.bfloat16:
                worst["flash_bwd_dq_sm90"] = errs[0]
                worst["flash_bwd_dkv_sm90"] = max(errs[1:])
            del q, k, v, do, out, lse, got, want
    torch.cuda.empty_cache()
    return worst


# The Hopper kernels' edge cases, bf16, D = 128 and 64: (name, b, sq, sk,
# H, KVH, q_off, kv_off, causal).  "prefill" is the serving path's timed
# shape.
SM90_CASES = [
    ("prefill", 4, 1024, 1024, 32, 32, 0, 0, True),
    ("len1", 2, 1, 1, 32, 32, 0, 0, True),
    ("len63", 2, 63, 63, 32, 32, 0, 0, True),
    ("len65_end_aligned", 1, 65, 129, 32, 32, 64, 0, True),
    ("len129_noncausal", 1, 129, 65, 32, 32, 0, 0, False),
    ("len1000", 1, 1000, 1000, 32, 32, 0, 0, True),
    ("offsets", 1, 200, 300, 32, 32, 500, 370, True),
    ("gqa_32_8", 1, 256, 256, 32, 8, 0, 0, True),
    ("masked_rows", 1, 160, 96, 32, 8, 100, 200, True),
    ("future", 1, 64, 128, 32, 32, 0, 500, True),
    ("no_keys", 1, 33, 0, 32, 32, 0, 0, True),
    ("long_4096", 1, 4096, 4096, 4, 4, 0, 0, True),
]


def phase_kernels_sm90(dev):
    """The Hopper forward, dq and dk/dv kernels against the plain versions
    at the serving path's prefill shape and at edges TMA and the rings
    must get right: lengths off the tiles (zero fill), sq < sk with
    offsets, GQA 32 / 8, fully masked rows, a chunk from the future, no
    keys, rings that wrap many times; at head dims 128 and 64.  The older
    dq (flash_bwd.cu) runs beside the Hopper one on the same inputs.
    Returns the largest error of each Hopper kernel at the prefill
    shape."""
    gen = torch.Generator(device=dev).manual_seed(9)
    worst = {}
    bf = torch.bfloat16
    for D in (128, 64):
        scale = 1.0 / math.sqrt(D)
        for name, b, sq, sk, H, KVH, q_off, kv_off, causal in SM90_CASES:
            tag = (f"{name} D={D} b={b} sq={sq} sk={sk} H={H} KVH={KVH} "
                   f"q_off={q_off} kv_off={kv_off} causal={causal}")
            q = rand(gen, (b, sq, H, D), bf, dev)
            k = rand(gen, (b, sk, KVH, D), bf, dev)
            v = rand(gen, (b, sk, KVH, D), bf, dev)
            do = rand(gen, (b, sq, H, D), bf, dev)
            dlse = torch.randn((b * H, sq), generator=gen, device=dev)
            err_f = check_flash_fwd("flash_fwd_sm90", tag, q, k, v, q_off,
                                    kv_off, causal, True)
            out, lse = tat._flash_chunk_cuda(q, k, v, q_off, kv_off, causal,
                                             scale, sm90=True)
            corr = tat._bwd_corr(out, do, dlse, b, H, sq)
            dq = tat.flash_bwd_dq(q, k, v, do, lse, corr, q_off, kv_off,
                                  causal, scale, sm90=True)
            dq_old = tat.flash_bwd_dq(q, k, v, do, lse, corr, q_off, kv_off,
                                      causal, scale, sm90=False)
            dkv = tat.flash_bwd_dkv(q, k, v, do, lse, corr, q_off, kv_off,
                                    causal, scale, sm90=True)
            torch.cuda.synchronize()
            want = tat.flash_attention_chunk_bwd_plain(
                q, k, v, out, lse, do, dlse, q_off, kv_off, causal, scale)
            (err_dq,) = check_bwd("flash_bwd_dq_sm90", tag, [dq], want[:1])
            (err_old,) = check_bwd("flash_bwd_dq", tag, [dq_old], want[:1])
            errs = check_bwd("flash_bwd_dkv_sm90", tag, dkv, want[1:])
            dead = (lse <= tat._NEG_INF / 2).reshape(b, H, sq).permute(
                0, 2, 1)
            check(torch.all(dq[dead] == 0).item(),
                  f"{tag}: dq of rows that see no key is not 0")
            if name in ("masked_rows", "future", "no_keys"):
                check(bool(dead.any()), f"{tag}: no fully masked row")
            print(f"[kernel] flash_bwd_dq_sm90 / flash_bwd_dkv_sm90 {tag}: "
                  f"max_abs_err dq {err_dq:.3e} (older dq {err_old:.3e}) dk "
                  f"{errs[0]:.3e} dv {errs[1]:.3e} (tolerance "
                  f"{BWD_REL_TOL[bf]:g} x max |plain|, max |plain dq| "
                  f"{want[0].float().abs().max().item():.3e}); fully masked "
                  f"rows {int(dead.sum())}, their dq exactly 0; no NaN")
            if name == "prefill" and D == 128:
                worst = {"flash_fwd_sm90": err_f,
                         "flash_bwd_dq_sm90": err_dq,
                         "flash_bwd_dkv_sm90": max(errs)}
            del q, k, v, do, out, lse, corr, dq, dq_old, dkv, want
    torch.cuda.empty_cache()
    return worst


def check_train_launches(launches, L, steps, forwards, tag):
    """The flash kernels' launches over `steps` training steps: the
    Hopper forward `forwards` times per layer and step (2 when the
    backward runs it again), Hopper dq and dk/dv once, the older
    variants never."""
    per_step = {n: c / steps for n, c in launches.items()}
    print(f"{tag} flash launches per step {json.dumps(per_step)} (expected "
          f"flash_fwd_sm90 {forwards * L}, Hopper dq and dk/dv {L} each, "
          f"the older variants 0)")
    check(launches == {"flash_fwd_sm90": forwards * L * steps,
                       "flash_bwd_dq_sm90": L * steps,
                       "flash_bwd_dkv_sm90": L * steps,
                       "flash_fwd": 0, "flash_bwd_dq": 0,
                       "flash_bwd_dkv": 0},
          f"{tag} flash launches differ from the expected count")


def timed_steps(ts, run, batch, steps):
    """`steps` training steps on one batch from run["state"], which they
    replace, with the kernels' counts and the peak memory read around
    them: (losses, seconds, launches, peak bytes).  The state travels in
    `run` so that no caller's name keeps the start state alive through
    the steps, where it would count in the peak."""
    for spec in KERNELS.values():
        spec["kernel"].launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run["state"], m = ts.step(run["state"], batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: KERNELS[n]["kernel"].launches
                for n in TRAIN_KERNELS + REPLACED}
    return ([float(x) for x in losses], dt, launches,
            torch.cuda.max_memory_allocated())


def train_optimizer():
    return default_optimizer(warmup_steps=10, total_steps=1000,
                             mu_dtype=torch.bfloat16,
                             nu_dtype=torch.bfloat16)


def phase_train(dev, smi):
    """The 0.9B headline config trained at b = 8, s = 2048; returns the
    training kernels' launches over the timed steps."""
    name, cfg, B, S = tbench._config_ladder(ttf)[0]
    check(name == "0.9B" and (B, S) == (TRAIN["batch"], TRAIN["seq"]),
          "the bench's headline config changed")
    steps = TRAIN["steps"]
    ts = ShardedTrainStep(cfg, device=dev, optimizer=train_optimizer())
    t0 = time.perf_counter()
    run = {"state": ts.init(0)}
    torch.cuda.synchronize()
    print(f"[train] {name}: {num_params(cfg):,} params (vocab "
          f"{cfg.vocab_size}, hidden {cfg.hidden_size}, MLP "
          f"{cfg.intermediate_size}, {cfg.num_layers} layers, "
          f"{cfg.num_heads} heads, head_dim {cfg.head_dim_}), remat "
          f"{cfg.remat_policy}, fused_ce {cfg.fused_ce}, AdamW bf16 mu/nu; "
          f"init {time.perf_counter() - t0:.1f} s, device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1))).to(dev)
    batch = {"tokens": tokens}
    t0 = time.perf_counter()
    run["state"], m = ts.step(run["state"], batch)
    first = float(m["loss"])
    print(f"[train] warm-up step (learning rate 0): loss {first:.4f}, "
          f"{time.perf_counter() - t0:.2f} s")

    losses, dt, launches, peak = timed_steps(ts, run, batch, steps)
    state = run.pop("state")
    tok_s = B * S * steps / dt
    mfu = tok_s * ttf.flops_per_token(cfg, S) / tbench._peak_flops(dev)
    print(f"[train] losses of the {steps} timed steps: "
          f"{[round(x, 4) for x in losses]} (same batch each step)")
    check(all(math.isfinite(x) for x in losses), "a loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall over the steps")
    # Full remat: the forward and the backward's re-run each launch it.
    check_train_launches(launches, cfg.num_layers, steps, 2, "[train]")
    print(f"[train] on {smi}: {dt / steps * 1e3:.1f} ms per step, "
          f"{tok_s:.0f} tokens/s, train_mfu {mfu:.4f} (model FLOPs "
          f"{ttf.flops_per_token(cfg, S):.4e} per token over "
          f"{tbench._peak_flops(dev):.3g} FLOP/s), peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    with torch.no_grad():  # the optimizer's share of a step
        grads = toptim.tree_map(torch.zeros_like, state["params"])

        def update():
            upd, _ = ts.optimizer.update(grads, state["opt_state"],
                                         state["params"])
            toptim.apply_updates(state["params"], upd)

        opt_ms = time_eager_ms(update, 2)
        del grads
    print(f"[train] of which the optimizer (clip, AdamW, apply; eager "
          f"PyTorch over {num_params(cfg):,} fp32 params): {opt_ms:.1f} ms")
    profiled(lambda: ts.step(state, batch), 1, "training step (0.9B, b=8, "
             "s=2048)", smi)
    del state, ts
    torch.cuda.empty_cache()
    return launches, dict(tok_s=tok_s, mfu=mfu, peak=peak)


@contextlib.contextmanager
def plain_flash():
    """Route the flash op's CUDA forward and backward to their plain
    PyTorch versions, for the plain side of a comparison."""
    saved = (tat._flash_chunk_cuda, tat._flash_chunk_bwd_cuda)
    tat._flash_chunk_cuda = tat.flash_attention_chunk_plain
    tat._flash_chunk_bwd_cuda = tat.flash_attention_chunk_bwd_plain
    try:
        yield
    finally:
        tat._flash_chunk_cuda, tat._flash_chunk_bwd_cuda = saved


def phase_train_depth(dev):
    """Loss and every gradient of the 0.9B config cut to 2 layers (full
    width, full remat), b = 2, s = 2048: kernel path against plain path,
    in bf16 (fused CE, as trained) and fp32 (unfused CE, so that nothing
    rounds to bf16)."""
    _, base, _, S = tbench._config_ladder(ttf)[0]
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, base.vocab_size, (2, S + 1))).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(base, num_layers=2, dtype=dtype,
                                  fused_ce=dtype == torch.bfloat16)
        params = init_params(cfg, seed=0, device=dev)

        def loss_and_grads():
            live = toptim.tree_map(lambda p: p.detach().requires_grad_(),
                                   params)
            loss = ttf.loss_fn(live, {"tokens": tokens}, cfg)
            return loss.item(), torch.autograd.grad(
                loss, toptim.tree_leaves(live))

        lk, gk = loss_and_grads()
        with plain_flash():
            lp, gp = loss_and_grads()
        rel_loss = abs(lk - lp) / abs(lp)
        rel = [((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(gk, gp)]
        tol = TRAIN_DEPTH_TOL[dtype]
        print(f"[train-depth] {str(dtype)[6:]} 2 layers, fused_ce "
              f"{cfg.fused_ce}, b=2 s={S}: loss "
              f"{lk:.6f} vs plain {lp:.6f} (relative {rel_loss:.2e}); "
              f"worst gradient max |kernel - plain| / max |plain| "
              f"{max(rel):.3e} over {len(rel)} params (tolerance {tol:g})")
        check(rel_loss <= tol and max(rel) <= tol,
              "training kernel path drifts from the plain path")
        del params, gk, gp
    torch.cuda.empty_cache()


# Flash forwards per layer and step under each policy: "save_attn" and
# "dots_no_mlp" keep the kernel's out and lse, the others run it again.
REMAT_FORWARDS = {"full": 2, "dots": 2, "save_attn": 1, "dots_no_mlp": 1}


def phase_train_remat(dev, smi):
    """The 0.9B headline config at b = 8, s = 2048 under each remat
    policy, each from the same state (seed 0) and batch: the peak memory
    of the loss and gradients alone (what the policy keeps shows there;
    a step's peak is the eager optimizer's), a step at learning rate 0,
    whose loss and grad norm must be the same bits under every policy,
    then REMAT_STEPS timed steps (ms, tokens/s, train_mfu, peak memory,
    flash launches per step)."""
    name, base, B, S = tbench._config_ladder(ttf)[0]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab_size, (B, S + 1))).to(dev)
    batch = {"tokens": tokens}
    flops = ttf.flops_per_token(base, S)
    L = base.num_layers
    first = {}
    for policy, forwards in REMAT_FORWARDS.items():
        cfg = dataclasses.replace(base, remat_policy=policy)
        ts = ShardedTrainStep(cfg, device=dev, optimizer=train_optimizer())
        run = {"state": ts.init(0)}
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        live = toptim.tree_map(lambda p: p.detach().requires_grad_(),
                               run["state"]["params"])
        grads = torch.autograd.grad(ts.loss_fn(live, batch),
                                    toptim.tree_leaves(live))
        grad_peak = torch.cuda.max_memory_allocated()
        del live, grads
        run["state"], m = ts.step(run["state"], batch)
        first[policy] = (m["loss"], m["grad_norm"])
        losses, dt, launches, peak = timed_steps(ts, run, batch,
                                                 REMAT_STEPS)
        del run, ts
        gc.collect()
        torch.cuda.empty_cache()
        tok_s = B * S * REMAT_STEPS / dt
        check(all(math.isfinite(x) for x in losses) and losses[-1]
              < losses[0], f"[train-remat] {policy}: the loss did not fall")
        print(f"[train-remat] {name} b={B} s={S}, remat {policy!r} on "
              f"{smi}: {dt / REMAT_STEPS * 1e3:.1f} ms per step, "
              f"{tok_s:.0f} tokens/s, train_mfu "
              f"{tok_s * flops / tbench._peak_flops(dev):.4f}, peak memory "
              f"{peak / 2**30:.2f} GiB over a step, "
              f"{grad_peak / 2**30:.2f} GiB over the loss and gradients "
              f"alone ({held / 2**30:.2f} GiB of params and moments "
              f"held); losses {[round(x, 4) for x in losses]}")
        check_train_launches(launches, L, REMAT_STEPS, forwards,
                             f"[train-remat] {policy!r}")
    loss0, norm0 = first["full"]
    worst = max(max(abs(float(lo - loss0)), abs(float(no - norm0)))
                for lo, no in first.values())
    same = all(torch.equal(lo, loss0) and torch.equal(no, norm0)
               for lo, no in first.values())
    print(f"[train-remat] first step (learning rate 0) under the four "
          f"policies: loss {float(loss0):.6f}, grad norm {float(norm0):.6f}; "
          f"the same bits under all four {same} (largest difference "
          f"{worst:.3e})")
    check(same, "a remat policy changed the first step's loss or grad norm")


def moe_active_flops_per_token(cfg, seq):
    """6 x the parameters a token runs through (attention, its top-k
    experts, the router; embedding and head left out, as flops_per_token
    leaves them out) + flops_per_token's attention term.  Not the
    capacity route's padding: its empty slots compute on zero rows."""
    hd, h = cfg.head_dim_, cfg.hidden_size
    attn = (2 * h * cfg.num_heads * hd + 2 * h * cfg.num_kv_heads * hd)
    experts = cfg.num_experts_per_token * 3 * h * cfg.intermediate_size
    per_layer = attn + experts + h * cfg.num_experts
    return (6 * cfg.num_layers * per_layer
            + 12 * cfg.num_layers * h * seq)


def phase_moe_train(dev, smi):
    """MoE training at Mixtral-8x7B widths, cut to MOE_TRAIN["layers"]
    (PERF.md), full remat, fused CE, AdamW with bf16 mu and nu, fp32
    master weights, b = 2, s = 4096: a step at learning rate 0, then
    timed steps on one batch whose loss must fall."""
    B, S, steps = MOE_TRAIN["batch"], MOE_TRAIN["seq"], MOE_TRAIN["steps"]
    cfg = mixtral_config(num_layers=MOE_TRAIN["layers"], fused_ce=True,
                         remat=True, remat_policy="full")
    ts = ShardedTrainStep(cfg, device=dev, optimizer=train_optimizer())
    t0 = time.perf_counter()
    run = {"state": ts.init(0)}
    torch.cuda.synchronize()
    n = sum(p.numel() for p in toptim.tree_leaves(run["state"]["params"]))
    print(f"[moe-train] Mixtral-8x7B widths, {cfg.num_layers} of 32 layers "
          f"(PERF.md: the eager optimizer's whole-tree stages peak near 8 "
          f"fp32 copies of the params), {n:,} params, fp32 master weights, "
          f"AdamW bf16 mu/nu, remat {cfg.remat_policy}, fused_ce "
          f"{cfg.fused_ce}, b={B} s={S}: init "
          f"{time.perf_counter() - t0:.1f} s, device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1))).to(dev)
    batch = {"tokens": tokens}
    t0 = time.perf_counter()
    run["state"], m = ts.step(run["state"], batch)
    print(f"[moe-train] warm-up step (learning rate 0): loss "
          f"{float(m['loss']):.4f}, {time.perf_counter() - t0:.2f} s")
    losses, dt, launches, peak = timed_steps(ts, run, batch, steps)
    state = run.pop("state")
    print(f"[moe-train] losses of the {steps} timed steps: "
          f"{[round(x, 4) for x in losses]} (same batch each step)")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          "[moe-train] the loss did not fall over the steps")
    tok_s = B * S * steps / dt
    peak_flops = tbench._peak_flops(dev)
    ref = ttf.flops_per_token(cfg, S)
    active = moe_active_flops_per_token(cfg, S)
    print(f"[moe-train] on {smi}: {dt / steps * 1e3:.1f} ms per step, "
          f"{tok_s:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); train_mfu "
          f"{tok_s * ref / peak_flops:.4f} by the reference's "
          f"flops_per_token ({ref:.4e} per token: a dense FFN once, the "
          f"experts ignored), {tok_s * active / peak_flops:.4f} by active "
          f"parameters ({active:.4e} per token: attention, top-"
          f"{cfg.num_experts_per_token} experts, router)")
    check_train_launches(launches, cfg.num_layers, steps, 2, "[moe-train]")
    with torch.no_grad():  # the optimizer's share of a step
        grads = toptim.tree_map(torch.zeros_like, state["params"])

        def update():
            upd, _ = ts.optimizer.update(grads, state["opt_state"],
                                         state["params"])
            toptim.apply_updates(state["params"], upd)

        opt_ms = time_eager_ms(update, 2)
        del grads
    print(f"[moe-train] of which the optimizer (clip, AdamW, apply; eager "
          f"PyTorch over {n:,} fp32 params): {opt_ms:.1f} ms")
    profiled(lambda: ts.step(state, batch), 1, f"MoE training step "
             f"(Mixtral-8x7B widths, {cfg.num_layers} layer(s), b={B}, "
             f"s={S})", smi)
    del state, ts
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_train_fp32(dev):
    """fp32, Mixtral-8x7B widths, MOE_TRAIN_FP32["layers"] layers, a short
    sequence, unfused CE (nothing rounds to bf16): loss and every
    gradient of the kernel path against the plain path (full remat), and
    every gradient under each remat policy against no remat, bit for
    bit."""
    B, S = MOE_TRAIN_FP32["batch"], MOE_TRAIN_FP32["seq"]
    cfg = mixtral_config(num_layers=MOE_TRAIN_FP32["layers"],
                         dtype=torch.float32, remat=True,
                         remat_policy="full")
    params = init_params(cfg, seed=5, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, S + 1))).to(dev)

    def loss_and_grads(c):
        live = toptim.tree_map(lambda p: p.detach().requires_grad_(),
                               params)
        loss = ttf.loss_fn(live, {"tokens": tokens}, c)
        return loss.detach(), torch.autograd.grad(
            loss, toptim.tree_leaves(live))

    lk, gk = loss_and_grads(cfg)
    with plain_flash():
        lp, gp = loss_and_grads(cfg)
    rel_loss = abs(float(lk - lp)) / abs(float(lp))
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(gk, gp)]
    tol = TRAIN_DEPTH_TOL[torch.float32]
    print(f"[moe-train] fp32 {cfg.num_layers} layers, b={B} s={S}, unfused "
          f"CE: loss {float(lk):.6f} vs plain {float(lp):.6f} (relative "
          f"{rel_loss:.2e}); worst gradient max |kernel - plain| / max "
          f"|plain| {max(rel):.3e} over {len(rel)} params (tolerance "
          f"{tol:g})")
    check(rel_loss <= tol and max(rel) <= tol,
          "[moe-train] the kernel path drifts from the plain path")
    del gp
    l0, g0 = loss_and_grads(dataclasses.replace(cfg, remat=False))
    for policy in REMAT_FORWARDS:
        lr, gr = (lk, gk) if policy == "full" else loss_and_grads(
            dataclasses.replace(cfg, remat_policy=policy))
        worst = max((a - b).abs().max().item() for a, b in zip(gr, g0))
        same = torch.equal(lr, l0) and all(
            torch.equal(a, b) for a, b in zip(gr, g0))
        print(f"[moe-train] fp32 remat {policy!r} against no remat: loss "
              f"and every gradient the same bits {same} (largest "
              f"difference {worst:.3e})")
        check(same, f"[moe-train] remat {policy!r} changed a gradient")
        del gr
    del params, gk, g0
    gc.collect()
    torch.cuda.empty_cache()


def time_eager_ms(fn, n):
    """Device ms per call of fn, n calls issued eagerly between CUDA
    events (for calls that are not captured in a graph)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(n):
            fn()

    return _events_ms(run, n)


def phase_timings_train(dev, smi):
    """The training kernels at the training shape (b = 8, s = 2048,
    H = 14, D = 128, bf16, causal): device time, bound, the plain
    backward's time and one PyTorch backward of the same attention."""
    b, s, H, D, bf = 8, 2048, 14, 128, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v, do = (rand(gen, (b, s, H, D), bf, dev) for _ in range(4))
    out, lse = tat.flash_attention_chunk(q, k, v, 0, 0, True)
    corr = tat._bwd_corr(out, do, None, b, H, s)
    scale = 1.0 / math.sqrt(D)
    pairs = s * (s + 1) // 2         # visible (query, key) pairs per head
    elem = b * s * H * D * 2         # bytes of one [b, s, H, D] bf16 tensor
    rows = b * H * s * 4             # bytes of one lse-shaped fp32 vector
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    do_t = do.transpose(1, 2)

    def sdpa_backward():
        torch.autograd.grad(o_lib, (qt, kt, vt), do_t, retain_graph=True)

    def plain_bwd():
        tat.flash_attention_chunk_bwd_plain(q, k, v, out, lse, do, None, 0,
                                            0, True, scale)

    fwd = dict(plain=lambda: tat.flash_attention_chunk_plain(q, k, v, 0, 0),
               library=lambda: F.scaled_dot_product_attention(
                   qt.detach(), kt.detach(), vt.detach(), is_causal=True),
               flops=4 * b * H * D * pairs, bytes=4 * elem + rows,
               what="forward")
    bwd = dict(plain=plain_bwd, library=sdpa_backward,
               what="dq + dk/dv together")
    cases = {
        "flash_fwd_sm90 (training shape)": dict(
            fwd, kernel=lambda: tat._flash_chunk_cuda(
                q, k, v, 0, 0, True, scale, sm90=True),
            pr2="flash_fwd (training shape)"),
        "flash_fwd (training shape)": dict(
            fwd, kernel=lambda: tat._flash_chunk_cuda(
                q, k, v, 0, 0, True, scale, sm90=False),
            pr2="flash_fwd (training shape)"),
        "flash_bwd_dq_sm90": dict(
            bwd, kernel=lambda: tat.flash_bwd_dq(
                q, k, v, do, lse, corr, 0, 0, True, scale, sm90=True),
            flops=6 * b * H * D * pairs, bytes=5 * elem + 2 * rows,
            pr2="flash_bwd_dq"),
        "flash_bwd_dq": dict(
            bwd, kernel=lambda: tat.flash_bwd_dq(
                q, k, v, do, lse, corr, 0, 0, True, scale, sm90=False),
            flops=6 * b * H * D * pairs, bytes=5 * elem + 2 * rows,
            pr2="flash_bwd_dq"),
        "flash_bwd_dkv_sm90": dict(
            bwd, kernel=lambda: tat.flash_bwd_dkv(
                q, k, v, do, lse, corr, 0, 0, True, scale, sm90=True),
            flops=8 * b * H * D * pairs, bytes=6 * elem + 2 * rows,
            pr2="flash_bwd_dkv"),
        "flash_bwd_dkv": dict(
            bwd, kernel=lambda: tat.flash_bwd_dkv(
                q, k, v, do, lse, corr, 0, 0, True, scale, sm90=False),
            flops=8 * b * H * D * pairs, bytes=6 * elem + 2 * rows,
            pr2="flash_bwd_dkv"),
    }
    shape = f"b={b} s={s} H=KVH={H} D={D} bf16 causal"
    out_rows, yardsticks = {}, {}
    for name, c in cases.items():
        ms, eager = time_ms(c["kernel"], 10)
        if c["what"] not in yardsticks:  # one plain and one library time
            yardsticks[c["what"]] = (time_eager_ms(c["plain"], 2),
                                     time_eager_ms(c["library"], 10))
        plain_ms, lib_ms = yardsticks[c["what"]]
        t_bytes = c["bytes"] / HBM_BYTES_S * 1e3
        t_ops = c["flops"] / PEAK_FLOPS[bf] * 1e3
        r = out_rows[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        what = c["what"]
        print(f"[time] {name} [{shape}] on {smi}: device {ms:.4f} ms "
              f"(eager, host included: {eager:.4f}; "
              f"{c['flops'] / ms / 1e9:.1f} TFLOP/s; PR 2 kernel "
              f"{PR2_MS[c['pr2']]:.4f} ms, PERF.md), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{c['flops'] / 1e9:.1f} GFLOP, {c['bytes'] / 1e6:.1f} MB), "
              f"plain {plain_ms:.4f} ms ({what}), library {lib_ms:.4f} ms "
              f"(scaled_dot_product_attention {what})")
    for label, dq_name, dkv_name in (
            ("Hopper", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"),
            ("older", "flash_bwd_dq", "flash_bwd_dkv")):
        both = out_rows[dq_name]["ms"] + out_rows[dkv_name]["ms"]
        print(f"[time] backward dq + dk/dv, {label} kernels [{shape}] on "
              f"{smi}: {both:.4f} ms, SDPA backward "
              f"{yardsticks[bwd['what']][1]:.4f} ms")
    return out_rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi, name = phase_card()
    phase_build()
    worst = phase_kernels(dev)
    for kname, err in phase_kernels(dev, pr7_draws=True).items():
        worst[kname] = max(worst[kname], err)

    cfg = TransformerConfig.llama2_7b()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[main] Llama-2-7B random bf16 weights: {num_params(cfg):,} "
          f"params in {time.perf_counter() - t0:.1f} s, device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    _, eng, prompts, max_new, rates = phase_main_path(
        dev, params, cfg)
    print(f"[main] on {smi}: prefill {rates['prefill_tok_s']:.0f} tok/s, "
          f"decode {rates['decode_tok_s']:.0f} tok/s (host clock around "
          f"synchronized admit / decode calls; every decode step a graph "
          f"replay; {eng.graphs.captures} captures, "
          f"{eng.graphs.capture_seconds:.2f} s, left out)")
    phase_profile(eng, smi)
    timings = phase_timings(dev, eng, prompts, max_new, smi)
    launches_serve, pipe, pipe_prompts, pipe_new, streams = \
        phase_pipelined(dev, params, cfg, smi)
    phase_graph_timings(eng, pipe, smi)
    del eng, pipe
    gc.collect()  # the engines' timing hooks form reference cycles
    torch.cuda.empty_cache()
    phase_obs(dev, params, cfg, smi, launches_serve, streams)
    phase_pipelined_bf16_checks(dev, params, cfg, pipe_prompts, pipe_new,
                                streams)
    gc.collect()
    torch.cuda.empty_cache()
    phase_depth_bf16(dev, params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_depth_fp32(dev)
    phase_pipelined_fp32(dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[main] serving phases done; device memory still allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    for kname, err in phase_moe_kernels(dev, smi).items():
        worst[kname] = max(worst[kname], err)
    phase_moe(dev, smi)
    phase_moe_fp32(dev)
    print(f"[moe] done; device memory still allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    for kname, err in list(phase_kernels_bwd(dev).items()) + list(
            phase_kernels_sm90(dev).items()):
        worst[kname] = max(worst.get(kname, 0.0), err)
    launches_train, _ = phase_train(dev, smi)
    phase_train_remat(dev, smi)
    phase_train_depth(dev)
    phase_moe_train(dev, smi)
    phase_moe_train_fp32(dev)
    timings.update(phase_timings_train(dev, smi))

    kernels = []
    for kname, spec in KERNELS.items():
        r = timings[kname]
        # flash_fwd_sm90 runs on both paths: its count here is the
        # pipelined serving run's (replays counted); [main] and [train]
        # print theirs.  row_write: the pipelined run's, 0.
        launches = (launches_train[kname] if kname in launches_train
                    and kname not in SERVE_KERNELS else launches_serve[kname])
        kernels.append({
            "name": kname, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches,
            "max_abs_err": worst[kname], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
