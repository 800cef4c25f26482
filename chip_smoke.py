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
     in bf16 and fp32, at the training shapes (b = 8, H = KVH = 14,
     D = 128, s = 2048, causal, and one {tensor: 2} rank's 7 heads; the
     forward there too), a GQA shape,
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
     dq and dk/dv kernels are timed beside the Hopper ones;
 11. the port's own runtime (`[runtime]`), after the training phases
     free the card: nvidia-smi and `df /dev/shm`; init(num_cpus=4) with
     the GPU detected (count = torch's, `accelerator_type:` naming the
     card) by a probe that leaves CUDA uninitialized; a CPU task that
     sees no card and a num_gpus=1 task that sees the driver's; one
     Llama-2-7B layer's bf16 weights (404,750,336 bytes) put as CUDA
     tensors, read and returned by a num_gpus=1 task and held bit for
     bit, with the device-to-arena and arena-to-device GB/s; [main]'s 12
     requests through an LLMEngine built inside a num_gpus=1 actor
     (weights from seed 0 in the actor, every graph captured up front),
     its streams equal to [main]'s and its kernel launches too, with its
     start, weight-init and generation times and peak memory; a
     torch_trace of the idle actor, which must say it recorded no CUDA
     event, then one while it decodes, taken through the control plane's
     profile op, that names the paged decode kernel (the actor's
     engine and its profiler sessions share one thread); a plain
     num_gpus=1 actor that names no thread (GraphReplayer: each call
     replays a captured graph), traced twice while a driver thread keeps
     calling it, each trace within its bound and holding kernel events,
     then a trace during one long call answering "profile failed: the
     device thread did not come free within 4 s" in time, its start
     never run, the actor answering its next call;
     shutdown() leaving no worker and the card's used memory at the
     driver's own.  `--phase runtime` runs the card, the build, [main]
     and this phase alone;
 12. the serve plane on the port's runtime (`[serve]`, last): init and
     serve.start() (the HTTP proxy); [main]'s 12 requests at fp32 with 2
     layers at full width from a num_gpus=1 LLMServer replica, through
     12 concurrent handle calls and 4 HTTP streams via a chat ingress
     (one token per chunk), every stream equal to a classic engine in
     the driver, every page back; the same model as a prefill and a
     decode replica at num_gpus=0.5 each, DisaggLLMClient handing all 12
     requests' KV pages over the object plane (no fallback, streams
     equal; bundle bytes and pull seconds); Llama-2-7B bf16 at full
     depth with [pipelined]'s engine in a num_gpus=1 replica,
     [pipelined]'s 24 requests as HTTP streams (16, then 8 once each of
     those has a token): every budget met, nothing shed, every page
     back, 24 SLO samples at the controller (TTFT, TPOT p50 / p99),
     decode tok/s, the share of streams equal to [pipelined]'s
     (reported), the replica's kernel launches, and its first
     torch_trace, taken while it decodes [pipelined]'s first 16
     requests again and again after that run, naming the paged decode
     kernel; serve.shutdown() and shutdown() leaving no worker and the
     card's used memory at the driver's own.  `--phase serve` runs the
     card, the build and this phase alone;
 13. the Train library on the port's runtime (`[train-runtime]`, last):
     init(num_cpus=4) with the GPU detected and `df` of a temporary
     storage directory (at least 15 GB free, removed at the end);
     [train]'s model, batch and recipe through TorchTrainer.fit() in a
     num_gpus=1 worker (ScalingConfig(num_workers=1, use_gpu=True),
     FailureConfig(max_failures=1), CheckpointConfig(num_to_keep=1), the
     token batch through get_dataset_shard): the warm-up and 6 timed
     steps, each reported; the whole state after timed step 3 saved with
     save_pytree_async and reported as a Checkpoint; the worker killed
     (os._exit) at the top of the next step; a new worker restoring it
     onto the card with load_pytree and running the last 3 steps.  Gates:
     result step 7 resumed from state step 4, every reported loss equal
     to [train]'s bit for bit, the restored state equal to the saved one
     (digests of every tensor's bits), the second worker's flash launches
     those of 3 full-remat steps (96 / 48 / 48, no older variant),
     device_stats' last step plane "train" with its MFU = tokens/s x
     FLOPs per token / peak, result.json and progress.csv in the run
     directory; then a two-rank gloo DDP of the reference's toy model on
     the card from two num_gpus=0.5 workers, both ranks' weights bitwise
     equal and equal to rtol 1e-6 to one process stepping on the shards'
     mean gradient; shutdown() leaving no worker and the card's used
     memory at the driver's own.  It prints worker start and ready times,
     ms per step and tokens/s beside [train]'s, train_mfu, peak memory,
     the save's seconds to return, to durable and to persisted, and the
     load time.  `--phase train` runs the card, the build, [train] (the
     reference) and this phase alone;
 14-16. The mesh phases' runs share one cluster: every one-rank run
     one after another in one num_gpus=1 worker, every two-rank run in
     one pair of num_gpus=0.5 workers (each process starts, joins its
     process group and warms the card once), each worker gone and the
     card's used memory back to the driver's own after; the phases then
     check the runs' files.
 14. data and sequence parallelism on the port's runtime (`[seq]`):
     with at least 60 GiB of the card free (gated), two
     num_gpus=0.5 TorchTrainer ranks (gloo; CUDA tensors staged
     through pinned host buffers, the transport printed) run ring
     attention over b = 1, S = 8,192, H = KVH = 14, D = 128 in bf16:
     each rank's out, dq, dk and dv (of a seeded N(0, 1) cotangent)
     against one-process flash_attention over the whole sequence on the
     card, on the rank's own slice (1e-2 in norm, 5e-2 of the slice's
     largest value), each rank's flash launches (2 forwards; 2 dq and
     2 dk/dv: every ring step launched, the fully masked one too), the
     K/V bytes and seconds per ring step, ms per forward and backward;
     then bench.py's 0.9B-seq8k-b1 (full remat, fused CE, AdamW bf16
     mu/nu) from the same seed, batch and optimizer, a warm-up and 2
     steps on {seq: 1} in a num_gpus=1 worker and then on {seq: 2} in
     two num_gpus=0.5 ranks: every loss within 5e-4 relative of
     {seq: 1}'s, the step-1 gradient of each layer's wq, wk, wv and wo
     within 5e-2 in norm of {seq: 1}'s, params bit-equal across ranks (digest), each rank's
     flash launches per step 2 x n x 16 / n x 16 / n x 16; printed: ms
     per step, the gradient all-reduce's and the ring's bytes and
     seconds, each rank's peak memory.  `--phase seq` runs the card,
     the build and this phase alone;
 15. fully-sharded data parallelism on the port's runtime (`[fsdp]`,
     after [seq]): bench.py's 0.9B (b = 8, s = 2048, full remat, fused
     CE, AdamW bf16 mu/nu) from seed 0, the step-1 gradients, a warm-up
     and 3 steps on {fsdp: 1} in a num_gpus=1 worker and then on
     {fsdp: 2} in two num_gpus=0.5 ranks (gloo, the gathers and
     reduce-scatters staged through pinned host buffers): every loss
     within 2e-4 relative of {fsdp: 1}'s, the step-1 gradient of each
     layer's wq, wk, wv and wo within 1e-2 in norm, the grad norm within
     1e-3, each leaf's update over the run within 5e-2 in norm, the
     gathered params bit-equal across ranks (digest), each rank's bytes
     of params, mu and nu half of {fsdp: 1}'s for every leaf with an
     embed dim (the norms whole), flash launches per rank per step
     32 / 16 / 16; printed: ms per step, the gathers', reduce-scatters'
     and all-reduces' bytes and seconds, each rank's peak memory.  Then
     the sharded restore: the state gathered whole, saved by rank 0 with
     save_pytree, and each rank's blocks restored onto the card with
     load_pytree(shardings=ShardedTrainStep.state_shardings(...)): every
     leaf bit-equal to the rank's live block, the bytes of params, mu
     and nu restored equal to those the rank holds, its resident host
     memory's growth during the restore (VmRSS, sampled) below the size
     of tensors.pt; printed: the gather's, save's and restore's seconds.
     `--phase fsdp` runs the card, the build and this phase alone;
 16. tensor parallelism on the port's runtime (`[tensor]`, after
     [fsdp]): the same model, batch and recipe from seed 0 on
     {tensor: 2} in two num_gpus=0.5 ranks (gloo-host), each running all
     8 rows on 7 of the 14 heads, 3,584 MLP columns and 16,000
     vocabulary rows, against [fsdp]'s {fsdp: 1} run (the same one-rank
     step; `--phase tensor` runs {tensor: 1} itself): losses within
     5e-4 relative, the step-1 gradient of each layer's wq, wk, wv and
     wo within 5e-2 in norm, the grad norm within 5e-3, each leaf's
     update within 1e-1 in norm, the gathered params bit-equal across
     ranks (digest), each rank's bytes of params, mu and nu half of the
     one rank's for every leaf with a heads, mlp or vocab dim (the norms
     whole), flash launches per rank per step 32 / 16 / 16 (the Hopper
     kernels on 7-head blocks), the calls and bytes of the model's
     all-reduces over `tensor` per rank per step as counted from the
     shapes; printed: ms per step, the collectives' bytes and seconds
     by kind, each rank's peak memory; the sharded restore as in
     [fsdp], on the tensor blocks.  `--phase tensor` runs the card,
     the build and this phase alone.

The last lines: a JSON object of the kernels, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import psutil
import torch
import torch.nn.functional as F

import ray_tpu_torch as rtt
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


def main_requests():
    """[main]'s 12 requests: 10 prompts of 60-1000 tokens, then two that
    share a 256-token (two-page) prefix, the second served from the
    prefix cache; 32-64 new tokens each."""
    rng = np.random.default_rng(0)
    prompts = make_prompts(rng, [1000, 60, 777, 333, 900, 128, 640, 512,
                                 257, 64], 256, [100, 37])
    return prompts, rng.integers(32, 65, size=len(prompts)).tolist()


def phase_main_path(dev, params, cfg):
    """LLMEngine on Llama-2-7B, 12 requests; returns launches per kernel,
    the engine, the prompts and the rates."""
    eng = LLMEngine(cfg, params, device=dev, page_size=128, num_pages=96,
                    max_batch=8)
    prompts, max_new = main_requests()

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
    streams = [done[rid] for rid in ids]
    return launches, eng, prompts, max_new, rates, streams


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
# the training path's shape, batch included; "train_tp" one {tensor: 2}
# rank's ([tensor]: 7 of the 14 heads).
BWD_CASES = [
    ("train", 8, 2048, 2048, 14, 14, 0, 0, True),
    ("train_tp", 8, 2048, 2048, 7, 7, 0, 0, True),
    ("gqa", 2, 512, 512, 16, 4, 0, 0, True),
    ("end_aligned", 1, 256, 640, 14, 14, 384, 0, True),
    ("noncausal", 1, 200, 300, 14, 14, 0, 0, False),
    ("masked_rows", 1, 320, 256, 14, 14, 100, 200, True),
    # A ring's chunks ([seq]): a past chunk, every key visible, and a
    # future one, every row masked (out 0, lse -1e30, zero gradients).
    ("ring_past", 1, 1024, 1024, 14, 14, 1024, 0, True),
    ("ring_future", 1, 1024, 1024, 14, 14, 0, 1024, True),
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
    shapes the forward's (out, lse) against its plain version too;
    returns the largest bf16 error of each kernel at the training
    shapes."""
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
            train = name in ("train", "train_tp")
            if train:
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
            if name == "ring_past":
                check(not bool(dead.any()), f"{tag}: a row saw no key")
            if name == "ring_future":
                check(bool(dead.all()) and bool((out == 0).all())
                      and bool((lse <= tat._NEG_INF / 2).all())
                      and all(bool((g == 0).all()) for g in got),
                      f"{tag}: a fully masked chunk's out, lse or "
                      "gradients are not out 0, lse -1e30, gradients 0")
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
                if train:
                    worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"],
                                                old_errs[0])
                    worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"],
                                                 *old_errs[1:])
                del old, corr
            if train and dtype == torch.bfloat16:
                worst["flash_bwd_dq_sm90"] = max(worst["flash_bwd_dq_sm90"],
                                                 errs[0])
                worst["flash_bwd_dkv_sm90"] = max(
                    worst["flash_bwd_dkv_sm90"], *errs[1:])
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
    training kernels' launches over the timed steps, and the losses of
    the warm-up and timed steps (state steps 1-7), ms per step, tokens/s,
    train_mfu and peak memory, for [train-runtime]."""
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
    return launches, dict(tok_s=tok_s, mfu=mfu, peak=peak,
                          ms=dt / steps * 1e3, losses=[first] + losses)


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


# ---------------------------------------------------------------------------
# [runtime]: the main path inside a num_gpus=1 actor of the port's runtime

# One Llama-2-7B layer's weight matrices: 4 x 4096^2 + 3 x 4096 x 11008 =
# 202,375,168 bf16 params, 404,750,336 bytes.
LAYER_SHAPES = {"wq": (4096, 4096), "wk": (4096, 4096), "wv": (4096, 4096),
                "wo": (4096, 4096), "w_gate": (4096, 11008),
                "w_up": (4096, 11008), "w_down": (11008, 4096)}
LAYER_BYTES = 404_750_336
# [main]'s engine settings.
MAIN_ENGINE = dict(page_size=128, num_pages=96, max_batch=8)
# The card's used memory after shutdown may exceed the driver's own before
# init by no more than this (allocator and lazily loaded module slack).
USED_SLACK = 256 << 20


class EngineServer:
    """[main]'s engine inside an actor: Llama-2-7B at full width with
    random bf16 weights from seed 0, built on the actor's card."""

    def __init__(self, engine_kw):
        t0 = time.perf_counter()
        cfg = TransformerConfig.llama2_7b()
        params = init_params(cfg, seed=0, device="cuda",
                             dtype=torch.bfloat16)
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0
        self.eng = LLMEngine(cfg, params, device="cuda", **engine_kw)
        # Every decode graph now: a capture synchronizes the card.
        t0 = time.perf_counter()
        self.captured = self.eng.graphs.capture_all()
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.steps = 0
        # The engine runs on a thread of its own, and the runtime's
        # torch_trace starts and stops its sessions there too, between
        # two steps: a session taken from another thread while this one
        # replays graphs can hang (core/runtime.py set_profile_runner).
        self._calls = queue.Queue()
        threading.Thread(target=self._engine_loop, daemon=True,
                         name="engine").start()
        from ray_tpu_torch.core import runtime

        runtime.set_profile_runner(self._on_engine)

    def _on_engine(self, fn):
        """Run fn() on the engine thread and return its result here."""
        fut = concurrent.futures.Future()
        self._calls.put((fn, fut))
        return fut.result()

    def _run_calls(self, block):
        """On the engine thread: run the calls handed to it (waits for
        one when block)."""
        while True:
            try:
                fn, fut = self._calls.get(block=block)
            except queue.Empty:
                return
            block = False
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 (to the caller)
                fut.set_exception(e)

    def _engine_loop(self):
        while True:
            self._run_calls(block=True)

    def info(self):
        return dict(init_s=self.init_s, capture_s=self.capture_s,
                    captured=self.captured, pid=os.getpid(),
                    worker=rtt.get_runtime_context().worker_id,
                    gpu_ids=rtt.get_gpu_ids(),
                    card=torch.cuda.get_device_name(0))

    def progress(self):
        return self.steps

    def generate(self, prompts, max_new):
        return self._on_engine(lambda: self._generate(prompts, max_new))

    def _generate(self, prompts, max_new):
        kernels = {"paged_decode_attention": tpa.PAGED_DECODE,
                   "rope_row_write": tpa.ROPE_ROW_WRITE,
                   "row_write": tpa.ROW_WRITE,
                   "flash_fwd_sm90": tat.FLASH_FWD_SM90,
                   "flash_fwd": tat.FLASH_FWD}
        for k in kernels.values():
            k.launches = 0
        captures = self.eng.graphs.captures
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ids = [self.eng.add_request(p, n) for p, n in zip(prompts, max_new)]
        done = {}
        while self.eng.has_work():
            done.update(self.eng.step())
            self.steps += 1
            self._run_calls(block=False)
        torch.cuda.synchronize()
        return dict(streams=[done.get(rid) for rid in ids],
                    gen_s=time.perf_counter() - t0, steps=self.steps,
                    launches={n: k.launches for n, k in kernels.items()},
                    new_captures=self.eng.graphs.captures - captures,
                    peak=torch.cuda.max_memory_allocated())


class GraphReplayer:
    """A plain num_gpus=1 actor (max_concurrency 1, names no thread):
    each method call replays a captured CUDA graph of 8 bf16 2,048^2
    matmuls.  Its worker names the actor loop's thread as the profile
    runner, so torch_trace starts and stops between two calls."""

    def __init__(self):
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
        self.keep = (a, outs)

    def replay(self, n):
        for _ in range(n):
            self.graph.replay()
        torch.cuda.synchronize()
        return n

    def hold(self, seconds):
        """Replays for `seconds`: one long call on the actor's thread."""
        n, end = 0, time.perf_counter() + seconds
        while time.perf_counter() < end:
            n += self.replay(4)
        return n

    def set_bound(self, seconds):
        from ray_tpu_torch.core import runtime

        runtime.PROFILE_BOUND_S = seconds

    def state(self):
        from ray_tpu_torch.core import runtime

        return dict(worker=rtt.get_runtime_context().worker_id,
                    runner=type(runtime._profile_runner).__name__,
                    bound=runtime.PROFILE_BOUND_S,
                    profiling=torch.autograd._profiler_enabled())


# A GraphReplayer's bound for the long call's trace (its process only),
# and the call's length: the trace must answer before the call ends.
REPLAYER_BOUND_S = 4.0
REPLAYER_HOLD_S = 9.0


def trace_plain_gpu_actor(tag, drv, smi):
    """The profiler pin: a GraphReplayer traced twice through the control
    plane while a driver thread keeps calling it, each reply a trace that
    holds kernel events; then a trace taken during one long call answers
    "profile failed: ..." within its bound, the withdrawn start never
    runs, and the actor answers its next call."""
    actor = rtt.remote(num_gpus=1)(GraphReplayer).remote()
    st = rtt.get(actor.state.remote(), timeout=300)
    check(st["runner"] == "ThreadRunner" and not st["profiling"],
          f"{tag} the plain GPU actor's worker named no runner: {st}")
    bound = st["bound"]

    def trace(timeout_s):
        t0 = time.perf_counter()
        out = drv.core.client.call(
            {"op": "profile_worker", "worker_hex": st["worker"],
             "kind": "torch_trace", "duration_s": 0.5,
             "timeout_s": timeout_s}, timeout=timeout_s + 30)
        return out, time.perf_counter() - t0

    stop, calls = threading.Event(), []

    def load():
        while not stop.is_set():
            calls.append(rtt.get(actor.replay.remote(4), timeout=300))

    th = threading.Thread(target=load, daemon=True)
    th.start()
    try:
        for i in range(2):
            # The reply's own bound: the window, a start and a stop.
            out, took = trace(0.5 + 2 * bound + 15)
            ok = isinstance(out, str) and os.path.isfile(out)
            kernels = 0
            if ok:
                with open(out) as f:
                    kernels = sum(e.get("cat") == "kernel"
                                  for e in json.load(f)["traceEvents"])
            print(f"{tag} plain GPU actor, trace {i + 1} (0.5 s while a "
                  f"driver thread calls it): {took:.2f} s (bound "
                  f"{0.5 + 2 * bound:.1f} s + the export), {kernels} kernel "
                  f"events; {out if not ok else os.path.basename(out)}")
            check(ok and kernels > 0 and took < 0.5 + 2 * bound + 15,
                  f"{tag} trace {i + 1} of the plain GPU actor gave {out!r}")
    finally:
        stop.set()
        th.join(600)
    check(not th.is_alive() and calls, f"{tag} the actor's calls stalled")
    rtt.get(actor.set_bound.remote(REPLAYER_BOUND_S), timeout=60)
    held = actor.hold.remote(REPLAYER_HOLD_S)
    time.sleep(1.0)  # the long call has begun on the actor's thread
    out, took = trace(REPLAYER_BOUND_S + 15)
    print(f"{tag} a trace during one {REPLAYER_HOLD_S:.0f} s call: "
          f"{took:.2f} s (bound {REPLAYER_BOUND_S:.0f} s): {out!r}")
    check(out == ("profile failed: the device thread did not come free "
                  f"within {REPLAYER_BOUND_S:g} s")
          and took < REPLAYER_BOUND_S + 3,
          f"{tag} the trace during a long call was not refused in time")
    n = rtt.get(held, timeout=300)
    st = rtt.get(actor.state.remote(), timeout=60)
    check(not st["profiling"] and rtt.get(actor.replay.remote(1),
                                          timeout=60) == 1,
          f"{tag} the withdrawn start ran, or the actor stopped answering")
    print(f"{tag} then the long call ended ({n} replays), no profiler "
          f"session in the actor, its next call answered; on {smi}")
    rtt.kill(actor)


def process_alive(pid: int) -> bool:
    try:
        return psutil.Process(pid).status() != psutil.STATUS_ZOMBIE
    except psutil.NoSuchProcess:
        return False


def device_used_bytes() -> int:
    free, total = torch.cuda.mem_get_info()
    return total - free


def cpu_probe():
    return dict(cuda=torch.cuda.is_available(),
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                gpu_ids=rtt.get_gpu_ids(), pid=os.getpid())


def gpu_probe():
    from ray_tpu_torch.core.resources import detect_gpus

    # The probe first, in a process that has not touched CUDA yet.
    n = detect_gpus()
    initialized_by_probe = torch.cuda.is_initialized()
    return dict(detected=n, initialized_by_probe=initialized_by_probe,
                card=torch.cuda.get_device_name(0),
                gpu_ids=rtt.get_gpu_ids(),
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                pid=os.getpid())


def roundtrip(layer):
    """Read a dict of CUDA tensors on this worker's card and return it."""
    return dict(devices=sorted({str(t.device) for t in layer.values()}),
                layer=layer)


def phase_runtime(smi, prompts, max_new, streams_main, launches_main,
                  main_captures, cfg_layers):
    tag = "[runtime]"
    shm = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"{tag} {smi}; df -B1 /dev/shm: " + " | ".join(shm.splitlines()))
    used0 = device_used_bytes()
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    drv = rtt.init(num_cpus=4, log_to_driver=True)
    res = rtt.cluster_resources()
    print(f"{tag} init(num_cpus=4) in {time.perf_counter() - t0:.2f} s; "
          f"cluster_resources {json.dumps(res)}")
    check(res.get("GPU") == torch.cuda.device_count(),
          f"GPU resource {res.get('GPU')} != {torch.cuda.device_count()}")
    acc = [k.split(":", 1)[1] for k in res if k.startswith("accelerator_type:")]
    check(len(acc) == 1 and acc[0] in name.split(),
          f"accelerator_type resource {acc} does not name {name!r}")
    worker_pids = set()
    try:
        t0 = time.perf_counter()
        cpu = rtt.get(rtt.remote(num_cpus=1)(cpu_probe).remote(), timeout=300)
        print(f"{tag} CPU task ({time.perf_counter() - t0:.2f} s, spawn "
              f"included): cuda available {cpu['cuda']}, "
              f"CUDA_VISIBLE_DEVICES={cpu['visible']!r}, gpu ids "
              f"{cpu['gpu_ids']}")
        check(cpu["cuda"] is False and cpu["gpu_ids"] == [],
              "a CPU task sees a card")
        t0 = time.perf_counter()
        gpu = rtt.get(rtt.remote(num_gpus=1)(gpu_probe).remote(), timeout=300)
        print(f"{tag} num_gpus=1 task ({time.perf_counter() - t0:.2f} s, "
              f"spawn included): {json.dumps(gpu)}")
        check(gpu["card"] == name and gpu["gpu_ids"] == list(
            range(torch.cuda.device_count())), f"GPU task saw {gpu}")
        check(gpu["detected"] == torch.cuda.device_count()
              and not gpu["initialized_by_probe"],
              "the GPU probe miscounted or initialized CUDA")
        worker_pids |= {cpu["pid"], gpu["pid"]}

        # The object plane with a CUDA tensor dict at full width.
        gen = torch.Generator(device="cuda").manual_seed(0)
        layer = {k: torch.randn(s, generator=gen, device="cuda").to(
            torch.bfloat16) for k, s in LAYER_SHAPES.items()}
        nbytes = sum(t.numel() * t.element_size() for t in layer.values())
        check(nbytes == LAYER_BYTES, f"layer holds {nbytes} bytes")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = rtt.put(layer)
        put_s = time.perf_counter() - t0
        back_ref = rtt.remote(num_gpus=1)(roundtrip).remote(ref)
        rtt.wait([back_ref], timeout=300)
        t0 = time.perf_counter()
        back = rtt.get(back_ref, timeout=300)
        torch.cuda.synchronize()
        get_s = time.perf_counter() - t0
        same = all(back["layer"][k].is_cuda and torch.equal(
            back["layer"][k].view(torch.int16), layer[k].view(torch.int16))
            for k in layer)
        print(f"{tag} put of one Llama-2-7B layer as bf16 CUDA tensors, "
              f"{nbytes:,} bytes: device-to-arena {put_s * 1e3:.1f} ms, "
              f"{nbytes / put_s / 1e9:.2f} GB/s; a num_gpus=1 task read it "
              f"on {back['devices']} and returned it; get arena-to-device "
              f"{get_s * 1e3:.1f} ms, {nbytes / get_s / 1e9:.2f} GB/s "
              f"(host clock, single call; {smi}); bit for bit {same}")
        check(same and back["devices"] == ["cuda:0"],
              "the CUDA dict did not come back bit for bit on the card")
        del layer, back, ref, back_ref

        # The main path through the runtime.
        t0 = time.perf_counter()
        actor = rtt.remote(num_gpus=1, max_concurrency=2)(
            EngineServer).remote(MAIN_ENGINE)
        info = rtt.get(actor.info.remote(), timeout=600)
        start_s = time.perf_counter() - t0
        worker_pids.add(info["pid"])
        t0 = time.perf_counter()
        first = drv.core.client.call(
            {"op": "profile_worker", "worker_hex": info["worker"],
             "kind": "torch_trace", "duration_s": 0.2, "timeout_s": 300.0},
            timeout=330)
        print(f"{tag} the actor's first torch_trace (0.2 s, idle): "
              f"{time.perf_counter() - t0:.2f} s, returned {first!r}")
        check(isinstance(first, str)
              and first.startswith("profile failed: no CUDA event in "),
              "a trace of the idle actor was not flagged as holding no "
              "CUDA event")
        print(f"{tag} num_gpus=1 actor on {info['card']} (gpu ids "
              f"{info['gpu_ids']}): ready {start_s:.2f} s after creation "
              f"(worker start, weights, engine, graphs); weight init "
              f"{info['init_s']:.2f} s; {info['captured']} decode graphs "
              f"captured up front in {info['capture_s']:.2f} s")
        out = rtt.get(actor.generate.remote(prompts, max_new), timeout=600)
        equal = out["streams"] == streams_main
        print(f"{tag} actor generated [main]'s {len(prompts)} requests in "
              f"{out['gen_s']:.2f} s (its first run, untraced; "
              f"{out['steps']} steps, {out['new_captures']} captures during "
              f"the run), peak memory {out['peak'] / 2**30:.2f} GiB "
              f"(max_memory_allocated); streams equal to [main]'s: {equal}; "
              f"launches {json.dumps(out['launches'])}")
        if not equal:
            diff = [i for i, (a, b) in enumerate(
                zip(out["streams"], streams_main)) if a != b]
            print(f"{tag} streams that differ: {diff}")
        check(equal, "the actor's streams differ from [main]'s")
        # The same requests once more, traced through the control plane's
        # profile op once the engine is decoding.  The idle trace above
        # held no CUDA event because the card ran nothing in its window;
        # [serve] takes a replica's first trace while it decodes.
        steps0 = out["steps"]
        gen_ref = actor.generate.remote(prompts, max_new)
        deadline = time.time() + 600
        while rtt.get(actor.progress.remote(), timeout=60) < steps0 + 4:
            check(time.time() < deadline, "the actor never started decoding")
            time.sleep(0.05)
        # timeout_s: the head's wait (default: the window + 30 s) also
        # covers writing the trace, tens of MB for a decoding engine.
        t0 = time.perf_counter()
        trace = drv.core.client.call(
            {"op": "profile_worker", "worker_hex": info["worker"],
             "kind": "torch_trace", "duration_s": 0.5, "timeout_s": 300.0},
            timeout=330)
        trace_s = time.perf_counter() - t0
        traced = rtt.get(gen_ref, timeout=600)
        check(isinstance(trace, str) and os.path.isfile(trace),
              f"torch_trace gave {trace!r}")
        with open(trace) as f:
            text = f.read()
        hits = text.count("paged_decode_kernel")
        print(f"{tag} torch_trace of the actor through the control plane "
              f"(0.5 s while its second run decoded; the call {trace_s:.2f}"
              f" s, the run {traced['gen_s']:.2f} s traced): "
              f"{len(text):,} bytes, {hits} paged_decode_kernel events")
        # [main] captured its graphs lazily, and each capture's warm-up
        # ran one eager decode step (counted); the actor captured every
        # graph before its counts were zeroed.
        for k, n in out["launches"].items():
            warm = (main_captures * cfg_layers
                    if k in ("paged_decode_attention", "rope_row_write")
                    else 0)
            check(n == launches_main[k] - warm,
                  f"{k}: {n} launches in the actor, {launches_main[k]} in "
                  f"[main] with {warm} in its {main_captures} warm-ups")
        for k in SERVE_KERNELS:
            check(out["launches"][k] > 0, f"{k} never ran in the actor")
        check(hits > 0, "the trace does not name the paged decode kernel")
        # The card's one GPU goes to the next actor: dropping the handle
        # does not end this one.
        rtt.kill(actor)
        del actor
        deadline = time.time() + 60
        while rtt.available_resources().get("GPU", 0) < 1:
            check(time.time() < deadline, "the killed actor kept its GPU")
            time.sleep(0.1)
        trace_plain_gpu_actor(tag, drv, smi)
        for w in drv.control.workers.values():
            if w.pid and w.kind != "driver":
                worker_pids.add(w.pid)
    finally:
        t0 = time.perf_counter()
        rtt.shutdown()
        print(f"{tag} shutdown in {time.perf_counter() - t0:.2f} s")
    deadline = time.time() + 30
    left = worker_pids
    while True:
        left = {p for p in left if process_alive(p)}
        if not left or time.time() > deadline:
            break
        time.sleep(0.2)
    check(not left, f"workers left after shutdown: {sorted(left)}")
    gc.collect()
    torch.cuda.empty_cache()
    used1 = device_used_bytes()
    print(f"{tag} {len(worker_pids)} worker processes gone; card memory "
          f"used {used0 / 2**30:.2f} GiB before init, "
          f"{used1 / 2**30:.2f} GiB after shutdown")
    check(used1 <= used0 + USED_SLACK,
          "the card's used memory did not return to the driver's own")


# ---------------------------------------------------------------------------
# [serve]: the serve plane on the port's runtime, HTTP through the proxy

from ray_tpu_torch import serve as tserve  # noqa: E402
from ray_tpu_torch.serve.llm import (DisaggLLMClient,  # noqa: E402
                                     LLMServer)


class SmokeLLMServer(LLMServer.func_or_class):
    """[serve]'s replica: the library's LLMServer, plus reads of its
    process and engine for the checks (its kernel launch counts, its
    pages, its handoff pull spans)."""

    def __init__(self, *args, **kwargs):
        t0 = time.perf_counter()
        super().__init__(*args, **kwargs)
        torch.cuda.synchronize()
        self.ready_s = time.perf_counter() - t0

    def info(self):
        g = self.engine.graphs
        return dict(ready_s=self.ready_s, captures=g.captures,
                    capture_s=g.capture_seconds, pid=os.getpid(),
                    worker=rtt.get_runtime_context().worker_id,
                    gpu_ids=rtt.get_gpu_ids(),
                    card=torch.cuda.get_device_name(0),
                    teardown_cupti=os.environ.get("TEARDOWN_CUPTI"),
                    weights_gib=self.engine._weight_bytes / 2**30,
                    kv_gib=sum(v.numel() * v.element_size() for v in
                               self.engine.cache.values()) / 2**30)

    def launches(self, reset=False):
        kernels = {"paged_decode_attention": tpa.PAGED_DECODE,
                   "rope_row_write": tpa.ROPE_ROW_WRITE,
                   "row_write": tpa.ROW_WRITE,
                   "flash_fwd_sm90": tat.FLASH_FWD_SM90,
                   "flash_fwd": tat.FLASH_FWD}
        out = {n: k.launches for n, k in kernels.items()}
        if reset:
            for k in kernels.values():
                k.launches = 0
        return out

    def pages(self):
        eng = self.engine

        def read():
            idle = eng.prefix_cache.num_idle if eng.prefix_cache else 0
            return dict(free=eng.allocator.num_free, cached_idle=idle,
                        num_pages=eng.allocator.num_pages)

        return self._on_engine(read)

    def pull_spans(self):
        rows = ttracing.collect_spans_since(0)["rows"]
        return [s for s in map(ttracing.span_row_to_dict, rows)
                if s["name"] == "serve.handoff_pull"]


class SmokeChat:
    """[serve]'s HTTP ingress: forwards a request to the LLM replica's
    generate_stream and yields each token as its own item (one HTTP
    chunk), as tests/test_serve_async.py's chat ingress does."""

    def __init__(self, llm):
        self.llm = llm

    def __call__(self, request):
        body = request.json() or {}
        for tok in self.llm.options(
                stream=True, method_name="generate_stream").remote(
                    body["prompt"], int(body["max_new_tokens"])):
            yield {"token": tok}


# [serve]'s trace of the Llama-2-7B replica: its window, seconds.
TRACE_WINDOW_S = 1.0
SMOKE_LLM = tserve.deployment(name="llm_server", max_ongoing_requests=32)(
    SmokeLLMServer)
SMOKE_CHAT = tserve.deployment(name="chat", max_ongoing_requests=32)(
    SmokeChat)


def http_stream(addr, path, body, on_chunk=None, timeout=600):
    """POST `body` to the proxy as a streamed request (X-Serve-Stream: 1)
    and read the chunked reply off the socket: returns (arrival seconds
    on the host clock, payload bytes) for each chunk, so that a test can
    see what rode each chunk."""
    import socket
    from urllib.parse import urlparse

    u = urlparse(addr)
    payload = json.dumps(body).encode()
    sock = socket.create_connection((u.hostname, u.port), timeout=timeout)
    try:
        sock.sendall(
            f"POST {path} HTTP/1.1\r\nHost: {u.hostname}\r\n"
            f"Content-Type: application/json\r\nX-Serve-Stream: 1\r\n"
            f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n"
            .encode() + payload)
        f = sock.makefile("rb")
        status = f.readline()
        check(b" 200 " in status, f"{path}: HTTP status {status!r}")
        headers = b""
        while True:
            line = f.readline()
            if line in (b"\r\n", b""):
                break
            headers += line.lower()
        check(b"transfer-encoding: chunked" in headers,
              f"{path}: the reply is not chunked")
        chunks = []
        while True:
            size = int(f.readline().strip(), 16)
            if size == 0:
                break
            data = f.read(size)
            f.read(2)
            chunks.append((time.perf_counter(), data))
            if on_chunk is not None:
                on_chunk(len(chunks))
        return chunks
    finally:
        sock.close()


def chunk_tokens(chunks, path):
    """The tokens of a streamed reply, each from a chunk of its own."""
    toks = []
    for _, data in chunks:
        lines = data.decode().splitlines()
        check(len(lines) == 1, f"{path}: a chunk held {len(lines)} lines")
        doc = json.loads(lines[0])
        check(set(doc) == {"token"}, f"{path}: chunk {doc}")
        toks.append(doc["token"])
    return toks


def classic_streams(cfg, prompts, max_new, **engine_kw):
    eng = LLMEngine(cfg, None, seed=0, device="cuda", **engine_kw)
    ids = [eng.add_request(p, n) for p, n in zip(prompts, max_new)]
    done = {}
    while eng.has_work():
        done.update(eng.step())
    return [done[rid] for rid in ids]


def replica_pages_back(h, tag):
    st = h.stats.remote().result(timeout_s=120)
    pages = h.pages.remote().result(timeout_s=120)
    print(f"{tag} stats after the run: active {st['active']}, waiting "
          f"{st['waiting']}, shed {st['num_shed']}, completed "
          f"{st['num_completed']}; pages free {pages['free']} + cached "
          f"idle {pages['cached_idle']} of {pages['num_pages']} (one "
          f"scratch page)")
    check(st["active"] == 0 and st["waiting"] == 0,
          f"{tag} requests still active or waiting")
    check(pages["free"] + pages["cached_idle"] == pages["num_pages"] - 1,
          f"{tag} pages did not come back")
    return st


def serve_fp32(smi, addr, prompts, max_new, want):
    """[main]'s requests at fp32, 2 layers, from a num_gpus=1 replica:
    12 through handles and 4 as HTTP streams, equal to the driver's
    classic engine."""
    tag = "[serve] fp32"
    cfg = TransformerConfig.llama2_7b(num_layers=2, dtype=torch.float32)
    llm = SMOKE_LLM.options(ray_actor_options={"num_gpus": 1}).bind(
        config=cfg, seed=0, **MAIN_ENGINE)
    t0 = time.perf_counter()
    tserve.run(SMOKE_CHAT.bind(llm), name="fp32", route_prefix="/fp32",
               blocking_timeout_s=600)
    run_s = time.perf_counter() - t0
    h = tserve.get_deployment_handle("llm_server", app_name="fp32")
    info = h.info.remote().result(timeout_s=120)
    print(f"{tag} Llama-2-7B width, 2 layers, {json.dumps(MAIN_ENGINE)}, "
          f"seed 0, num_gpus=1 replica on {info['card']} (gpu ids "
          f"{info['gpu_ids']}): serve.run to RUNNING {run_s:.2f} s, of "
          f"which the replica's engine {info['ready_s']:.2f} s "
          f"({info['captures']} graphs captured up front in "
          f"{info['capture_s']:.2f} s); {smi}")
    t0 = time.perf_counter()
    resps = [h.generate.remote(p, n) for p, n in zip(prompts, max_new)]
    got = [r.result(timeout_s=600) for r in resps]
    handle_s = time.perf_counter() - t0
    same = got == want
    print(f"{tag} {len(prompts)} concurrent handle.generate calls in "
          f"{handle_s:.2f} s: streams equal to the driver's classic "
          f"engine {same}")
    if not same:
        print(f"{tag} differ: {[i for i, (a, b) in enumerate(zip(got, want)) if a != b]}")
    check(same, f"{tag} handle streams differ from the classic engine's")
    picks = [0, 3, 5, 11]
    out = {}

    def one(i):
        out[i] = http_stream(addr, "/fp32", {"prompt": prompts[i],
                                             "max_new_tokens": max_new[i]})

    threads = [threading.Thread(target=one, args=(i,)) for i in picks]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    http_s = time.perf_counter() - t0
    check(set(out) == set(picks), f"{tag} an HTTP stream did not end")
    streams = {i: chunk_tokens(out[i], "/fp32") for i in picks}
    same = all(streams[i] == want[i] for i in picks)
    print(f"{tag} {len(picks)} HTTP streams through the proxy and a chat "
          f"ingress in {http_s:.2f} s: {sum(len(c) for c in out.values())} "
          f"chunks, one token each; streams equal to the classic engine's "
          f"{same}")
    check(same, f"{tag} HTTP streams differ from the classic engine's")
    replica_pages_back(h, tag)
    tserve.delete("fp32")


def serve_disagg(smi, prompts, max_new, want):
    """Prefill and decode replicas of the fp32 model at num_gpus=0.5 each
    on the one card; DisaggLLMClient hands every request's KV pages over
    the object plane."""
    tag = "[serve] disagg"
    cfg = TransformerConfig.llama2_7b(num_layers=2, dtype=torch.float32)
    t0 = time.perf_counter()
    hs = {}
    for role in ("prefill", "decode"):
        hs[role] = tserve.run(
            SMOKE_LLM.options(role=role, ray_actor_options={
                "num_gpus": 0.5}).bind(config=cfg, seed=0, **MAIN_ENGINE),
            name=role, route_prefix=None, blocking_timeout_s=600)
    run_s = time.perf_counter() - t0
    infos = {r: h.info.remote().result(timeout_s=120) for r, h in hs.items()}
    free_gpu = rtt.available_resources().get("GPU", 0.0)
    print(f"{tag} prefill and decode replicas at num_gpus=0.5 RUNNING in "
          f"{run_s:.2f} s: " + "; ".join(
              f"{r} pid {i['pid']} on {i['card']} (gpu ids {i['gpu_ids']})"
              for r, i in infos.items()) + f"; GPU left {free_gpu}")
    check(all(i["card"] == torch.cuda.get_device_name(0)
              for i in infos.values()), f"{tag} a replica lacks the card")
    check(infos["prefill"]["pid"] != infos["decode"]["pid"]
          and free_gpu == 0.0, f"{tag} the two leases do not share the card")
    client = DisaggLLMClient(hs["prefill"], hs["decode"], page_size=128,
                             timeout_s=600)
    t0 = time.perf_counter()
    got = [client.generate(p, n, trace_ctx=(f"{i:032x}", "0" * 16))
           for i, (p, n) in enumerate(zip(prompts, max_new))]
    gen_s = time.perf_counter() - t0
    st = hs["decode"].stats.remote().result(timeout_s=120)
    spans = hs["decode"].pull_spans.remote().result(timeout_s=120)
    pulls = sorted(s["end"] - s["start"] for s in spans)
    nbytes = [int(s["attributes"]["bytes"]) for s in spans]
    same = got == want
    print(f"{tag} {len(prompts)} requests through DisaggLLMClient in "
          f"{gen_s:.2f} s: handoffs {client.handoffs}, client fallbacks "
          f"{client.fallbacks}, decode replica kv_imports "
          f"{st['kv_imports']}, handoff_fallbacks {st['handoff_fallbacks']}; "
          f"streams equal to the classic engine's {same}")
    print(f"{tag} KV bundles (fp32 pages over the object plane): "
          f"{len(nbytes)} pulls, {sum(nbytes):,} bytes in all, "
          f"{min(nbytes):,} to {max(nbytes):,} each; pull seconds (the "
          f"decode replica's serve.handoff_pull spans, host clock) median "
          f"{pulls[len(pulls) // 2]:.4f}, max {pulls[-1]:.4f}; {smi}")
    check(client.handoffs == len(prompts) and client.fallbacks == 0
          and st["handoff_fallbacks"] == 0
          and st["kv_imports"] == len(prompts),
          f"{tag} not every request was handed off")
    check(same, f"{tag} handed-off streams differ from the classic engine's")
    for role, h in hs.items():
        replica_pages_back(h, f"{tag} {role}")
    for role in hs:
        tserve.delete(role)


def serve_llama(smi, addr, drv, first, later, max_new, pipe_streams):
    """Llama-2-7B at full width and depth, bf16, seed 0, in a num_gpus=1
    replica with [pipelined]'s engine: [pipelined]'s 24 requests as HTTP
    streams (16 at once, 8 more once each of those has streamed a
    token), and the replica's first torch_trace while it decodes."""
    tag = "[serve] Llama-2-7B"
    cfg = TransformerConfig.llama2_7b()
    # The controller gives a starting replica max(health_check_timeout_s,
    # 30) s; this one's GPU worker start, 13 GB of weights and 12 graphs
    # captured up front took 17.0-25.8 s on an H100 (PERF.md).
    llm = SMOKE_LLM.options(ray_actor_options={"num_gpus": 1},
                            health_check_timeout_s=60).bind(
        config=cfg, seed=0, **PIPE)
    t0 = time.perf_counter()
    tserve.run(SMOKE_CHAT.bind(llm), name="llama", route_prefix="/llama",
               blocking_timeout_s=600)
    run_s = time.perf_counter() - t0
    h = tserve.get_deployment_handle("llm_server", app_name="llama")
    info = h.info.remote().result(timeout_s=120)
    print(f"{tag} bf16, full depth, {json.dumps(PIPE)}, seed 0, num_gpus=1 "
          f"replica on {info['card']}: serve.run to RUNNING {run_s:.2f} s, "
          f"of which the replica's engine {info['ready_s']:.2f} s (weights "
          f"{info['weights_gib']:.2f} GiB, KV pages {info['kv_gib']:.2f} "
          f"GiB; {info['captures']} graphs captured up front in "
          f"{info['capture_s']:.2f} s); TEARDOWN_CUPTI="
          f"{info['teardown_cupti']!r} in the replica; {smi}")
    h.launches.remote(reset=True).result(timeout_s=120)
    prompts = first + later
    got, errors = {}, []
    streamed = [threading.Event() for _ in prompts]

    def one(i):
        try:
            got[i] = http_stream(
                addr, "/llama", {"prompt": prompts[i],
                                 "max_new_tokens": max_new[i]},
                on_chunk=lambda k: streamed[i].set())
        except Exception as e:  # noqa: BLE001 (checked below)
            errors.append((i, repr(e)))
            streamed[i].set()

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads[:16]:
        t.start()
    deadline = time.time() + 600
    for ev in streamed[:16]:
        check(ev.wait(max(1.0, deadline - time.time())),
              f"{tag} a stream never started")
    first16_s = time.perf_counter() - t0
    for t in threads[16:]:
        t.start()
    for t in threads:
        t.join(max(1.0, deadline - time.time()))
    check(not errors, f"{tag} HTTP streams failed: {errors[:3]}")
    check(len(got) == len(prompts), f"{tag} a stream did not end")
    ends = [c[-1][0] for c in got.values() if c]
    wall = max(ends) - t0
    streams = [chunk_tokens(got[i], "/llama") for i in range(len(prompts))]
    tokens = sum(map(len, streams))
    launches = h.launches.remote().result(timeout_s=120)
    check(all(len(s) == n for s, n in zip(streams, max_new)),
          f"{tag} a request ended short of its budget (no EOS is set)")
    # The replica's SLO samples reach the controller on its load reports
    # (stats() drains them), so they are read before this phase calls
    # stats() itself.
    ctrl = tserve.api._get_controller()
    slo = {}
    while time.time() < deadline:
        slo = rtt.get(ctrl.serve_slo.remote(), timeout=60).get(
            "llama/llm_server", {})
        if slo.get("completed", 0) >= len(prompts):
            break
        time.sleep(0.5)
    check(slo.get("completed") == len(prompts),
          f"{tag} serve_slo holds {slo.get('completed')} samples")
    st = replica_pages_back(h, tag)
    check(st["num_shed"] == 0, f"{tag} {st['num_shed']} requests shed")
    ttft, tpot = slo["ttft"], slo["tpot"]
    share = (sum(a == b for a, b in zip(streams, pipe_streams))
             / len(prompts) if pipe_streams else None)
    print(f"{tag} {len(prompts)} HTTP streams (16, then 8 once each of the "
          f"16 had a token, {first16_s:.2f} s in): {tokens} tokens, one "
          f"per chunk, in {wall:.2f} s, {tokens / wall:.0f} decode tok/s "
          f"over the run (host clock, prefill included); serve_slo "
          f"{slo['completed']} samples: TTFT p50 {ttft['p50']:.3f} s, p99 "
          f"{ttft['p99']:.3f} s; TPOT p50 {tpot['p50'] * 1e3:.2f} ms, p99 "
          f"{tpot['p99'] * 1e3:.2f} ms; {smi}")
    print(f"{tag} streams equal to [pipelined]'s (bf16; arrival times "
          f"change batches; reported, not gated): "
          + (f"{share:.3f}" if share is not None else "not compared"))
    print(f"{tag} launches in the replica over the run, replays counted "
          f"{json.dumps(launches)}")
    for k in SERVE_KERNELS:
        check(launches[k] > 0, f"{tag} {k} never ran in the replica")
    first_trace(tag, drv, h, info, first, max_new[:16])
    tserve.delete("llama")


def first_trace(tag, drv, h, info, prompts, max_new):
    """The replica's first torch_trace (no profiler session ran in that
    process before), through the control plane's profile op, while the
    replica decodes: `prompts` are sent through the handle again and
    again until the trace has come back, since a process's first session
    spends seconds setting the profiler up before its window opens
    (PERF.md)."""
    stop = threading.Event()
    rounds, errors = [0], []

    def load():
        try:
            while not stop.is_set():
                resps = [h.generate.remote(p, n)
                         for p, n in zip(prompts, max_new)]
                for r in resps:
                    r.result(timeout_s=600)
                rounds[0] += 1
        except Exception as e:  # noqa: BLE001 (checked below)
            errors.append(repr(e))

    loader = threading.Thread(target=load)
    loader.start()
    try:
        t0 = time.perf_counter()
        out = drv.core.client.call(
            {"op": "profile_worker", "worker_hex": info["worker"],
             "kind": "torch_trace", "duration_s": TRACE_WINDOW_S,
             "timeout_s": 300.0}, timeout=330)
        call_s = time.perf_counter() - t0
    finally:
        stop.set()
        loader.join(900)
    check(not errors and not loader.is_alive(),
          f"{tag} the load under the trace failed: {errors[:2]}")
    print(f"{tag} the replica's first torch_trace ({TRACE_WINDOW_S} s "
          f"window; the call {call_s:.2f} s, profiler setup included) "
          f"while {rounds[0]} + 1 rounds of {len(prompts)} requests "
          f"decoded: {out!r}")
    check(isinstance(out, str) and os.path.isfile(out),
          f"{tag} the replica's first torch_trace gave {out!r}")
    with open(out) as f:
        text = f.read()
    hits = text.count("paged_decode_kernel")
    print(f"{tag} the first trace: {len(text):,} bytes, {hits} "
          f"paged_decode_kernel events")
    check(hits > 0, f"{tag} the first trace does not name the paged "
          "decode kernel")


def phase_serve(smi, main_prompts, main_new, first, later, pipe_new,
                pipe_streams):
    tag = "[serve]"
    t0 = time.perf_counter()
    cfg = TransformerConfig.llama2_7b(num_layers=2, dtype=torch.float32)
    want = classic_streams(cfg, main_prompts, main_new, **MAIN_ENGINE)
    print(f"{tag} the driver's classic engine (fp32, 2 layers, seed 0) on "
          f"[main]'s {len(main_prompts)} requests: "
          f"{time.perf_counter() - t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    used0 = device_used_bytes()
    t0 = time.perf_counter()
    drv = rtt.init(num_cpus=4, log_to_driver=True)
    tserve.start()
    addr = tserve.proxy_address()
    print(f"{tag} init(num_cpus=4) and serve.start() in "
          f"{time.perf_counter() - t0:.2f} s; HTTP proxy at {addr}")
    worker_pids = set()
    try:
        serve_fp32(smi, addr, main_prompts, main_new, want)
        serve_disagg(smi, main_prompts, main_new, want)
        serve_llama(smi, addr, drv, first, later, pipe_new, pipe_streams)
        for w in drv.control.workers.values():
            if w.pid and w.kind != "driver":
                worker_pids.add(w.pid)
    finally:
        t0 = time.perf_counter()
        tserve.shutdown()
        rtt.shutdown()
        print(f"{tag} serve.shutdown() and shutdown() in "
              f"{time.perf_counter() - t0:.2f} s")
    deadline = time.time() + 30
    left = worker_pids
    while True:
        left = {p for p in left if process_alive(p)}
        if not left or time.time() > deadline:
            break
        time.sleep(0.2)
    check(not left, f"{tag} workers left after shutdown: {sorted(left)}")
    gc.collect()
    torch.cuda.empty_cache()
    used1 = device_used_bytes()
    print(f"{tag} {len(worker_pids)} worker processes gone; card memory "
          f"used {used0 / 2**30:.2f} GiB before init, "
          f"{used1 / 2**30:.2f} GiB after shutdown")
    check(used1 <= used0 + USED_SLACK,
          f"{tag} the card's used memory did not return to the driver's own")


# ---------------------------------------------------------------------------
# [train-runtime]: the Train library on the port's runtime

from ray_tpu_torch import train as ttrain  # noqa: E402
from ray_tpu_torch.parallel import comm as tcomm  # noqa: E402
from ray_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from ray_tpu_torch.train.torch_backend import TorchConfig  # noqa: E402

# [train]'s run in a num_gpus=1 train worker: state step 1 is the warm-up,
# 2-7 the timed steps; the state after step `save_at` (timed step 3) is
# checkpointed, and the first worker dies at the top of step `kill_at`.
TRAIN_RUNTIME = dict(save_at=4, kill_at=5)
# Free space the phase's storage directory needs: the 0.9B state (3.52 GB
# of fp32 params, 2 x 1.76 GB of bf16 moments), its persisted copy beside
# the worker's local one, and room to spare.
TRAIN_RUNTIME_FREE = 15e9
# The two-rank DDP toy: steps and learning rate.
DDP_TOY = dict(steps=60, lr=0.1)


def state_digest(state):
    """A train state's digest: [comm.tree_digest of its tensors' bits,
    the number of tensors, its structure with every other leaf (the
    step, the optimizer's counts) as itself].  Equal digests: equal bits,
    short of a collision."""
    tensors = {}
    spec = tckpt._flatten(state, "", tensors)
    return [tcomm.tree_digest(list(tensors.values())), len(tensors), spec]


def train_runtime_loop(config):
    """[train]'s model, batch and recipe in a train worker: init(0) or
    the checkpoint's state, then steps up to 1 + TRAIN["steps"], each
    reported; the state after step save_at saved with save_pytree_async
    and reported as a Checkpoint; a first attempt dies at the top of step
    kill_at (os._exit, a hard kill)."""
    import psutil as _psutil

    from ray_tpu_torch.train.torch_backend import get_device

    t_loop = time.time()
    dev = get_device()
    # No TF32 in fp32 matmuls, as [card] sets it for [train] (the torch
    # default, checked; this function names no torch.backends module,
    # which pickling it by value cannot carry).
    check(torch.get_float32_matmul_precision() == "highest",
          "the train worker's fp32 matmuls may use TF32")
    _, cfg, B, S = tbench._config_ladder(ttf)[0]
    ts = ShardedTrainStep(cfg, device=dev, optimizer=train_optimizer())
    batch = {"tokens": torch.from_numpy(np.array(
        ttrain.get_dataset_shard("train"))).to(dev)}
    ckpt = ttrain.get_checkpoint()
    info = dict(pid=os.getpid(), created=_psutil.Process().create_time(),
                loop_start=t_loop, device=str(dev),
                attempt=1 if ckpt is None else 2)
    if ckpt is None:
        state = ts.init(0)
        resumed = None
    else:
        step = ckpt.get_metadata()["metrics"]["step"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = tckpt.load_pytree(os.path.join(
            ckpt.as_directory(), f"step_{step}"), map_location=dev)
        torch.cuda.synchronize()
        info["load_s"] = time.perf_counter() - t0
        info["digest"] = state_digest(state)
        resumed = state["step"]
    torch.cuda.synchronize()
    info["ready"] = time.time()
    # This process's kernels, through their module: KERNELS would travel
    # with this function as a copy.
    flash = {"flash_fwd_sm90": tat.FLASH_FWD_SM90,
             "flash_bwd_dq_sm90": tat.FLASH_BWD_DQ_SM90,
             "flash_bwd_dkv_sm90": tat.FLASH_BWD_DKV_SM90,
             "flash_fwd": tat.FLASH_FWD, "flash_bwd_dq": tat.FLASH_BWD_DQ,
             "flash_bwd_dkv": tat.FLASH_BWD_DKV}
    for k in flash.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    fpt = ttf.flops_per_token(cfg, S)
    device_step = None
    while state["step"] < 1 + TRAIN["steps"]:
        n = state["step"] + 1
        if ckpt is None and n == config["kill_at"]:
            # report() returned: the driver holds step save_at's row.
            os._exit(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        metrics = dict(
            step=n, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
            tokens_per_sec=B * S / dt, flops_per_token=fpt, ms=dt * 1e3,
            resumed_from=resumed, info=dict(info),
            launches={k: v.launches for k, v in flash.items()},
            peak=torch.cuda.max_memory_allocated(),
            device_step=device_step)
        if ckpt is None and n == config["save_at"]:
            digest = state_digest(state)
            local = tempfile.mkdtemp(prefix="local_", dir=config["local_root"])
            t0 = time.time()
            handle = tckpt.save_pytree_async(state, local, step=n)
            returned = time.time() - t0
            handle.wait()
            metrics["save"] = dict(t0=t0, return_s=returned,
                                   durable_s=handle.durable_at - t0,
                                   digest=digest)
            ttrain.report(metrics,
                          checkpoint=tckpt.Checkpoint.from_directory(local))
            shutil.rmtree(local)
        else:
            ttrain.report(metrics)
        device_step = dict(tds.last_step() or {},
                           peak_flops=tds.peak_specs()[1])


def ddp_toy_loop(config):
    """The reference's two-worker DDP toy with the model on the worker's
    device: rank r fits its own shard (seed 100 + r); both ranks' final
    weights are gathered and reported."""
    import torch.distributed as dist
    import torch.nn as nn

    from ray_tpu_torch.train.torch_backend import prepare_model

    ctx = ttrain.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    torch.manual_seed(0)
    model = prepare_model(nn.Linear(4, 1))
    dev = next(model.parameters()).device
    opt = torch.optim.SGD(model.parameters(), lr=config["lr"])
    X, y = ddp_toy_shard(rank, dev)
    for _ in range(config["steps"]):
        opt.zero_grad()
        ((model(X) - y) ** 2).mean().backward()
        opt.step()
    mod = model.module
    w = torch.cat([mod.weight.detach().reshape(-1),
                   mod.bias.detach()]).cpu().tolist()
    gathered = [None] * world
    dist.all_gather_object(gathered, w)
    ttrain.report({"weights": gathered, "device": str(dev),
                   "wrapped": type(model).__name__,
                   "backend": dist.get_backend()})


def ddp_toy_shard(rank, dev):
    g = torch.Generator().manual_seed(100 + rank)
    X = torch.randn(64, 4, generator=g)
    y = X @ torch.tensor([[1.0, -2.0, 3.0, 0.5]]).T
    return X.to(dev), y.to(dev)


def ddp_toy_reference(dev, world):
    """One process stepping on the mean of the shards' gradients, as DDP
    averages them."""
    import torch.nn as nn

    torch.manual_seed(0)
    model = nn.Linear(4, 1).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=DDP_TOY["lr"])
    shards = [ddp_toy_shard(r, dev) for r in range(world)]
    for _ in range(DDP_TOY["steps"]):
        grads = []
        for X, y in shards:
            model.zero_grad()
            ((model(X) - y) ** 2).mean().backward()
            grads.append([p.grad.clone() for p in model.parameters()])
        for p, *gs in zip(model.parameters(), *grads):
            p.grad = sum(gs) / world
        opt.step()
    return torch.cat([model.weight.detach().reshape(-1),
                      model.bias.detach()]).cpu().tolist()


def train_runtime_ddp(tag, store):
    t0 = time.perf_counter()
    res = ttrain.TorchTrainer(
        ddp_toy_loop, train_loop_config=DDP_TOY,
        backend_config=TorchConfig(backend="gloo"),
        scaling_config=ttrain.ScalingConfig(
            num_workers=2, use_gpu=True, gpus_per_worker=0.5),
        run_config=ttrain.RunConfig(storage_path=store, name="ddp")).fit()
    w0, w1 = res.metrics["weights"]
    want = ddp_toy_reference(torch.device("cuda"), 2)
    err = max(abs(a - b) / abs(b) for a, b in zip(w0, want))
    print(f"{tag} two-rank DDP on the one card ({res.metrics['backend']}, "
          f"{res.metrics['wrapped']} on {res.metrics['device']}, two "
          f"num_gpus=0.5 workers, {DDP_TOY['steps']} SGD steps): "
          f"{time.perf_counter() - t0:.2f} s; rank weights bitwise equal "
          f"{w0 == w1}; max relative difference to one process stepping on "
          f"the shards' mean gradient {err:.3e} (rtol 1e-6)")
    check(res.metrics["device"] == "cuda:0"
          and res.metrics["wrapped"] == "DistributedDataParallel",
          f"{tag} the DDP model is not on the card")
    check(w0 == w1, f"{tag} the DDP ranks' weights differ")
    check(err <= 1e-6, f"{tag} DDP differs from the mean-gradient step")
    print(f"{tag} TorchConfig(backend='nccl') waits for a machine with more "
          "than one card: NCCL refuses two ranks on one device (ROADMAP "
          "Queue A item 6)")


def phase_train_runtime(smi, ref):
    """[train]'s run through TorchTrainer.fit() in a num_gpus=1 worker,
    checkpointed, killed and resumed; `ref` is [train]'s result (its
    per-step losses, ms per step, tokens/s)."""
    tag = "[train-runtime]"
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    used0 = device_used_bytes()
    store = tempfile.mkdtemp(prefix="train_runtime_")
    worker_pids = set()
    try:
        df = subprocess.run(["df", "-B1", store], capture_output=True,
                            text=True, check=True, timeout=60).stdout
        free = shutil.disk_usage(store).free
        print(f"{tag} storage {store}; df -B1: "
              + " | ".join(df.strip().splitlines()))
        check(free >= TRAIN_RUNTIME_FREE,
              f"{tag} {free / 1e9:.1f} GB free under {store}, the phase "
              f"needs {TRAIN_RUNTIME_FREE / 1e9:.0f} GB (two copies of the "
              "0.9B state); it never runs a smaller state")
        t0 = time.perf_counter()
        drv = rtt.init(num_cpus=4, log_to_driver=True)
        res = rtt.cluster_resources()
        print(f"{tag} init(num_cpus=4) in {time.perf_counter() - t0:.2f} s; "
              f"cluster_resources {json.dumps(res)}")
        check(res.get("GPU") == torch.cuda.device_count(),
              f"{tag} GPU resource {res.get('GPU')}")
        try:
            _, cfg, B, S = tbench._config_ladder(ttf)[0]
            tokens = np.random.default_rng(0).integers(
                0, cfg.vocab_size, (B, S + 1))
            local_root = os.path.join(store, "local")
            os.makedirs(local_root)
            t_fit = time.time()
            result = ttrain.TorchTrainer(
                train_runtime_loop,
                train_loop_config=dict(TRAIN_RUNTIME, local_root=local_root),
                scaling_config=ttrain.ScalingConfig(num_workers=1,
                                                    use_gpu=True),
                run_config=ttrain.RunConfig(
                    storage_path=store, name="train_runtime",
                    failure_config=ttrain.FailureConfig(max_failures=1),
                    checkpoint_config=ttrain.CheckpointConfig(num_to_keep=1)),
                datasets={"train": tokens}).fit()
            fit_s = time.time() - t_fit
            check_train_runtime(tag, smi, ref, cfg, B * S, result, t_fit,
                                fit_s)
            train_runtime_ddp(tag, store)
            for w in drv.control.workers.values():
                if w.pid and w.kind != "driver":
                    worker_pids.add(w.pid)
        finally:
            t0 = time.perf_counter()
            rtt.shutdown()
            print(f"{tag} shutdown in {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    deadline = time.time() + 30
    left = worker_pids
    while True:
        left = {p for p in left if process_alive(p)}
        if not left or time.time() > deadline:
            break
        time.sleep(0.2)
    check(not left, f"{tag} workers left after shutdown: {sorted(left)}")
    gc.collect()
    torch.cuda.empty_cache()
    used1 = device_used_bytes()
    print(f"{tag} {len(worker_pids)} worker processes gone; card memory "
          f"used {used0 / 2**30:.2f} GiB before init, "
          f"{used1 / 2**30:.2f} GiB after shutdown; storage removed; the "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    check(used1 <= used0 + USED_SLACK,
          f"{tag} the card's used memory did not return to the driver's own")
    check(not os.path.exists(store), f"{tag} {store} was left behind")


def check_train_runtime(tag, smi, ref, cfg, tokens, result, t_fit, fit_s):
    hist = result.metrics_history
    steps = [h["step"] for h in hist]
    print(f"{tag} TorchTrainer.fit() in {fit_s:.1f} s; reported steps "
          f"{steps}; result step {result.metrics['step']}, resumed from "
          f"state step {result.metrics['resumed_from']}")
    check(steps == list(range(1, 2 + TRAIN["steps"])),
          f"{tag} reported steps {steps}")
    check(result.metrics["step"] == 1 + TRAIN["steps"]
          and result.metrics["resumed_from"] == TRAIN_RUNTIME["save_at"],
          f"{tag} the run did not end at step 7 resumed from step 4 (the "
          "state after timed step 3)")
    attempts = {}
    for h in hist:
        attempts.setdefault(h["info"]["attempt"], h["info"])
    check(sorted(attempts) == [1, 2] and attempts[1]["pid"]
          != attempts[2]["pid"], f"{tag} no second worker: {attempts}")
    for a, info in sorted(attempts.items()):
        print(f"{tag} worker {a} (pid {info['pid']}, {info['device']}): "
              f"process created {info['created'] - t_fit:.2f} s after fit(),"
              f" loop started {info['loop_start'] - t_fit:.2f} s, state "
              f"ready {info['ready'] - t_fit:.2f} s"
              + (f" (load_pytree to the card {info['load_s']:.2f} s)"
                 if "load_s" in info else ""))
    losses = [h["loss"] for h in hist]
    same = [x == y for x, y in zip(losses, ref["losses"])]
    print(f"{tag} losses {[round(x, 4) for x in losses]}; equal to "
          f"[train]'s bit for bit, step by step: {same}")
    check(all(same) and len(same) == len(ref["losses"]),
          f"{tag} a loss differs from [train]'s")
    save = hist[TRAIN_RUNTIME["save_at"] - 1]["save"]
    persisted = result.checkpoint.get_metadata()["time"] - save["t0"]
    check(save["digest"] == attempts[2]["digest"],
          f"{tag} the restored state differs from the saved one")
    print(f"{tag} checkpoint of state step {TRAIN_RUNTIME['save_at']} "
          f"(params, opt_state, step; "
          f"{save['digest'][1]} tensors): "
          f"save_pytree_async returned in {save['return_s']:.2f} s, durable "
          f"{save['durable_s']:.2f} s after the save, persisted to the run "
          f"directory {persisted:.2f} s after it; the restored state equals "
          f"the saved one bit for bit (digests of every tensor's bits)")
    last = hist[-1]
    resumed = [h for h in hist if h["info"]["attempt"] == 2]
    check_train_launches(last["launches"], cfg.num_layers, len(resumed), 2,
                         f"{tag} worker 2")
    # Each worker's first step pays its process's warm-up (cuBLAS
    # handles, allocator growth, the kernels' first load), as [train]'s
    # untimed warm-up step does; the others are steady.
    firsts = {min(h["step"] for h in hist if h["info"]["attempt"] == a)
              for a in attempts}
    steady = [h["ms"] for h in hist if h["step"] not in firsts]
    ms = sum(steady) / len(steady)
    tok_s = tokens / (ms / 1e3)
    print(f"{tag} ms per step {[round(h['ms'], 1) for h in hist]} "
          f"(steps {sorted(firsts)} each a worker's first)")
    dstep = last["device_step"]
    prev = hist[-2]
    want_mfu = prev["tokens_per_sec"] * prev["flops_per_token"] \
        / dstep["peak_flops"]
    print(f"{tag} on {smi}: {ms:.1f} ms per step, {tok_s:.0f} tokens/s "
          f"(mean of the {len(steady)} steady steps, each timed alone) "
          f"beside [train]'s "
          f"{ref['ms']:.1f} ms, {ref['tok_s']:.0f} tokens/s; train_mfu "
          f"{tok_s * last['flops_per_token'] / dstep['peak_flops']:.4f}; "
          f"worker 2's peak memory {last['peak'] / 2**30:.2f} GiB; "
          f"device_stats.last_step() plane {dstep['plane']!r}, mfu "
          f"{dstep['mfu']} (step {prev['step']}: {want_mfu:.5f})")
    check(dstep["plane"] == "train" and abs(dstep["mfu"] - want_mfu)
          <= 5e-6, f"{tag} device_stats' train step is {dstep}")
    files = sorted(os.listdir(result.path))
    print(f"{tag} run directory {files}")
    check({"result.json", "progress.csv"} <= set(files),
          f"{tag} result.json / progress.csv missing")


# ---------------------------------------------------------------------------
# [seq]: ring attention over a seq mesh of TorchTrainer ranks, and the 0.9B
# model trained at 8k context on one rank and on two

from ray_tpu_torch.ops import ring_attention as tring  # noqa: E402

# The ring op's shape: the 0.9B model's attention at 8k context, b = 1.
SEQ_RING = dict(b=1, s=8192, h=14, kvh=14, d=128, ranks=2)
# The ring op against one-process flash_attention over the whole
# sequence on the card (the same Hopper kernels), bf16, with a seeded
# N(0, 1) cotangent so every gradient is O(1) on both ranks.  Each rank's
# out, dq, dk and dv, on its own slice of the sequence: ||ring - ref|| /
# ||ref|| within SEQ_RING_L2, and the largest error within SEQ_RING_MAX
# of that slice's own largest |ref|.  The ring rounds each chunk's out to
# bf16 before its fp32 merge and the merged out again, and a rank's dq
# (dk, dv) sums two bf16 partials in bf16: a few 1e-3 expected in norm,
# a bf16 ulp or two (2^-8 to 2^-6) at the largest element.  A zero or
# missing chunk is an error of order 1.
SEQ_RING_L2 = 1e-2
SEQ_RING_MAX = 5e-2
# 0.9B at 8k: warm-up (learning rate 0) and timed steps on {seq: 1} and
# {seq: 2}; every step's loss on {seq: 2} within SEQ_LOSS_RTOL of
# {seq: 1}'s (bf16 activations: the ring's chunks round differently from
# one pass; 5.4e-5 read on the card).  The first losses sit near
# ln(vocab) and move little, so the step-1 gradient of every layer's
# attention weights (wq, wk, wv, wo, at the initial params, summed over
# the mesh) is held too: ||g2 - g1|| / ||g1|| within SEQ_GRAD_L2 for
# each layer and weight (bf16 rounding through 16 layers, ~5e-3
# expected; a dropped or misplaced chunk moves them by tens of percent).
SEQ_TRAIN = dict(steps=2, batch=1, seq=8192)
SEQ_LOSS_RTOL = 5e-4
SEQ_GRAD_L2 = 5e-2
SEQ_GRAD_LEAVES = ("wq", "wk", "wv", "wo")
# Free card memory the two-rank run needs before it starts: two ranks of
# [train]'s 27.31 GiB peak (PERF.md section 5), with their contexts.
SEQ_FREE = 60 * 2**30


def seq_flash_kernels():
    return {"flash_fwd_sm90": tat.FLASH_FWD_SM90,
            "flash_bwd_dq_sm90": tat.FLASH_BWD_DQ_SM90,
            "flash_bwd_dkv_sm90": tat.FLASH_BWD_DKV_SM90,
            "flash_fwd": tat.FLASH_FWD, "flash_bwd_dq": tat.FLASH_BWD_DQ,
            "flash_bwd_dkv": tat.FLASH_BWD_DKV}


def seq_ring_inputs(dev):
    """The ring op's global q, k, v and the cotangent of its out (bf16,
    on the card) from seed 16."""
    c = SEQ_RING
    gen = torch.Generator(device=dev).manual_seed(16)
    return [torch.randn((c["b"], c["s"], h, c["d"]), generator=gen,
                       device=dev).to(torch.bfloat16)
            for h in (c["h"], c["kvh"], c["kvh"], c["h"])]


def seq_ring_loop(config):
    """One rank of the ring op: its chunks of seq_ring_inputs, a warm-up
    forward and backward, then one timed forward and one timed backward
    (of the seeded cotangent) with the flash kernels' launches read
    around each;
    its out and gradients saved for the driver."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.train.torch_backend import get_device

    dev = get_device()
    mesh = build_mesh(axes={"seq": SEQ_RING["ranks"]})
    rank = dist.get_rank()
    s_loc = SEQ_RING["s"] // SEQ_RING["ranks"]
    off = mesh.axis_index("seq") * s_loc
    q, k, v, dout = (t[:, off:off + s_loc].clone()
                     for t in seq_ring_inputs(dev))
    for t in (q, k, v):
        t.requires_grad_()
    flash = seq_flash_kernels()
    out = {"rank": rank, "device": str(dev), "offset": off,
           "transport": tcomm.transport(mesh.get_group("seq"), dev)}
    for phase in ("warm-up", "timed"):
        for t in (q, k, v):
            t.grad = None
        for kern in flash.values():
            kern.launches = 0
        mesh.rotations.update(calls=0, bytes=0, seconds=0.0)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = tring.ring_attention_sharded(q, k, v, mesh, causal=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd = {n: kern.launches for n, kern in flash.items()}
        rot_fwd = dict(mesh.rotations)
        o.backward(dout)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[phase] = dict(
            fwd_ms=(t1 - t0) * 1e3, bwd_ms=(t2 - t1) * 1e3,
            fwd_launches=fwd,
            bwd_launches={n: kern.launches - fwd[n]
                          for n, kern in flash.items()},
            rotations_fwd=rot_fwd, rotations=dict(mesh.rotations))
    torch.save({"out": o.detach().cpu(), "dq": q.grad.cpu(),
                "dk": k.grad.cpu(), "dv": v.grad.cpu()},
               os.path.join(config["dir"], f"ring_{rank}.pt"))
    with open(os.path.join(config["dir"], f"ring_{rank}.json"), "w") as f:
        json.dump(out, f)


def seq_train_loop(config):
    """The 0.9B model at 8k context on the mesh config["axes"] (every
    rank passes the same batch): init(0), the warm-up step, then the
    timed steps with the flash kernels' launches, the ring's rotations
    and the gradient all-reduce read around them; the params' digest
    checked equal on every rank."""
    import torch.distributed as dist

    from ray_tpu_torch.train.torch_backend import get_device
    from ray_tpu_torch.train.train_loop_utils import get_mesh

    dev = get_device()
    mesh = get_mesh(config["axes"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    cfg = tbench._long_context_ladder(ttf)[1][1]
    ts = ShardedTrainStep(cfg, mesh, device=dev, optimizer=train_optimizer())
    state = ts.init(0)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SEQ_TRAIN["batch"], SEQ_TRAIN["seq"] + 1))
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    # The step-1 gradient of the attention weights, summed over the mesh.
    _, grads = ts.grads(state["params"], batch)
    grad_norm = float(toptim.global_norm(grads))
    if rank == 0:
        torch.save({k: grads["blocks"][k].float().cpu()
                    for k in SEQ_GRAD_LEAVES},
                   os.path.join(config["dir"], f"grads_{config['name']}.pt"))
    del grads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = ts.step(state, batch)
    losses = [float(m["loss"])]
    warm_ms = (time.perf_counter() - t0) * 1e3
    flash = seq_flash_kernels()
    for kern in flash.values():
        kern.launches = 0
    mesh.rotations.update(calls=0, bytes=0, seconds=0.0)
    torch.cuda.reset_peak_memory_stats()
    ms, comm_b, comm_s = [], [], []
    for _ in range(SEQ_TRAIN["steps"]):
        if dist.is_initialized():
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        comm_b.append(ts.last_comm["bytes"])
        comm_s.append(ts.last_comm["seconds"])
    out = dict(
        rank=rank, device=str(dev), mesh=dict(mesh.shape), losses=losses,
        grad_norm=grad_norm,
        warm_ms=warm_ms, ms=ms, allreduce_bytes=comm_b,
        allreduce_s=comm_s, rotations=dict(mesh.rotations),
        launches={n: kern.launches for n, kern in flash.items()},
        peak=torch.cuda.max_memory_allocated(),
        digest=str(ts.check_replicated(state["params"])),
        transport=(tcomm.transport(mesh.get_group("seq"), dev)
                   if mesh.get_group("seq") is not None else "none"),
        layers=cfg.num_layers)
    with open(os.path.join(config["dir"],
                           f"train_{config['name']}_{rank}.json"), "w") as f:
        json.dump(out, f)


def seq_fit(loop, name, workers, store, **config):
    return ttrain.TorchTrainer(
        loop, train_loop_config=dict(config, dir=store, name=name),
        backend_config=TorchConfig(backend="gloo"),
        scaling_config=ttrain.ScalingConfig(
            num_workers=workers, use_gpu=True,
            gpus_per_worker=1.0 / workers),
        run_config=ttrain.RunConfig(storage_path=store, name=name)).fit()


def chain_loop(config):
    """The runs config["runs"] ((loop, name, axes), in order) in this
    worker, each freeing what it made before the next; rank 0's host
    seconds per run saved for the driver."""
    import torch.distributed as dist

    secs = {}
    for loop, name, axes in config["runs"]:
        t0 = time.perf_counter()
        loop(dict(dir=config["dir"], name=name, axes=axes))
        gc.collect()
        torch.cuda.empty_cache()
        secs[name] = round(time.perf_counter() - t0, 1)
    if not dist.is_initialized() or dist.get_rank() == 0:
        with open(os.path.join(config["dir"], f"{config['name']}.json"),
                  "w") as f:
            json.dump(secs, f)


def fit_mesh_runs(tag, store, runs):
    """The mesh phases' runs ((loop, name, ranks, axes)) on one cluster
    (TorchTrainer, gloo): the one-rank runs one after another in one
    num_gpus=1 worker, then the two-rank runs in one pair of
    num_gpus=0.5 workers (chain_loop), so that each process starts,
    joins its process group and warms the card once; each run leaves its
    files in `store`.  Then every worker must be gone and the card's used
    memory back to the driver's own."""
    t_fits = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    used0 = device_used_bytes()
    worker_pids = set()
    drv = rtt.init(num_cpus=4, log_to_driver=True)
    try:
        for n in sorted({r[2] for r in runs}):
            chain = [(loop, name, axes) for loop, name, k, axes in runs
                     if k == n]
            wait_free(SEQ_FREE if n > 1 else SEQ_FREE // 2, tag)
            t0 = time.perf_counter()
            seq_fit(chain_loop, f"chain{n}", n, store, runs=chain)
            with open(os.path.join(store, f"chain{n}.json")) as f:
                secs = json.load(f)
            print(f"{tag} fit of {n} rank(s), one worker start for its "
                  f"runs: {time.perf_counter() - t0:.1f} s; rank 0's host "
                  f"seconds per run {json.dumps(secs)}")
        for w in drv.control.workers.values():
            if w.pid and w.kind != "driver":
                worker_pids.add(w.pid)
    finally:
        rtt.shutdown()
    deadline = time.time() + 30
    left = worker_pids
    while True:
        left = {p for p in left if process_alive(p)}
        if not left or time.time() > deadline:
            break
        time.sleep(0.2)
    check(not left, f"{tag} workers left after shutdown: {sorted(left)}")
    gc.collect()
    torch.cuda.empty_cache()
    used1 = device_used_bytes()
    print(f"{tag} {len(worker_pids)} worker processes gone; card memory "
          f"used {used0 / 2**30:.2f} GiB before, {used1 / 2**30:.2f} GiB "
          f"after; the fits {time.perf_counter() - t_fits:.1f} s")
    check(used1 <= used0 + USED_SLACK,
          f"{tag} the card's used memory did not return to the driver's own")


def wait_free(need, tag, timeout=60.0):
    """Free card memory (cudaMemGetInfo) once it reaches `need` bytes, or
    fail after `timeout` seconds (a worker's memory returns when its
    process ends)."""
    deadline = time.time() + timeout
    while True:
        free, total = torch.cuda.mem_get_info()
        if free >= need or time.time() > deadline:
            break
        time.sleep(0.5)
    print(f"{tag} free card memory {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB (needs {need / 2**30:.2f})")
    check(free >= need, f"{tag} too little free card memory")


def seq_expected(n, layers, steps, backward_forwards):
    """Flash launches per rank: n ring steps per layer and pass, each
    launched (the fully masked one too); `backward_forwards` forward
    passes per step (2 under full remat)."""
    return {"flash_fwd_sm90": backward_forwards * n * layers * steps,
            "flash_bwd_dq_sm90": n * layers * steps,
            "flash_bwd_dkv_sm90": n * layers * steps,
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def check_seq_ring(tag, store, smi):
    c = SEQ_RING
    n = c["ranks"]
    dev = torch.device("cuda")
    q, k, v, dout = seq_ring_inputs(dev)
    for t in (q, k, v):
        t.requires_grad_()
    ref = tat.flash_attention(q, k, v, causal=True)
    ref.backward(dout)
    want = {"out": ref.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    s_loc = c["s"] // n
    # What the gate sees of a ring that drops the last rank's past
    # chunks: its chunk's attention over itself alone.
    last = slice((n - 1) * s_loc, None)
    ql, kl, vl = (t.detach()[:, last].clone().requires_grad_()
                  for t in (q, k, v))
    alone = tat.flash_attention(ql, kl, vl, causal=True)
    alone.backward(dout[:, last])
    dropped = {nm: ((g.float() - want[nm][:, last].float()).norm()
                    / want[nm][:, last].float().norm()).item()
               for nm, g in (("out", alone.detach()), ("dq", ql.grad))}
    print(f"{tag} a ring without rank {n - 1}'s past chunks: its out and dq "
          f"off by {dropped['out']:.3f} and {dropped['dq']:.3f} in norm "
          f"(the gate: {SEQ_RING_L2})")
    check(min(dropped.values()) > 10 * SEQ_RING_L2,
          f"{tag} the ring op's gate would not see a dropped chunk")
    del ql, kl, vl, alone
    errs = {}
    for r in range(n):
        with open(os.path.join(store, f"ring_{r}.json")) as f:
            info = json.load(f)
        got = torch.load(os.path.join(store, f"ring_{r}.pt"),
                         weights_only=True)
        off = info["offset"]
        for name, w in want.items():
            g = got[name].to(dev).float()
            wl = w[:, off:off + s_loc].float()
            check(not torch.isnan(g).any().item(), f"{tag} rank {r} {name}: "
                  "NaN")
            l2 = ((g - wl).norm() / wl.norm()).item()
            worst = ((g - wl).abs().max() / wl.abs().max()).item()
            errs[(r, name)] = (l2, worst)
            check(l2 <= SEQ_RING_L2 and worst <= SEQ_RING_MAX,
                  f"{tag} rank {r} {name} differs from one-process "
                  f"flash_attention: {l2:.3e} in norm, {worst:.3e} of the "
                  f"largest value")
        t = info["timed"]
        rot = t["rotations"]
        fwd_rot = t["rotations_fwd"]
        print(f"{tag} ring op rank {r} ({info['device']}, transport "
              f"{info['transport']}, tokens {off}-{off + s_loc - 1}): "
              f"forward {t['fwd_ms']:.2f} ms, backward {t['bwd_ms']:.2f} ms "
              f"(warm-up {info['warm-up']['fwd_ms']:.1f} / "
              f"{info['warm-up']['bwd_ms']:.1f} ms); K/V per ring step "
              f"{fwd_rot['bytes'] / max(fwd_rot['calls'], 1):,.0f} B in "
              f"{fwd_rot['seconds'] / max(fwd_rot['calls'], 1) * 1e3:.2f} "
              f"ms (forward), {rot['calls']} rotations in all "
              f"({rot['bytes']:,} B, {rot['seconds'] * 1e3:.2f} ms); "
              f"launches forward {json.dumps(t['fwd_launches'])} backward "
              f"{json.dumps(t['bwd_launches'])}")
        want_fwd = seq_expected(n, 1, 1, 1)
        check(t["fwd_launches"] == {**want_fwd, "flash_bwd_dq_sm90": 0,
                                    "flash_bwd_dkv_sm90": 0},
              f"{tag} rank {r}: forward launches {t['fwd_launches']}")
        check(t["bwd_launches"] == {**want_fwd, "flash_fwd_sm90": 0},
              f"{tag} rank {r}: backward launches {t['bwd_launches']}")
        check(rot["calls"] == 2 * (n - 1) and info["transport"]
              == "gloo-host", f"{tag} rank {r}: rotations {rot}")
    print(f"{tag} ring op ({n} ranks, b={c['b']}, S={c['s']}, H={c['h']}, "
          f"KVH={c['kvh']}, D={c['d']}, bf16, causal) against one-process "
          f"flash_attention over the whole sequence on {smi}, each rank's "
          f"slice, ||ring - ref|| / ||ref|| and largest error / that "
          f"slice's largest |ref|: "
          + ", ".join(f"rank {r} {nm} {a:.2e} / {b:.2e}"
                      for (r, nm), (a, b) in errs.items())
          + f" (tolerances {SEQ_RING_L2} / {SEQ_RING_MAX}); every ring "
          "step launched, "
          "the fully masked one (rank 0's second) too, as the reference "
          "launches it")
    del q, k, v, dout, ref, want
    gc.collect()
    torch.cuda.empty_cache()


def report_seq_train(tag, store, name, n, smi):
    ranks = []
    for r in range(n):
        with open(os.path.join(store, f"train_{name}_{r}.json")) as f:
            ranks.append(json.load(f))
    L = ranks[0]["layers"]
    for res in ranks:
        steps = SEQ_TRAIN["steps"]
        rot = res["rotations"]
        per = (rot["bytes"] / steps, rot["seconds"] / steps * 1e3)
        print(f"{tag} {name} rank {res['rank']} ({res['device']}, mesh "
              f"{ {a: s for a, s in res['mesh'].items() if s > 1} }, "
              f"transport {res['transport']}): losses "
              f"{[round(x, 5) for x in res['losses']]}; ms per step "
              f"{[round(x, 1) for x in res['ms']]} (warm-up "
              f"{res['warm_ms']:.0f}); gradient all-reduce "
              f"{res['allreduce_bytes'][-1]:,} B in "
              f"{[round(x * 1e3, 1) for x in res['allreduce_s']]} ms; "
              f"ring per step {per[0]:,.0f} B in {per[1]:.1f} ms "
              f"({rot['calls'] // steps} rotations); peak memory "
              f"{res['peak'] / 2**30:.2f} GiB; on {smi}")
        per_step = {k: v / steps for k, v in res["launches"].items()}
        print(f"{tag} {name} rank {res['rank']} flash launches per step "
              f"{json.dumps(per_step)}")
        check(res["launches"] == seq_expected(n, L, steps, 2),
              f"{tag} {name} rank {res['rank']}: flash launches differ from "
              f"{seq_expected(n, L, steps, 2)}")
        check(all(math.isfinite(x) for x in res["losses"]),
              f"{tag} {name}: a loss is not finite")
    check(len({r["digest"] for r in ranks}) == 1
          and all(r["losses"] == ranks[0]["losses"] for r in ranks),
          f"{tag} {name}: the ranks' params or losses differ")
    return ranks


def check_seq_grads(tag, store, runs):
    """The step-1 attention-weight gradients on {seq: 2} against
    {seq: 1}'s, layer by layer (SEQ_GRAD_L2), and the grad norms."""
    g1, g2 = (torch.load(os.path.join(store, f"grads_{n}.pt"),
                         weights_only=True) for n in ("seq1", "seq2"))
    rel = {}
    for k in SEQ_GRAD_LEAVES:
        for layer, (a, b) in enumerate(zip(g1[k], g2[k])):
            rel[(k, layer)] = ((b - a).norm() / a.norm()).item()
    worst = max(rel, key=rel.get)
    norms = [r["grad_norm"] for r in runs["seq1"] + runs["seq2"]]
    print(f"{tag} step-1 gradients {{seq: 2}} against {{seq: 1}}, "
          f"||g2 - g1|| / ||g1|| per layer: "
          + ", ".join(f"{k} {min(v for (n, _), v in rel.items() if n == k):.2e}"
                      f"-{max(v for (n, _), v in rel.items() if n == k):.2e}"
                      for k in SEQ_GRAD_LEAVES)
          + f"; largest {rel[worst]:.3e} ({worst[0]}, layer {worst[1]}; "
          f"tolerance {SEQ_GRAD_L2}); global grad norm {{seq: 1}} "
          f"{norms[0]:.6f}, {{seq: 2}} {norms[1:]}")
    check(rel[worst] <= SEQ_GRAD_L2,
          f"{tag} the two-rank step-1 gradients differ from one rank's")
    check(len(set(norms[1:])) == 1,
          f"{tag} the two ranks' gradient norms differ")


# [seq]'s runs for fit_mesh_runs: (loop, name, ranks, axes).
SEQ_RUNS = [(seq_ring_loop, "ring", SEQ_RING["ranks"], None),
            (seq_train_loop, "seq1", 1, {"seq": 1}),
            (seq_train_loop, "seq2", 2, {"seq": 2})]


def phase_seq(smi, store=None):
    """Ring attention and the 0.9B model at 8k context on seq meshes of
    TorchTrainer ranks on the one card (gloo, two num_gpus=0.5 workers):
    the checks of SEQ_RUNS' files in `store`, fitted there by
    fit_mesh_runs (here, when no store is given)."""
    tag = "[seq]"
    if store is None:
        store = tempfile.mkdtemp(prefix="seq_")
        try:
            fit_mesh_runs(tag, store, SEQ_RUNS)
            return phase_seq(smi, store)
        finally:
            shutil.rmtree(store, ignore_errors=True)
    t_phase = time.perf_counter()
    check_seq_ring(tag, store, smi)
    cfg = tbench._long_context_ladder(ttf)[1][1]
    check(tbench._long_context_ladder(ttf)[1][0] == "0.9B-seq8k-b1"
          and cfg.max_seq_len == SEQ_TRAIN["seq"],
          f"{tag} the bench's 0.9B-seq8k-b1 row changed")
    print(f"{tag} 0.9B-seq8k-b1: {num_params(cfg):,} params, "
          f"{cfg.num_layers} layers, {cfg.num_heads} heads of "
          f"{cfg.head_dim_}, max_seq_len {cfg.max_seq_len}, remat "
          f"{cfg.remat_policy}, fused_ce {cfg.fused_ce}, AdamW bf16 "
          f"mu/nu; b={SEQ_TRAIN['batch']}, S={SEQ_TRAIN['seq']}")
    runs = {name: report_seq_train(tag, store, name, n, smi)
            for name, n in (("seq1", 1), ("seq2", 2))}
    one, two = runs["seq1"][0]["losses"], runs["seq2"][0]["losses"]
    rel = [abs(a - b) / abs(a) for a, b in zip(one, two)]
    print(f"{tag} losses {{seq: 2}} against {{seq: 1}}, relative: "
          f"{[f'{x:.2e}' for x in rel]} (tolerance {SEQ_LOSS_RTOL})")
    check(max(rel) <= SEQ_LOSS_RTOL,
          f"{tag} the two-rank losses differ from one rank's")
    check_seq_grads(tag, store, runs)
    ms1 = sum(runs["seq1"][0]["ms"]) / SEQ_TRAIN["steps"]
    ms2 = [sum(r["ms"]) / SEQ_TRAIN["steps"] for r in runs["seq2"]]
    print(f"{tag} on {smi}: ms per step {{seq: 1}} {ms1:.1f}, "
          f"{{seq: 2}} {[round(x, 1) for x in ms2]} (both ranks share "
          f"the card); peak memory per rank "
          f"{[round(r['peak'] / 2**30, 2) for r in runs['seq1']]} / "
          f"{[round(r['peak'] / 2**30, 2) for r in runs['seq2']]} "
          f"GiB; params bit-equal across ranks (digest)")
    print(f"{tag} TorchConfig(backend='nccl') is not run: NCCL "
          "refuses two ranks on one card; the nccl transport "
          "(CUDA tensors, no staging) waits for a machine with two "
          "cards")
    print(f"{tag} checks {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# [fsdp]: the 0.9B model trained with its params and Adam moments split over
# an fsdp mesh of TorchTrainer ranks, against one rank

# bench.py's "0.9B" row at its own batch (b = 8, s = 2048): a warm-up step
# (learning rate 0) and FSDP_TRAIN["steps"] timed steps on {fsdp: 1} in a
# num_gpus=1 worker and on {fsdp: 2} in two num_gpus=0.5 ranks (each runs
# 4 of the 8 rows).  Gates: every loss within FSDP_LOSS_RTOL of {fsdp: 1}'s;
# the step-1 gradient of each layer's wq, wk, wv and wo (summed over the
# mesh, gathered) within FSDP_GRAD_L2 in norm of {fsdp: 1}'s; the global
# grad norm within FSDP_NORM_RTOL (a norm over one rank's blocks is ~30 %
# low); each leaf's update over the run (final - initial params, gathered)
# within FSDP_UPDATE_L2 in norm of {fsdp: 1}'s; each rank's param, mu and
# nu bytes, counted from its tensors, half of {fsdp: 1}'s for every leaf
# with an embed dim and equal for the rest.  Both runs round the same
# bf16 activations; only the batch's split and the order of the gradient
# sums differ.  Read on the card (NVIDIA H100 80GB HBM3, 700 W): losses
# 4.81e-5 at most, gradients 2.35e-3 in every layer (bf16 rounding of the
# upstream gradient, the same relative size through the stack), grad norm
# 7.0e-6, updates 3.6e-3 to 1.83e-2 (bf16 mu and nu); each gate is a few
# times its reading.
FSDP_TRAIN = dict(steps=3, batch=8, seq=2048)
FSDP_LOSS_RTOL = 2e-4
FSDP_GRAD_L2 = 1e-2
FSDP_NORM_RTOL = 1e-3
FSDP_UPDATE_L2 = 5e-2

# [tensor]: the same model, batch and recipe with heads, mlp and vocab
# split over {tensor: 2} (two num_gpus=0.5 ranks, each running all 8
# rows on 7 of the 14 heads, 3,584 of the 7,168 MLP columns and 16,000
# of the 32,000 vocabulary rows), against the one-rank run ([fsdp]'s
# {fsdp: 1} in the full script; {tensor: 1} with --phase tensor).  Both
# runs see the same rows; they differ where the row-parallel products
# (wo, w_down) and the LM head's dx are summed as two bf16 partial sums
# (one bf16 rounding each) where one rank rounds the whole sum once, and
# in the order of the cross-entropy's sums.  Gates, set before the first
# reading from that: losses within TENSOR_LOSS_RTOL, step-1 gradients
# of wq, wk, wv and wo within TENSOR_GRAD_L2 in norm (a missing share of
# an activation's gradient is ~50 %), the grad norm within
# TENSOR_NORM_RTOL (a loss pair summed over tensor halves it), each
# leaf's update within TENSOR_UPDATE_L2; each rank's bytes half of the
# one rank's for every leaf with a heads, mlp or vocab dim; the bytes
# and calls of the model's all-reduces over `tensor` per rank per step
# as tensor_comm_expected counts them.
TENSOR_LOSS_RTOL = 5e-4
TENSOR_GRAD_L2 = 5e-2
TENSOR_NORM_RTOL = 5e-3
TENSOR_UPDATE_L2 = 1e-1
# Per kind of run: its gates and the logical dims its axis splits.
SPLIT_RUNS = {
    "fsdp": dict(loss=FSDP_LOSS_RTOL, grad=FSDP_GRAD_L2,
                 norm=FSDP_NORM_RTOL, update=FSDP_UPDATE_L2,
                 dims=("embed",), what="embed dim"),
    "tensor": dict(loss=TENSOR_LOSS_RTOL, grad=TENSOR_GRAD_L2,
                   norm=TENSOR_NORM_RTOL, update=TENSOR_UPDATE_L2,
                   dims=("heads", "mlp", "vocab"),
                   what="heads, mlp or vocab dim"),
}


def fsdp_split(cfg, name, dims=("embed",)):
    """Whether param leaf `name` ("blocks/wq", ...) has a dim of one of
    the logical `dims` (an embed dim by default)."""
    axes = ttf.logical_axes(cfg)
    for k in name.split("/"):
        axes = axes[k]
    return any(d in axes for d in dims)


def tensor_comm_expected(cfg, batch, seq):
    """(calls, bytes) of the model's collectives over `tensor` per rank
    per step, bf16 activations: per layer the two all-reduces of the
    forward (after wo and w_down), the first again in the checkpoint's
    re-run (which stops after the layer's last saved tensor, before the
    MLP's all-reduce), and the two of the backward (the gradients
    entering q/k/v and gate/up); the embedding's rows and the LM head's
    dx; the fused cross-entropy's max and (sum of exponentials, target
    logit) per token in fp32."""
    tokens = batch * seq
    act = tokens * cfg.hidden_size * 2
    n = 5 * cfg.num_layers + 2
    return n + 2, n * act + tokens * 4 * 3


def fsdp_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(fsdp_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def vm_rss() -> int:
    """This process's resident host memory in bytes (/proc/self/status
    VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def sharded_restore(ts, state, config, rank, dev):
    """The state gathered whole (gather_state) and saved by rank 0
    (save_pytree into config["dir"]), then each rank's blocks restored
    from the file onto the card (load_pytree(shardings=
    ts.state_shardings(state))), its resident host memory sampled every
    5 ms meanwhile: the save's and the restore's seconds, the growth of
    VmRSS, the file's bytes, the bytes of params, mu and nu restored, and
    whether every leaf equals the live block bit for bit (NamedTuple for
    NamedTuple)."""
    import torch.distributed as dist

    from ray_tpu_torch.train import checkpoint as tck

    path = os.path.join(config["dir"], f"ckpt_{config['name']}")
    layout = ts.state_shardings(state)
    t0 = time.perf_counter()
    whole = ts.gather_state(state)
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    save_s = None
    if rank == 0:
        t0 = time.perf_counter()
        tck.save_pytree(whole, path)
        save_s = time.perf_counter() - t0
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    file_bytes = os.path.getsize(os.path.join(path, tck.TENSORS))
    rss0 = peak = vm_rss()
    done = threading.Event()

    def sample():
        nonlocal peak
        while not done.is_set():
            peak = max(peak, vm_rss())
            time.sleep(0.005)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    back = tck.load_pytree(path, shardings=layout, map_location=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    done.set()
    sampler.join()
    peak = max(peak, vm_rss())
    (sa, ta), (sb, tb) = tck.flatten_pytree(back), tck.flatten_pytree(state)
    same = sa == sb and ta.keys() == tb.keys() and all(
        x.dtype == tb[k].dtype and x.device == tb[k].device
        and torch.equal(x, tb[k]) for k, x in ta.items())
    adam = back["opt_state"][1][0]
    restored = sum(t.nbytes for tree in (back["params"], adam.mu, adam.nu)
                   for t in fsdp_flat(tree).values())
    leaves = len(ta)
    del back, adam, ta, tb
    dist.barrier()
    if rank == 0:
        shutil.rmtree(path)
    return dict(gather_s=gather_s, save_s=save_s, restore_s=restore_s,
                rss_growth=peak - rss0, file_bytes=file_bytes,
                restored=restored, same=same, leaves=leaves)


def split_train_loop(config):
    """The 0.9B model on the mesh config["axes"] (every rank passes the
    same global batch; fsdp or tensor ranks): init(0); the step-1
    gradients of the attention weights, gathered; the warm-up step, then
    the timed steps with the flash kernels' launches and the step's
    collectives read around them (the model's tensor collectives'
    calls from the mesh's count); each rank's bytes of params, mu and
    nu per leaf; on rank 0 the gathered update over the run (final -
    initial params), saved.  `stages` holds the host seconds from the
    loop's start to the end of each stage."""
    import torch.distributed as dist

    from ray_tpu_torch.train.torch_backend import get_device
    from ray_tpu_torch.train.train_loop_utils import get_mesh

    t_loop = time.perf_counter()
    stages = {}

    def stage(name):
        torch.cuda.synchronize()
        stages[name] = round(time.perf_counter() - t_loop, 2)

    dev = get_device()
    mesh = get_mesh(config["axes"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    name, cfg, B, S = tbench._config_ladder(ttf)[0]
    ts = ShardedTrainStep(cfg, mesh, device=dev, optimizer=train_optimizer())
    state = ts.init(0)
    # A gather is a collective: every rank takes part, rank 0 keeps it.
    start = fsdp_flat(ts.gather(state["params"]))
    start = {k: v.float().cpu() for k, v in start.items()} if rank == 0 \
        else None
    stage("init")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (FSDP_TRAIN["batch"], FSDP_TRAIN["seq"] + 1))
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    _, grads = ts.grads(state["params"], batch)
    attn = {k: ts.param_shardings["blocks"][k].gather(grads["blocks"][k])
            for k in SEQ_GRAD_LEAVES}
    if rank == 0:
        torch.save({k: g.float().cpu() for k, g in attn.items()},
                   os.path.join(config["dir"], f"grads_{config['name']}.pt"))
    del grads, attn
    stage("grads")
    t0 = time.perf_counter()
    state, m = ts.step(state, batch)
    losses = [float(m["loss"])]
    # The warm-up step's gradient is the step-1 gradient above.
    grad_norm = float(m["grad_norm"])
    warm_ms = (time.perf_counter() - t0) * 1e3
    flash = seq_flash_kernels()
    for kern in flash.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ms, comm = [], []
    calls0 = mesh.tensor_comm["calls"]
    for _ in range(FSDP_TRAIN["steps"]):
        if dist.is_initialized():
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        comm.append(json.loads(json.dumps(ts.last_comm)))
    tensor_calls = (mesh.tensor_comm["calls"] - calls0) / FSDP_TRAIN["steps"]
    stage("steps")
    peak = torch.cuda.max_memory_allocated()
    adam = state["opt_state"][1][0]
    mu, nu = fsdp_flat(adam.mu), fsdp_flat(adam.nu)
    held = {k: [v.nbytes, mu[k].nbytes, nu[k].nbytes]
            for k, v in fsdp_flat(state["params"]).items()}
    whole = ts.gather(state["params"])
    digest = str(ts.check_replicated(whole))
    if rank == 0:
        torch.save({k: v.float().cpu() - start[k]
                    for k, v in fsdp_flat(whole).items()},
                   os.path.join(config["dir"],
                                f"update_{config['name']}.pt"))
    del whole, start
    stage("end")
    restore = None
    if mesh.axis_size(next(iter(config["axes"]))) > 1:
        restore = sharded_restore(ts, state, config, rank, dev)
        stage("restore")
    axis = next(iter(config["axes"]))
    out = dict(
        rank=rank, device=str(dev), mesh=dict(mesh.shape), losses=losses,
        grad_norm=grad_norm, warm_ms=warm_ms, ms=ms, comm=comm,
        tensor_calls=tensor_calls, stages=stages,
        launches={n: kern.launches for n, kern in flash.items()},
        peak=peak, held=held, digest=digest, restore=restore,
        transport=(tcomm.transport(mesh.get_group(axis), dev)
                   if mesh.axis_size(axis) > 1 else "none"),
        layers=cfg.num_layers, config=name, batch=B, seq=S)
    with open(os.path.join(config["dir"],
                           f"train_{config['name']}_{rank}.json"), "w") as f:
        json.dump(out, f)


def report_split_train(tag, store, name, n, smi):
    ranks = []
    for r in range(n):
        with open(os.path.join(store, f"train_{name}_{r}.json")) as f:
            ranks.append(json.load(f))
    L = ranks[0]["layers"]
    steps = FSDP_TRAIN["steps"]
    for res in ranks:
        last = res["comm"][-1]
        print(f"{tag} {name} rank {res['rank']} ({res['device']}, mesh "
              f"{ {a: s for a, s in res['mesh'].items() if s > 1} }, "
              f"transport {res['transport']}): losses "
              f"{[round(x, 5) for x in res['losses']]}; ms per step "
              f"{[round(x, 1) for x in res['ms']]} (warm-up "
              f"{res['warm_ms']:.0f}); per step: gather "
              f"{last['gather']['bytes']:,} B in "
              f"{[round(c['gather']['seconds'] * 1e3, 1) for c in res['comm']]}"
              f" ms, reduce-scatter {last['reduce_scatter']['bytes']:,} B in "
              f"{[round(c['reduce_scatter']['seconds'] * 1e3, 1) for c in res['comm']]}"
              f" ms, all-reduce {last['all_reduce']['bytes']:,} B in "
              f"{[round(c['all_reduce']['seconds'] * 1e3, 1) for c in res['comm']]}"
              f" ms, tensor {res['tensor_calls']:g} calls, "
              f"{last['tensor']['bytes']:,} B in "
              f"{[round(c['tensor']['seconds'] * 1e3, 1) for c in res['comm']]}"
              f" ms; peak memory {res['peak'] / 2**30:.2f} GiB; on {smi}")
        per_step = {k: v / steps for k, v in res["launches"].items()}
        print(f"{tag} {name} rank {res['rank']} flash launches per step "
              f"{json.dumps(per_step)}; host seconds from the loop's start "
              f"to the end of init (with the start gather), the step-1 "
              f"gradients, the steps, the end gather and save "
              f"{json.dumps(res['stages'])}")
        check(res["launches"] == seq_expected(1, L, steps, 2),
              f"{tag} {name} rank {res['rank']}: flash launches differ from "
              f"{seq_expected(1, L, steps, 2)}")
        check(all(math.isfinite(x) for x in res["losses"]),
              f"{tag} {name}: a loss is not finite")
    check(len({r["digest"] for r in ranks}) == 1
          and all(r["losses"] == ranks[0]["losses"] for r in ranks),
          f"{tag} {name}: the ranks' gathered params or losses differ")
    if n > 1:
        report_restore(tag, name, ranks, smi)
    return ranks


def report_restore(tag, name, ranks, smi):
    """The sharded restore of a two-rank run (sharded_restore): every
    leaf bit-equal to the rank's live block, the bytes of params, mu and
    nu restored equal to the rank's own held bytes, and the growth of
    the rank's resident host memory during the restore below the size of
    the whole tensors.pt."""
    for res in ranks:
        r = res["restore"]
        held = sum(sum(v) for v in res["held"].values())
        save = (f"gathered in {r['gather_s']:.2f} s, saved whole by rank 0 "
                f"in {r['save_s']:.2f} s, " if r["save_s"] is not None
                else f"gathered in {r['gather_s']:.2f} s, ")
        print(f"{tag} {name} rank {res['rank']} sharded restore: {save}"
              f"tensors.pt {r['file_bytes']:,} B; its blocks restored onto "
              f"{res['device']} in {r['restore_s']:.2f} s (load_pytree("
              f"shardings=...), warm page cache): params + mu + nu "
              f"{r['restored']:,} B against {held:,} B held, {r['leaves']} "
              f"leaves bit-equal to the live blocks: {r['same']}; VmRSS "
              f"grew {r['rss_growth'] / 2**20:.1f} MiB at most during the "
              f"restore; on {smi}")
        check(r["same"], f"{tag} {name} rank {res['rank']}: a restored "
              "block differs from the live one")
        check(r["restored"] == held, f"{tag} {name} rank {res['rank']}: "
              f"restored {r['restored']:,} B, holds {held:,} B")
        check(r["rss_growth"] < r["file_bytes"],
              f"{tag} {name} rank {res['rank']}: host memory grew by the "
              "whole checkpoint or more during the restore")


def check_split(tag, store, runs, smi, kind, names):
    """The two-rank run `names[1]` of `kind` ("fsdp" or "tensor": its
    gates and split dims, SPLIT_RUNS) against the one-rank run
    `names[0]`."""
    gates = SPLIT_RUNS[kind]
    one, two = runs[names[0]], runs[names[1]]
    m1, m2 = f"{{{kind}: 1}}", f"{{{kind}: 2}}"
    cfg = tbench._config_ladder(ttf)[0][1]
    # Losses.
    rel = [abs(a - b) / abs(a) for a, b in zip(one[0]["losses"],
                                               two[0]["losses"])]
    print(f"{tag} losses {m2} against {m1}, relative: "
          f"{[f'{x:.2e}' for x in rel]} (tolerance {gates['loss']})")
    check(max(rel) <= gates["loss"],
          f"{tag} the two-rank losses differ from one rank's")
    # Step-1 gradients of the attention weights, layer by layer.
    g1, g2 = (torch.load(os.path.join(store, f"grads_{n}.pt"),
                         weights_only=True) for n in names)
    grel = {}
    for k in SEQ_GRAD_LEAVES:
        for layer, (a, b) in enumerate(zip(g1[k], g2[k])):
            grel[(k, layer)] = ((b - a).norm() / a.norm()).item()
    worst = max(grel, key=grel.get)
    norms = [r["grad_norm"] for r in one + two]
    nrel = max(abs(x - norms[0]) / norms[0] for x in norms[1:])
    print(f"{tag} step-1 gradients {m2} against {m1}, "
          f"||g2 - g1|| / ||g1|| per layer: "
          + ", ".join(
              f"{k} {min(v for (n, _), v in grel.items() if n == k):.2e}-"
              f"{max(v for (n, _), v in grel.items() if n == k):.2e}"
              for k in SEQ_GRAD_LEAVES)
          + f"; largest {grel[worst]:.3e} ({worst[0]}, layer {worst[1]}; "
          f"tolerance {gates['grad']}); global grad norm {m1} "
          f"{norms[0]:.6f}, {m2} {norms[1:]} (relative {nrel:.2e}, "
          f"tolerance {gates['norm']})")
    check(grel[worst] <= gates["grad"],
          f"{tag} the two-rank step-1 gradients differ from one rank's")
    check(nrel <= gates["norm"],
          f"{tag} the two-rank grad norm differs from one rank's")
    # The update over the run, leaf by leaf.
    u1, u2 = (torch.load(os.path.join(store, f"update_{n}.pt"),
                         weights_only=True) for n in names)
    urel = {k: ((u2[k] - u1[k]).norm() / u1[k].norm()).item() for k in u1}
    uworst = max(urel, key=urel.get)
    print(f"{tag} params' update over the {FSDP_TRAIN['steps'] + 1} steps "
          f"(gathered), ||u2 - u1|| / ||u1|| per leaf: "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(urel.items()))
          + f" (tolerance {gates['update']})")
    check(urel[uworst] <= gates["update"],
          f"{tag} the two-rank update of {uworst} differs from one rank's")
    del g1, g2, u1, u2
    # Each rank's bytes, counted from its tensors.
    whole = one[0]["held"]
    tot1 = [sum(v[i] for v in whole.values()) for i in range(3)]
    for res in two:
        for k, (p, m, v) in res["held"].items():
            w = whole[k]
            want = [x // 2 for x in w] if fsdp_split(cfg, k, gates["dims"]) \
                else w
            check([p, m, v] == want, f"{tag} rank {res['rank']} holds "
                  f"{[p, m, v]} B of {k} (params, mu, nu); want {want}")
        tot = [sum(x[i] for x in res["held"].values()) for i in range(3)]
        print(f"{tag} rank {res['rank']} holds params {tot[0]:,} B, mu "
              f"{tot[1]:,} B, nu {tot[2]:,} B against {m1}'s "
              f"{tot1[0]:,} / {tot1[1]:,} / {tot1[2]:,} B (each leaf with "
              f"a {gates['what']} half, the norms whole)")
    ms1 = sum(one[0]["ms"]) / FSDP_TRAIN["steps"]
    ms2 = [sum(r["ms"]) / FSDP_TRAIN["steps"] for r in two]
    print(f"{tag} on {smi}: ms per step {m1} {ms1:.1f}, {m2} "
          f"{[round(x, 1) for x in ms2]} (both ranks share the card; "
          f"host clock); peak memory per rank "
          f"{[round(r['peak'] / 2**30, 2) for r in one]} / "
          f"{[round(r['peak'] / 2**30, 2) for r in two]} GiB; gathered "
          f"params bit-equal across ranks (digest)")


def check_tensor_comm(tag, ranks, cfg):
    """Each {tensor: 2} rank's calls and bytes of the model's collectives
    over `tensor` per step, against tensor_comm_expected."""
    calls, nbytes = tensor_comm_expected(cfg, FSDP_TRAIN["batch"],
                                         FSDP_TRAIN["seq"])
    for res in ranks:
        got = [c["tensor"]["bytes"] for c in res["comm"]]
        secs = [c["tensor"]["seconds"] for c in res["comm"]]
        print(f"{tag} rank {res['rank']} tensor collectives per step: "
              f"{res['tensor_calls']:g} calls, {got} B in "
              f"{[round(x, 3) for x in secs]} s (expected {calls} calls, "
              f"{nbytes:,} B: per layer 2 forward, 1 re-run, 2 backward "
              f"activation all-reduces of "
              f"{FSDP_TRAIN['batch'] * FSDP_TRAIN['seq'] * cfg.hidden_size * 2:,}"
              f" B, the embedding's and the LM head's dx, the CE's 2)")
        check(res["tensor_calls"] == calls and set(got) == {nbytes},
              f"{tag} rank {res['rank']}: the tensor collectives differ "
              "from the count")


def split_runs(kind, one=True):
    """[fsdp]'s or [tensor]'s runs for fit_mesh_runs: {kind: 2}, and
    first {kind: 1} when `one`."""
    return [(split_train_loop, f"{kind}{n}", n, {kind: n})
            for n in ((1, 2) if one else (2,))]


def phase_split(smi, kind, store=None, ref=None):
    """The 0.9B model split over a mesh of TorchTrainer ranks on the one
    card (gloo, two num_gpus=0.5 workers), against one num_gpus=1
    worker: `kind` "fsdp" ([fsdp]: params and Adam moments split over
    fsdp) or "tensor" ([tensor]: heads, mlp and vocab over tensor).  The
    checks of the runs' files in `store`, fitted there by fit_mesh_runs
    (here, when no store is given); `ref` names the one-rank run to hold
    the two-rank run against ({kind: 1} by default)."""
    tag = f"[{kind}]"
    if store is None:
        store = tempfile.mkdtemp(prefix=f"{kind}_")
        try:
            fit_mesh_runs(tag, store, split_runs(kind))
            return phase_split(smi, kind, store)
        finally:
            shutil.rmtree(store, ignore_errors=True)
    t_phase = time.perf_counter()
    name, cfg, B, S = tbench._config_ladder(ttf)[0]
    check(name == "0.9B" and (B, S) == (FSDP_TRAIN["batch"],
                                        FSDP_TRAIN["seq"]),
          f"{tag} the bench's 0.9B row changed")
    print(f"{tag} {name}: {num_params(cfg):,} params, "
          f"{cfg.num_layers} layers, {cfg.num_heads} heads of "
          f"{cfg.head_dim_}, remat {cfg.remat_policy}, fused_ce "
          f"{cfg.fused_ce}, AdamW bf16 mu/nu; b={B}, s={S}")
    ref = ref or f"{kind}1"
    if ref != f"{kind}1":
        print(f"{tag} one rank: {ref}'s run (the same step)")
    runs = {run: report_split_train(tag, store, run, n, smi)
            for run, n in ((ref, 1), (f"{kind}2", 2))}
    two = runs[f"{kind}2"]
    check(all(r["transport"] == "gloo-host" for r in two),
          f"{tag} the {kind} collectives did not stage through "
          "host buffers")
    if kind == "tensor":
        check_tensor_comm(tag, two, cfg)
    check_split(tag, store, runs, smi, kind, (ref, f"{kind}2"))
    print(f"{tag} checks {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi, name = phase_card()
    phase_build()
    if sys.argv[1:] == ["--phase", "serve"]:
        # [serve] alone, for work on that phase: [pipelined]'s streams are
        # not computed, so their share is not reported.
        prompts, max_new = main_requests()
        first, later, pipe_new = pipelined_requests(
            np.random.default_rng(10))
        phase_serve(smi, prompts, max_new, first, later, pipe_new, None)
        print("chip_smoke: [serve] alone passed")
        return 0
    if sys.argv[1:] == ["--phase", "train"]:
        # [train-runtime] alone, with [train] before it as its reference.
        _, train_ref = phase_train(dev, smi)
        phase_train_runtime(smi, train_ref)
        print("chip_smoke: [train-runtime] alone passed")
        return 0
    if sys.argv[1:] == ["--phase", "runtime"]:
        # [runtime] alone, with [main] before it as its reference.
        cfg = TransformerConfig.llama2_7b()
        params = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
        launches_main, eng, prompts, max_new, _, streams_main = \
            phase_main_path(dev, params, cfg)
        main_captures = eng.graphs.captures
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
        phase_runtime(smi, prompts, max_new, streams_main, launches_main,
                      main_captures, cfg.num_layers)
        print("chip_smoke: [runtime] alone passed")
        return 0
    if sys.argv[1:] == ["--phase", "seq"]:
        phase_seq(smi)
        print("chip_smoke: [seq] alone passed")
        return 0
    if sys.argv[1:] == ["--phase", "fsdp"]:
        phase_split(smi, "fsdp")
        print("chip_smoke: [fsdp] alone passed")
        return 0
    if sys.argv[1:] == ["--phase", "tensor"]:
        phase_split(smi, "tensor")
        print("chip_smoke: [tensor] alone passed")
        return 0
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
    launches_main, eng, prompts, max_new, rates, streams_main = \
        phase_main_path(dev, params, cfg)
    print(f"[main] on {smi}: prefill {rates['prefill_tok_s']:.0f} tok/s, "
          f"decode {rates['decode_tok_s']:.0f} tok/s (host clock around "
          f"synchronized admit / decode calls; every decode step a graph "
          f"replay; {eng.graphs.captures} captures, "
          f"{eng.graphs.capture_seconds:.2f} s, left out)")
    main_captures = eng.graphs.captures
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
    launches_train, train_ref = phase_train(dev, smi)
    phase_train_remat(dev, smi)
    phase_train_depth(dev)
    phase_moe_train(dev, smi)
    phase_moe_train_fp32(dev)
    timings.update(phase_timings_train(dev, smi))
    gc.collect()
    torch.cuda.empty_cache()
    phase_runtime(smi, prompts, max_new, streams_main, launches_main,
                  main_captures, cfg.num_layers)
    phase_serve(smi, prompts, max_new, pipe_prompts[:16], pipe_prompts[16:],
                pipe_new, streams)
    phase_train_runtime(smi, train_ref)
    store = tempfile.mkdtemp(prefix="meshes_")
    try:
        # One cluster for the mesh phases' runs; [fsdp]'s {fsdp: 1} run
        # is also the one-rank step [tensor] is held to.
        fit_mesh_runs("[seq] [fsdp] [tensor]", store, SEQ_RUNS
                      + split_runs("fsdp") + split_runs("tensor", one=False))
        phase_seq(smi, store)
        phase_split(smi, "fsdp", store)
        phase_split(smi, "tensor", store, ref="fsdp1")
    finally:
        shutil.rmtree(store, ignore_errors=True)

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
