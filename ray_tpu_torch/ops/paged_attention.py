"""Paged attention: single-token decode over a paged KV cache.

Port of ray_tpu/ops/paged_attention.py.  KV blocks live in fixed-size
pages with all KV heads fused into the row:

    k_pages / v_pages: [P, page, KVH * D]

and each sequence owns a list of pages (its block table), so cache memory
is allocated page by page with no fragmentation copies.  Two kernels sit
on every decode step, each written in CUDA for Hopper (csrc/) with a
plain PyTorch version of the same function beside it:

  - `paged_attention`: one query token per sequence against its pages
    (csrc/paged_decode.cu; plain: `paged_attention_plain`);
  - `write_token_rows`: the new token's K/V row written in place
    (csrc/row_write.cu; plain: `write_token_rows_plain`);
  - `rope_write_token_rows`: the same write folded into the decode
    step's rotary embedding, one launch per layer that rotates q and k
    and writes the K and V rows (csrc/row_write.cu, the decode path's
    kernel; plain: `rope_write_token_rows_plain`).

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  `write_page_tokens` (prefill)
was an XLA scatter in the reference, not a kernel, and stays a plain
in-place `index_put_` here on every device; like the row write it sends
pad rows to the scratch page instead of filtering them, so neither
waits on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops._build import Kernel, dtype_code

_c_int, _c_ll, _c_f, _c_p = (ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_float, ctypes.c_void_p)

PAGED_DECODE = Kernel(
    "paged_decode", "paged_decode_attention",
    [_c_p, _c_p, _c_p, _c_p, _c_p, _c_p, _c_p, _c_int, _c_int, _c_int,
     _c_int, _c_int, _c_ll, _c_int, _c_int, _c_f, _c_int])
# Tokens of context per block of the decode kernel (a multiple of its
# 32-token tile): sequences longer than this spread over several blocks
# whose partial softmax states a second kernel merges.
SPLIT_TOKENS = 256
ROW_WRITE = Kernel(
    "row_write", "row_write",
    [_c_p, _c_p, _c_p, _c_p, _c_p, _c_p, _c_int, _c_int, _c_int, _c_int,
     _c_ll, _c_int])
ROPE_ROW_WRITE = Kernel(
    "row_write", "rope_row_write",
    [_c_p] * 10 + [_c_int] * 7 + [_c_ll, _c_int, _c_int])
# Half of the widest head the rotating row write takes (csrc/row_write.cu
# kMaxHalf: the cos/sin row it keeps in shared memory).
ROPE_MAX_HALF = 256


def _check_rows(k_pages: torch.Tensor, v_pages: torch.Tensor) -> None:
    """Pages must be [*, page, KD] with contiguous rows and one layout."""
    if k_pages.dim() != 3 or k_pages.shape != v_pages.shape \
            or k_pages.stride() != v_pages.stride() \
            or k_pages.stride(2) != 1 \
            or k_pages.stride(1) != k_pages.shape[2]:
        raise ValueError(
            "k_pages/v_pages must be [P, page, KD] tensors of one layout "
            f"with contiguous rows; got shapes {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)} strides {k_pages.stride()}, "
            f"{v_pages.stride()}")


def _i32(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    if x.device != device:
        raise ValueError(f"index tensor on {x.device}, expected {device}")
    return x.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Decode-time attention for one new token per sequence.

    q:            [B, H, D]            query for the current position
    k_pages:      [P, page, KVH*D]     paged key cache (one layer, or the
                                       flat [L*P, ...] view with tables
                                       offset by l*P)
    v_pages:      [P, page, KVH*D]     paged value cache
    block_tables: [B, W] int           page ids (entries past ctx ignored)
    context_lens: [B] int              tokens in cache per sequence
                                       (including the current one)
    Returns [B, H, D] in q's dtype; rows with context_lens == 0 are zero.
    """
    if q.is_cuda:
        return _paged_attention_cuda(q, k_pages, v_pages, block_tables,
                                     context_lens, sm_scale)
    return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                 context_lens, sm_scale)


def _paged_attention_cuda(q, k_pages, v_pages, block_tables, context_lens,
                          sm_scale):
    B, H, D = q.shape
    _check_rows(k_pages, v_pages)
    P, page, KD = k_pages.shape
    if KD % D or H % (KD // D):
        raise ValueError(f"fused row width {KD} does not split into "
                         f"heads of {D} dividing {H} query heads")
    if D > 256:
        raise ValueError(f"paged decode kernel takes head_dim <= 256, "
                         f"got {D}")
    W = block_tables.shape[1]
    if W < 1 or block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("block_tables must be [B, W >= 1] and "
                         "context_lens [B]")
    code = dtype_code(q, k_pages, v_pages)
    dev = q.device
    q = q.contiguous()
    tables = _i32(block_tables, dev)
    ctx = _i32(context_lens, dev)
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_split = -(-W * page // SPLIT_TOKENS)
    part = torch.empty((B, H, n_split, D + 2) if n_split > 1 else (0,),
                       dtype=torch.float32, device=dev)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    PAGED_DECODE.launch(
        dev, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), ctx.data_ptr(), out.data_ptr(), part.data_ptr(),
        B, H, D, KD // D, page, k_pages.stride(0), W, SPLIT_TOKENS, scale,
        code)
    return out


def paged_attention_plain(q, k_pages, v_pages, block_tables, context_lens,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of the decode kernel: gather each
    sequence's pages, fp32 softmax over its first context_lens tokens,
    p in v's dtype for P*V, zeros for rows with context_lens == 0."""
    B, H, D = q.shape
    P, page, KD = k_pages.shape
    KVH = KD // D
    G = H // KVH
    W = block_tables.shape[1]
    T = W * page
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, T, KVH, D).permute(0, 2, 1, 3)  # [B,KVH,T,D]
    v = v_pages[idx].reshape(B, T, KVH, D).permute(0, 2, 1, 3)
    qg = q.reshape(B, KVH, G, D)
    logits = torch.einsum("bkgd,bktd->bkgt", qg.float(), k.float()) * scale
    visible = (torch.arange(T, device=q.device)[None, :]
               < context_lens.to(q.device)[:, None])[:, None, None, :]
    logits = logits.masked_fill(~visible, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).masked_fill(~visible, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgt,bktd->bkgd", p.to(v.dtype).float(),
                       v.float()) / l
    out = out.masked_fill(~visible.any(dim=-1, keepdim=True), 0.0)
    return out.reshape(B, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Cache writes
# ---------------------------------------------------------------------------

def write_page_tokens(k_pages, v_pages, k_new, v_new, block_tables,
                      positions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new K/V rows into their pages in place (prefill path).

    k_pages/v_pages: [P, page, KVH*D]; k_new/v_new: [B, S, KVH, D];
    positions: [B, S] absolute positions (define page + offset), < 0 on
    padding; block_tables: [B, W].  Rows with position < 0 go to the
    scratch page FP-1, offset 0, as in `write_token_rows`: the reference
    drops them, and every page but the scratch page, which the engine
    never allocates, ends up the same.  Routing them there instead of
    filtering them out keeps the call free of any wait on the device.
    Returns the same (k_pages, v_pages) tensors."""
    B, S, KVH, D = k_new.shape
    FP, page = k_pages.shape[:2]
    valid = (positions >= 0).reshape(-1)
    pos = positions.long().clamp_min(0)
    pages = block_tables.long().gather(1, pos // page).reshape(-1)
    pages = torch.where(valid, pages, torch.full_like(pages, FP - 1))
    offs = torch.where(valid, (pos % page).reshape(-1), 0)
    k_pages.index_put_((pages, offs), k_new.reshape(B * S, -1))
    v_pages.index_put_((pages, offs), v_new.reshape(B * S, -1))
    return k_pages, v_pages


def write_token_rows(k_pages, v_pages, k_new, v_new, block_tables,
                     positions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-path single-token write: one fused [KVH*D] row per
    sequence, in place.

    k_pages/v_pages: [FP, page, KVH*D]; k_new/v_new: [B, KVH, D];
    positions: [B] absolute position (< 0 = drop); block_tables: [B, W]
    (already layer-offset).  The row goes to page
    block_tables[b, pos // page] (the index clamped to W - 1), offset
    pos % page; dropped rows land in the scratch page FP-1, offset 0,
    which the engine never allocates (serve/llm_engine.py PageAllocator).
    Returns the same (k_pages, v_pages) tensors."""
    if k_pages.is_cuda:
        return _write_token_rows_cuda(k_pages, v_pages, k_new, v_new,
                                      block_tables, positions)
    return write_token_rows_plain(k_pages, v_pages, k_new, v_new,
                                  block_tables, positions)


def _write_token_rows_cuda(k_pages, v_pages, k_new, v_new, block_tables,
                           positions):
    B = k_new.shape[0]
    _check_rows(k_pages, v_pages)
    FP, page, KD = k_pages.shape
    if k_new.shape != v_new.shape or k_new[0].numel() != KD:
        raise ValueError(f"k_new/v_new {tuple(k_new.shape)} do not hold one "
                         f"row of {KD} per sequence")
    if k_new.dtype != k_pages.dtype or v_new.dtype != k_pages.dtype:
        raise TypeError("new rows and pages must share a dtype")
    W = block_tables.shape[1]
    if W < 1 or block_tables.shape[0] != B or positions.shape != (B,):
        raise ValueError("block_tables must be [B, W >= 1] and positions [B]")
    if B == 0:
        return k_pages, v_pages
    dev = k_pages.device
    kn = k_new.reshape(B, KD).contiguous()
    vn = v_new.reshape(B, KD).contiguous()
    tables = _i32(block_tables, dev)
    pos = _i32(positions, dev)
    esize = k_pages.element_size()
    ROW_WRITE.launch(
        dev, k_pages.data_ptr(), v_pages.data_ptr(), kn.data_ptr(),
        vn.data_ptr(), tables.data_ptr(), pos.data_ptr(), B, W, page, FP,
        k_pages.stride(0) * esize, KD * esize)
    return k_pages, v_pages


def write_token_rows_plain(k_pages, v_pages, k_new, v_new, block_tables,
                           positions) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the row-write kernel: index_put_ of
    one row per sequence, dropped rows sent to page FP-1, offset 0."""
    B = k_new.shape[0]
    FP, page = k_pages.shape[:2]
    W = block_tables.shape[1]
    valid = positions >= 0
    pos = positions.long().clamp_min(0)
    slot = (pos // page).clamp_max(W - 1)
    pages = block_tables.long().gather(1, slot[:, None])[:, 0]
    pages = torch.where(valid, pages, torch.full_like(pages, FP - 1))
    offs = torch.where(valid, pos % page, torch.zeros_like(pos))
    k_pages.index_put_((pages, offs), k_new.reshape(B, -1))
    v_pages.index_put_((pages, offs), v_new.reshape(B, -1))
    return k_pages, v_pages


def rope_write_token_rows(q, k, v, cos, sin, k_pages, v_pages,
                          block_tables, positions) -> torch.Tensor:
    """A decode layer's rotary embedding and row write, in one call.

    q: [B, H, D] and k, v: [B, KVH, D], the new token's projections, not
    yet rotated; cos, sin: fp32 [max_len, D // 2] rotary tables;
    k_pages / v_pages, block_tables, positions as in `write_token_rows`.
    Rotates q and k at position max(pos, 0) as models/transformer.py
    `apply_rope` does (halves paired, fp32 products, one rounding to the
    working dtype), writes the rotated K row and the V row in place as
    `write_token_rows` does (pos < 0 to the scratch page FP-1, offset 0)
    and returns the rotated q, a new [B, H, D] tensor."""
    if k_pages.is_cuda:
        return _rope_write_token_rows_cuda(q, k, v, cos, sin, k_pages,
                                           v_pages, block_tables, positions)
    return rope_write_token_rows_plain(q, k, v, cos, sin, k_pages, v_pages,
                                       block_tables, positions)


def _rope_write_token_rows_cuda(q, k, v, cos, sin, k_pages, v_pages,
                                block_tables, positions):
    _check_rows(k_pages, v_pages)
    FP, page, KD = k_pages.shape
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"be [B, heads, D]")
    B, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != D \
            or k[0].numel() != KD:
        raise ValueError(f"k/v {tuple(k.shape)} do not hold one row of "
                         f"{KD} per sequence in heads of {D}")
    if D % 2 or D // 2 > ROPE_MAX_HALF:
        raise ValueError(f"rotating row write takes an even head_dim <= "
                         f"{2 * ROPE_MAX_HALF}, got {D}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32 \
            or cos.dim() != 2 or cos.shape != sin.shape \
            or cos.shape[1] != D // 2:
        raise ValueError(f"cos/sin must be float32 [max_len, {D // 2}]")
    code = dtype_code(q, k, v, k_pages, v_pages)
    W = block_tables.shape[1]
    if W < 1 or block_tables.shape[0] != B or positions.shape != (B,):
        raise ValueError("block_tables must be [B, W >= 1] and positions [B]")
    dev = k_pages.device
    if any(t.device != dev for t in (q, k, v, cos, sin, v_pages)):
        raise ValueError(f"every tensor must be on {dev}")
    q, k, v, cos, sin = (t.contiguous() for t in (q, k, v, cos, sin))
    tables = _i32(block_tables, dev)
    pos = _i32(positions, dev)
    out = torch.empty_like(q)
    if B == 0:
        return out
    ROPE_ROW_WRITE.launch(
        dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        out.data_ptr(), tables.data_ptr(), pos.data_ptr(), B, H, KD // D,
        D, W, page, FP, k_pages.stride(0), cos.shape[0], code)
    return out


def _rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor
            ) -> torch.Tensor:
    """x [B, heads, D] rotated by per-sequence rows c, s [B, D // 2]:
    models/transformer.py `apply_rope`'s arithmetic (ops/ may not import
    models/; a test pins the two together)."""
    c, s = c[:, None, :], s[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def rope_write_token_rows_plain(q, k, v, cos, sin, k_pages, v_pages,
                                block_tables, positions) -> torch.Tensor:
    """The plain PyTorch version of the rotating row write: the rotation
    of q and k at max(pos, 0), then `write_token_rows_plain`."""
    p = positions.long().clamp_min(0)
    c, s = cos[p], sin[p]
    write_token_rows_plain(k_pages, v_pages, _rotate(k, c, s), v,
                           block_tables, positions)
    return _rotate(q, c, s)


# ---------------------------------------------------------------------------
# Test reference
# ---------------------------------------------------------------------------

def _to_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.double() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def paged_attention_reference(q, k_pages, v_pages, block_tables,
                              context_lens) -> np.ndarray:
    """O(B*T) numpy float64 reference for tests: per-sequence dense
    attention over the gathered cache; zeros for context_lens == 0."""
    q = _to_f64(q).astype(np.float64)
    k_pages = _to_f64(k_pages).astype(np.float64)
    v_pages = _to_f64(v_pages).astype(np.float64)
    block_tables = _to_f64(block_tables)
    context_lens = _to_f64(context_lens)
    B, H, D = q.shape
    P, page, KD = k_pages.shape
    KVH = KD // D
    G = H // KVH
    out = np.zeros_like(q)
    for b in range(B):
        n = int(context_lens[b])
        if n == 0:
            continue
        ks, vs = [], []
        for t in range(n):
            p = block_tables[b, t // page]
            ks.append(k_pages[p, t % page].reshape(KVH, D))
            vs.append(v_pages[p, t % page].reshape(KVH, D))
        k = np.stack(ks)  # [n, KVH, D]
        v = np.stack(vs)
        for h in range(H):
            kh = h // G
            logits = (k[:, kh] @ q[b, h]) / np.sqrt(D)
            w = np.exp(logits - logits.max())
            w = w / w.sum()
            out[b, h] = w @ v[:, kh]
    return out
