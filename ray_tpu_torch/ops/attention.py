"""Attention ops: flash-attention forward (CUDA kernel) and plain versions.

Port of ray_tpu/ops/attention.py.

  - `flash_attention(q, k, v, causal=...)`: tiled online-softmax attention
    that never materializes the s x s score matrix
    (csrc/flash_fwd_sm90.cu or csrc/flash_fwd.cu).  When sq < sk the windows are end-aligned, as
    in `attention_reference`.
  - `flash_attention_chunk(...)`: the offset-aware form returning
    (out, lse); q_off / kv_off are the global positions of q[:, 0] and
    k[:, 0].  Rows that see no key get out = 0 and lse = -1e30
    (`_NEG_INF`), which ring attention's merge reads as "no weight".
  - `flash_attention_chunk_plain` / `flash_attention_chunk_bwd_plain`:
    the plain PyTorch versions of the forward and backward kernels,
    taken for CPU tensors.
  - `attention_reference`: plain attention, the numerical ground truth.
  - `flash_variant`: which kernel a CUDA call runs, from dtype, head dim
    and alignment: bf16 with head dim 64 or 128 on 16-byte-aligned
    tensors takes the Hopper kernels (TMA-fed wgmma: csrc/flash_fwd_sm90.cu,
    csrc/flash_bwd_dq_sm90.cu for dq, csrc/flash_bwd_sm90.cu for dk/dv);
    every other shape the kernels of csrc/flash_fwd.cu and
    csrc/flash_bwd.cu.

Layout: q is [batch, seq, heads, head_dim]; k and v may carry fewer heads
than q (GQA, heads dividing q's), which the kernel reads without
expanding.  The gradient (`_FlashChunk`) recomputes p from the saved
lse in two kernels, each picked by `flash_variant`: dq per query tile
(csrc/flash_bwd_dq_sm90.cu or csrc/flash_bwd.cu), and dk/dv per key tile
summed over the GQA group's query heads (csrc/flash_bwd_sm90.cu or
csrc/flash_bwd.cu), so the backward never materializes the s x s matrix
either.  The lse output is differentiable (ring attention's merge weights
chunks by it).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops._build import Kernel, dtype_code

_NEG_INF = float(-1e30)

_c_int, _c_f, _c_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

FLASH_FWD = Kernel(
    "flash_fwd", "flash_fwd",
    [_c_p, _c_p, _c_p, _c_p, _c_p, _c_int, _c_int, _c_int, _c_int, _c_int,
     _c_int, _c_int, _c_int, _c_int, _c_f, _c_int])
# After the pointers: b, h, hk, sq, sk, d, q_off, kv_off, causal, scale,
# dtype.
_BWD_DIMS = [_c_int] * 9 + [_c_f, _c_int]
FLASH_BWD_DQ = Kernel("flash_bwd", "flash_bwd_dq", [_c_p] * 7 + _BWD_DIMS)
FLASH_BWD_DKV = Kernel("flash_bwd", "flash_bwd_dkv",
                       [_c_p] * 8 + _BWD_DIMS)
# The Hopper kernels take bf16 only: no dtype argument.
FLASH_FWD_SM90 = Kernel("flash_fwd_sm90", "flash_fwd_sm90",
                        [_c_p] * 5 + [_c_int] * 9 + [_c_f])
FLASH_BWD_DQ_SM90 = Kernel("flash_bwd_dq_sm90", "flash_bwd_dq_sm90",
                           [_c_p] * 7 + [_c_int] * 9 + [_c_f])
FLASH_BWD_DKV_SM90 = Kernel("flash_bwd_sm90", "flash_bwd_dkv_sm90",
                            [_c_p] * 8 + [_c_int] * 9 + [_c_f])
# Every kernel that computes the forward, dq or dk/dv: a run counts a call
# of the op by the sum of their launches.
FLASH_FWD_KERNELS = (FLASH_FWD, FLASH_FWD_SM90)
FLASH_BWD_DQ_KERNELS = (FLASH_BWD_DQ, FLASH_BWD_DQ_SM90)
FLASH_BWD_DKV_KERNELS = (FLASH_BWD_DKV, FLASH_BWD_DKV_SM90)

SM90_HEAD_DIMS = (64, 128)


def flash_variant(dtype: torch.dtype, head_dim: int, aligned: bool) -> str:
    """The kernel a CUDA flash forward, dq or dk/dv call runs: "sm90" (the
    Hopper wgmma kernels) for bf16 with head dim 64 or 128 on tensors
    that are all 16-byte aligned (TMA's rule); else "mma_sync" (the
    older tensor-core kernels: bf16, head dims of 16..128 in steps of
    16, aligned) or "cuda_cores" (float32 and every other bf16 shape).
    The one place the choice is made, before launch."""
    if dtype == torch.bfloat16 and aligned:
        if head_dim in SM90_HEAD_DIMS:
            return "sm90"
        if head_dim % 16 == 0 and head_dim <= 128:
            return "mma_sync"
    return "cuda_cores"


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def attention_reference(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention. q:[b,s,h,d] k,v:[b,t,h,d] -> [b,s,h,d]."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        # Align ends: query i attends keys j where j - (sk - sq) <= i.
        mask = (torch.arange(sk, device=q.device)[None, :] - (sk - sq)
                <= torch.arange(sq, device=q.device)[:, None])
        logits = logits.masked_fill(~mask[None, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _check_qkv(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(
            f"expected q [b,sq,h,d] and k/v [b,sk,hk,d] with hk dividing h; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def _flash_chunk_cuda(q, k, v, q_off: int, kv_off: int, causal: bool,
                      sm_scale: float, sm90: Optional[bool] = None):
    """The forward on CUDA tensors, through the kernel `flash_variant`
    picks (`sm90=False` forces csrc/flash_fwd.cu, to time it beside the
    Hopper kernel)."""
    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if d > 256:
        raise ValueError(f"flash kernel takes head_dim <= 256, got {d}")
    code = dtype_code(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    if sm90 is None:
        sm90 = flash_variant(q.dtype, d, _aligned(q, k, v, out)) == "sm90"
    if b and sq:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, h, hk, sq, sk, d, q_off, kv_off,
                int(causal), sm_scale)
        if sm90:
            FLASH_FWD_SM90.launch(q.device, *args)
        else:
            FLASH_FWD.launch(q.device, *args, code)
    return out, lse


def flash_attention_chunk_plain(q, k, v, q_off: int, kv_off: int,
                                causal: bool = True,
                                sm_scale: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the flash kernel: dense scores in
    fp32, masked in global positions (col <= row), p in v's dtype for
    P*V.  Returns (out [b,sq,h,d] in q's dtype, lse [b*h, sq] fp32);
    rows that see no key get out = 0 and lse = -1e30."""
    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    rows = int(q_off) + torch.arange(sq, device=q.device)
    cols = int(kv_off) + torch.arange(sk, device=q.device)
    if causal:
        visible = cols[None, :] <= rows[:, None]             # [sq, sk]
    else:
        visible = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    s = s.masked_fill(~visible, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True) if sk else torch.full(
        (*s.shape[:-1], 1), _NEG_INF, device=q.device)
    p = torch.exp(s - m).masked_fill(~visible, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)          # [b,h,sq,1]
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                       v.float()) / l
    valid = visible.any(dim=-1)                                # [sq]
    out = out.masked_fill(~valid[None, None, :, None], 0.0)
    lse = torch.where(valid[None, None, :], (m + torch.log(l))[..., 0],
                      torch.full_like(l[..., 0], _NEG_INF))
    return (out.permute(0, 2, 1, 3).to(q.dtype),
            lse.reshape(b * h, sq))


def _bwd_corr(out, dout, dlse, b: int, h: int, sq: int) -> torch.Tensor:
    """delta - dlse as [b*h, sq] fp32: delta = rowsum(do * out), the term
    every column of a row's ds subtracts (ray_tpu/ops/attention.py
    `_flash_bwd`, computed there outside the kernels too).  dlse, the
    cotangent of the lse output, is None when the caller did not use lse
    (zeros)."""
    delta = (dout.float() * out.float()).sum(-1)              # [b, sq, h]
    corr = delta.permute(0, 2, 1).reshape(b * h, sq)
    if dlse is not None:
        corr = corr - dlse.float()
    return corr.contiguous()


def flash_attention_chunk_bwd_plain(q, k, v, out, lse, dout, dlse,
                                    q_off: int, kv_off: int,
                                    causal: bool = True,
                                    sm_scale: Optional[float] = None):
    """The plain PyTorch version of the backward kernels, step by step
    in dense fp32 scores: p = exp(s * scale - lse) selected where the key
    is visible and the row saw a key (lse > -5e29), then
    ds = p * (do v^T - (delta - dlse)) * scale, dq = ds k, dk = ds^T q,
    dv = p^T do, with p rounded to do's dtype and ds to k's / q's dtype
    before the products, as the TPU kernels round them.  Returns
    (dq [b,sq,h,d], dk, dv [b,sk,hk,d]); a GQA group's query heads sum
    into their K/V head."""
    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if dout is None:
        dout = torch.zeros_like(out)
    corr = _bwd_corr(out, dout, dlse, b, h, sq).reshape(b, h, sq, 1)
    ke, ve = k, v
    if hk != h:
        ke = k.repeat_interleave(h // hk, dim=2)
        ve = v.repeat_interleave(h // hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ke.float()) * sm_scale
    rows = int(q_off) + torch.arange(sq, device=q.device)
    cols = int(kv_off) + torch.arange(sk, device=q.device)
    if causal:
        visible = cols[None, :] <= rows[:, None]             # [sq, sk]
    else:
        visible = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    lse4 = lse.reshape(b, h, sq, 1)
    keep = visible[None, None] & (lse4 > _NEG_INF / 2)
    # Selection, not a product with a 0/1 mask: a row with lse = -1e30
    # gives exp(+inf) before the mask.
    p = torch.where(keep, torch.exp(s - lse4),
                    torch.zeros((), device=q.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), ve.float())
    ds = p * (dp - corr) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), ke.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    if hk != h:
        dk = dk.reshape(b, sk, hk, h // hk, d).sum(3)
        dv = dv.reshape(b, sk, hk, h // hk, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_args(q, k, v, lse, dout, corr):
    _check_qkv(q, k, v)
    if q.shape[-1] > 256:
        raise ValueError(f"flash kernel takes head_dim <= 256, got "
                         f"{q.shape[-1]}")
    code = dtype_code(q, k, v, dout)
    return (code, q.contiguous(), k.contiguous(), v.contiguous(),
            dout.contiguous(), lse.float().contiguous(), corr)


def flash_bwd_dq(q, k, v, dout, lse, corr, q_off: int, kv_off: int,
                 causal: bool, sm_scale: float,
                 sm90: Optional[bool] = None) -> torch.Tensor:
    """dq through the kernel `flash_variant` picks (CUDA tensors; corr
    from _bwd_corr).  `sm90=False` forces csrc/flash_bwd.cu, to time it
    beside the Hopper kernel."""
    code, q, k, v, dout, lse, corr = _bwd_args(q, k, v, lse, dout, corr)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    if sm90 is None:
        sm90 = flash_variant(q.dtype, d, _aligned(q, k, v, dout, dq)) == "sm90"
    if b and sq:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), corr.data_ptr(), dq.data_ptr(), b, h, hk, sq,
                sk, d, q_off, kv_off, int(causal), sm_scale)
        if sm90:
            FLASH_BWD_DQ_SM90.launch(q.device, *args)
        else:
            FLASH_BWD_DQ.launch(q.device, *args, code)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, corr, q_off: int, kv_off: int,
                  causal: bool, sm_scale: float,
                  sm90: Optional[bool] = None):
    """(dk, dv) through the kernel `flash_variant` picks (CUDA tensors),
    each K/V head summed over its group of query heads.  `sm90=False`
    forces csrc/flash_bwd.cu, to time it beside the Hopper kernel."""
    code, q, k, v, dout, lse, corr = _bwd_args(q, k, v, lse, dout, corr)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if sm90 is None:
        sm90 = flash_variant(q.dtype, d,
                             _aligned(q, k, v, dout, dk, dv)) == "sm90"
    if b and sk:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), corr.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, h, hk, sq, sk, d, q_off, kv_off,
                int(causal), sm_scale)
        if sm90:
            FLASH_BWD_DKV_SM90.launch(q.device, *args)
        else:
            FLASH_BWD_DKV.launch(q.device, *args, code)
    return dk, dv


def _flash_chunk_bwd_cuda(q, k, v, out, lse, dout, dlse, q_off: int,
                          kv_off: int, causal: bool, sm_scale: float):
    b, sq, h, _ = q.shape
    if dout is None:
        dout = torch.zeros_like(out)
    corr = _bwd_corr(out, dout, dlse, b, h, sq)
    dq = flash_bwd_dq(q, k, v, dout, lse, corr, q_off, kv_off, causal,
                      sm_scale)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, corr, q_off, kv_off, causal,
                           sm_scale)
    return dq, dk, dv


def _flash_chunk_fwd(q, k, v, q_off: int, kv_off: int, causal: bool,
                     sm_scale: float):
    """The forward kernel on CUDA tensors, its plain version on CPU ones."""
    impl = _flash_chunk_cuda if q.is_cuda else flash_attention_chunk_plain
    return impl(q, k, v, q_off, kv_off, causal, sm_scale)


class _FlashChunk(torch.autograd.Function):
    """(out, lse) of one chunk, differentiable in q, k and v through both
    outputs.  CUDA tensors run the forward and backward kernels
    `flash_variant` picks; CPU tensors the plain versions.  `memo`, a
    layer's remat policy (models/remat.py `Remat`) or None, may keep
    (out, lse) under the name `memo_name` ("attn", or "attn@<i>" for a
    ring's step i: ops/ring_attention.py), so that a checkpoint's re-run
    takes them instead of launching the forward again."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, kv_off, causal, sm_scale, memo,
                memo_name):
        def launch():
            return _flash_chunk_fwd(q, k, v, q_off, kv_off, causal,
                                    sm_scale)

        out, lse = launch() if memo is None else memo.run(memo_name, launch)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_off, kv_off, causal, sm_scale)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None and dlse is None:
            return (None,) * 9
        impl = (_flash_chunk_bwd_cuda if q.is_cuda
                else flash_attention_chunk_bwd_plain)
        dq, dk, dv = impl(q, k, v, out, lse, dout, dlse, *ctx.args)
        return (dq, dk, dv) + (None,) * 6


def flash_attention_chunk(q, k, v, q_off, kv_off, causal: bool = True,
                          sm_scale: Optional[float] = None, memo=None,
                          memo_name: str = "attn"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offset-aware flash attention returning (out, lse).

    q_off / kv_off: global position of q[:, 0] / k[:, 0] (ints or 0-d
    tensors).  lse is [b*h, sq] float32; rows with no visible keys get
    out = 0 and lse = -1e30.  CUDA tensors run the kernels
    `flash_variant` picks, CPU tensors the plain versions.
    Both outputs are differentiable; `memo` is a training layer's remat
    policy and `memo_name` the name it keeps (out, lse) under
    (`_FlashChunk`)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    q_off, kv_off = int(q_off), int(kv_off)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashChunk.apply(q, k, v, q_off, kv_off, causal, sm_scale,
                                 memo, memo_name)
    return _flash_chunk_fwd(q, k, v, q_off, kv_off, causal, sm_scale)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    memo=None) -> torch.Tensor:
    """Tiled attention. q:[b,s,h,d], k/v:[b,t,hk,d] -> [b,s,h,d].

    When sq < sk the windows are end-aligned (decode convention),
    matching attention_reference."""
    out, _ = flash_attention_chunk(q, k, v, k.shape[1] - q.shape[1], 0,
                                   causal=causal, sm_scale=sm_scale,
                                   memo=memo)
    return out
