"""Fused cross-entropy over a chunked vocabulary projection.

Port of ray_tpu/ops/fused_ce.py.  `fused_ce_nll(x, w, targets)` gives the
per-token NLL of a tied lm head without the fp32 [tokens, vocab] logits:
the forward walks vocab chunks keeping only the running log-sum-exp and
the target logit ([tokens] fp32 each); the backward recomputes each
chunk's logits to form (softmax - onehot) and accumulates dx and dw
chunk by chunk.  Peak extra memory is one [tokens, chunk] fp32 tile.

As the reference: x is rounded to bf16; logits are fp32 products of bf16
operands (on a CUDA device through the matmul's fp32-output form, so no
fp32 copy of an operand is made; on the CPU both operands are widened to
fp32, exact for bf16 values); dlogits are rounded to bf16 before the two
backward products; dw comes back in w's dtype (the fp32 master).  These
are plain products, left to torch.mm as the reference leaves them to XLA.

Vocabulary parallel (the tied embedding's rows split over the `tensor`
axis of a mesh `tp`, `w` the rank's [V/t, h] block of rows): the
forward walks the block's chunks, then combines the running max (an
all-reduce of the max), the sum of exponentials rescaled to it and the
target logit (zero unless the target is in the block; one all-reduce
of the sum of both) into the global log-sum-exp and target logit; the
backward recomputes the block's logits against the global log-sum-exp,
with the same rounding points, and returns the block's dw and the
block's share of dx (the caller sums it over `tensor`: x enters
through `comm.copy_to_tensor`).  `vocab_parallel_nll` is the same on
the unfused path's whole [.., V/t] fp32 logits, differentiable.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import comm


def _pick_chunks(vocab: int, target: int = 4096) -> int:
    """Largest chunk count <= vocab/target that divides vocab."""
    n = max(1, vocab // target)
    while vocab % n:
        n -= 1
    return n


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 a @ b of bf16 operands."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunks(w: torch.Tensor):
    V = w.shape[0]
    C = V // _pick_chunks(V)
    for base in range(0, V, C):
        yield base, w[base:base + C].to(torch.bfloat16)


class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, tp):
        T = x.shape[0]
        xb = x.to(torch.bfloat16)
        m = torch.full((T,), float("-inf"), device=x.device)
        s = torch.zeros((T,), device=x.device)
        tgt = torch.zeros((T,), device=x.device)
        for base, wc in _chunks(w):
            logits = _mm(xb, wc.t())                          # [T, C] fp32
            C = logits.shape[1]
            new_m = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - new_m) + torch.exp(
                logits - new_m[:, None]).sum(dim=1)
            m = new_m
            in_chunk = (targets >= base) & (targets < base + C)
            idx = (targets - base).clamp(0, C - 1)
            tl = logits.gather(1, idx[:, None])[:, 0]
            tgt = torch.where(in_chunk, tl, tgt)
        if tp is not None:
            m_all = comm.reduced(m, tp, dist.ReduceOp.MAX)
            s, tgt = comm.reduced(torch.stack([s * torch.exp(m - m_all),
                                               tgt]), tp)
            m = m_all
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, targets, lse)
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        xb = x.to(torch.bfloat16)
        row_g = g.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dws = []
        for base, wc in _chunks(w):
            logits = _mm(xb, wc.t())
            C = logits.shape[1]
            p = torch.exp(logits - lse[:, None])
            in_chunk = (targets >= base) & (targets < base + C)
            idx = (targets - base).clamp(0, C - 1)
            onehot = torch.zeros_like(p).scatter_(
                1, idx[:, None], in_chunk[:, None].float())
            dl16 = ((p - onehot) * row_g[:, None]).to(torch.bfloat16)
            dx += _mm(dl16, wc)
            dws.append(_mm(dl16.t(), xb))
        dw = torch.cat(dws).to(w.dtype)
        return dx.to(x.dtype), dw, None, None


def fused_ce_nll(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                 tp=None) -> torch.Tensor:
    """Per-token NLL of a tied lm head without full logits.

    x:       [T, h]  final-norm hidden states (rounded to bf16)
    w:       [V, h]  vocab projection (the tied embedding; any dtype), or
             with a mesh `tp` the rank's block of rows on its `tensor`
             axis (module docstring)
    targets: [T] integer (global vocabulary ids)
    Returns [T] fp32 NLL; callers apply their own mask/mean."""
    return _FusedCE.apply(x, w, targets.long() - _vocab_start(w.shape[0], tp),
                          tp)


def _vocab_start(n: int, tp) -> int:
    """The first vocabulary id of the rank's block of `n` on `tp`'s
    `tensor` axis; 0 for tp=None."""
    return 0 if tp is None else tp.axis_index("tensor") * n


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       tp) -> torch.Tensor:
    """-log softmax at `targets` of logits split over the `tensor` axis
    of mesh `tp`: `logits` [..., V/t] fp32 the rank's block of columns,
    `targets` [...] global ids.  lse = max + log(sum of exp(logits -
    max)) with the max and sums over `tensor`, minus the target's logit
    (from the rank that holds it); differentiable in `logits` (the max
    as a constant, as in log_softmax's own gradient)."""
    n = logits.shape[-1]
    m = comm.reduced(logits.amax(dim=-1), tp, dist.ReduceOp.MAX)
    local = targets - _vocab_start(n, tp)
    inside = (local >= 0) & (local < n)
    tl = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    sums = comm.reduce_from_tensor(torch.stack([
        torch.exp(logits - m[..., None]).sum(dim=-1),
        torch.where(inside, tl, 0.0)]), tp)
    return m + torch.log(sums[0]) - sums[1]
