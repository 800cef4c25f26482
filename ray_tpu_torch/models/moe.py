"""Mixture-of-experts feed-forward: top-k routing over E SwiGLU experts.

Port of ray_tpu/models/moe.py, on one device (the reference's sharding
constraints place experts on a mesh axis; expert parallelism is a later
slice).  Two routes, as in the reference:

  - `moe_ffn`: the capacity route (Switch / GShard), for prefill, chunks,
    packed waves and verification.  Each expert takes at most
    `capacity = max(1, ceil(k * T / E * capacity_factor))` (token, slot)
    pairs in the flattened [k, T] priority order (slot 0 of every token
    before slot 1); pairs past it, and rows that `valid` marks False, get
    gate 0.  Returns the router's load-balance loss beside the output.
  - `moe_ffn_gather`: the exact route for decode steps (T = live slots),
    where nothing is dropped.

Both route in fp32 with the matmul kept out of TF32, since a routing flip
changes a token's output entirely.  Neither waits on the card: there is
no nonzero, item() or boolean-mask indexing, one-hots are comparisons with
an arange, and every shape follows from the inputs' shapes, so a decode
step or a packed wave can be captured or dispatched without a sync.

In training the router's two backward products (of `_route`'s product,
models/remat.py `_Product`) run outside that context, at the process's
`torch.backends.cuda.matmul.allow_tf32`, which PyTorch leaves False:
full fp32 unless a caller turns TF32 on.  A gradient takes no discrete
decision, so TF32 there would round it, not flip it.

The reference's one-hot dispatch and combine einsums become index forms
with the same values: dispatch copies each kept pair's token into its
(expert, position) slot of an [E, C, h] buffer, and combine sums each
token's at most k kept outputs, each times its gate rounded to the
compute dtype.  The buffer holds min(capacity, T) positions per expert:
an expert takes at most one pair per token, so positions past T are
never filled and a larger capacity drops nothing more.

Gradients flow through the index forms as through the reference's
einsums: the dispatch gather's backward adds each slot's gradient into
its token's row (a token fills at most k slots; empty slots read the
zero row and add into it); a dropped pair reads slot 0 with gate 0, so
it adds nothing to that slot and its gate's gradient is 0; the combine's
gate is rounded to the compute dtype, so its gradient is too, as the
reference's bf16 combine einsum rounds it; the top-k renormalisation
and the aux's mean probabilities are differentiable, the aux's top-1
fractions (a one-hot) are not.  Under a remat policy the capacity route
runs again in the backward from the same inputs through the same
kernels, so the routing cannot change there.

`moe_ffn_gather` does not gather weights: gathering each slot's k expert
matrices, as the reference does ([T, k, h, m] per matrix; 11 GB per
layer and step at 16 slots and Mixtral-8x7B widths), is kept as
`moe_ffn_gather_plain`, the CPU tests' and the card checks' reference.
Instead every expert runs on every token as one batched product over
[E, T, h] x [E, h, m], and each token's k chosen outputs are combined as
in the plain form.  That reads each expert's weights once; the outputs
of experts a token did not choose are computed and never read.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.remat import Remat, linear


@contextlib.contextmanager
def _full_fp32_matmul():
    """fp32 matmuls in full precision on a CUDA device (TF32 off), the
    previous setting restored after."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = saved


def _route(x: torch.Tensor, router_w: torch.Tensor, k: int,
           memo: Optional[Remat] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of both routes: (probs [T, E] fp32, gates [T, k] fp32
    renormalized to sum 1 (at least 1e-9), experts [T, k] int64 in
    descending probability).  `memo`: a training layer's remat policy,
    which may keep the logits ("router")."""
    with _full_fp32_matmul():
        logits = linear(x.float(), router_w.float(), memo, "router")
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, experts


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.int32) -> torch.Tensor:
    """[..., n] one-hot of idx by comparison with an arange (F.one_hot
    validates its input on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _combine(outs: torch.Tensor, gates: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """sum_j gates[t, j] * outs[t, j] over a token's k outputs [T, k, h]:
    the gate rounded to `dtype` first, products and sum in fp32 (the
    reference's einsum accumulates in fp32), one rounding to `dtype`."""
    g = gates.to(dtype).float()
    return (outs.float() * g[..., None]).sum(dim=1).to(dtype)


def _swiglu(xin: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Every expert on its rows: xin [E, N, h] -> [E, N, h]."""
    gate = F.silu(torch.bmm(xin, w_gate.to(dtype)))
    up = torch.bmm(xin, w_up.to(dtype))
    return torch.bmm(gate * up, w_down.to(dtype))


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *,
            num_experts_per_token: int = 2, capacity_factor: float = 1.25,
            dtype: torch.dtype = torch.bfloat16,
            valid: Optional[torch.Tensor] = None,
            memo: Optional[Remat] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward on flattened tokens, the capacity route.

    x: [T, h]; router_w: [h, E]; w_gate / w_up: [E, h, m]; w_down:
    [E, m, h].  valid: optional [T] bool; False rows (pad tokens) claim
    no capacity and get no output.  T counts pad rows, so the capacity
    depends on the batch's shape, as in the reference.  memo: a training
    layer's remat policy (models/remat.py).  Returns (out [T, h] in x's
    dtype, aux fp32 scalar)."""
    T, h = x.shape
    E = router_w.shape[-1]
    k = num_experts_per_token
    capacity = max(1, int(math.ceil(k * T / E * capacity_factor)))
    probs, gates, experts = _route(x, router_w, k, memo)

    # Load-balance loss on every token, before capacity and `valid`.
    frac = _one_hot(experts[:, 0], E, torch.float32).mean(dim=0)
    aux = E * (frac * probs.mean(dim=0)).sum()

    # Position of each pair in its expert's buffer: the running count of
    # earlier pairs routed there, in the flattened [k, T] order; pad rows
    # are taken out before the count.
    onehot = _one_hot(experts.t().reshape(-1), E)                # [kT, E]
    if valid is not None:
        onehot = onehot * valid.to(torch.int32).repeat(k)[:, None]
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    keep = pos < capacity
    pos = torch.where(keep, pos, 0)
    keep = keep.reshape(k, T).t()                                # [T, k]
    pos = pos.reshape(k, T).t()
    if valid is not None:
        keep = keep & valid[:, None]
    gates = gates * keep

    # Dispatch: each kept pair's token into its expert's slot; slots no
    # pair fills read a zero row (index T), dropped pairs write a spare
    # slot that is cut off.
    C = min(capacity, T)
    slot = torch.where(keep, experts * C + pos, E * C)           # [T, k]
    token = torch.arange(T, device=x.device)[:, None].expand(T, k)
    src = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    src.scatter_(0, slot.reshape(-1), token.reshape(-1))
    xz = torch.cat([x.to(dtype), x.new_zeros((1, h), dtype=dtype)])
    out_e = _swiglu(xz[src[:-1]].view(E, C, h), w_gate, w_up, w_down,
                    dtype).view(E * C, h)

    # Combine: dropped pairs read slot 0 of their expert with gate 0.
    out = _combine(out_e[experts * C + pos], gates, dtype)
    return out.to(x.dtype), aux


def moe_ffn_gather_plain(x: torch.Tensor, router_w: torch.Tensor,
                         w_gate: torch.Tensor, w_up: torch.Tensor,
                         w_down: torch.Tensor, *,
                         num_experts_per_token: int = 2,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """The exact route as the reference computes it: each token's k
    expert matrices gathered ([T, k, h, m]).  Reference for
    `moe_ffn_gather`; too large for a decode step at full width."""
    _, gates, experts = _route(x, router_w, num_experts_per_token)
    xin = x.to(dtype)
    g = F.silu(torch.einsum("th,tkhm->tkm", xin, w_gate[experts].to(dtype)))
    u = torch.einsum("th,tkhm->tkm", xin, w_up[experts].to(dtype))
    outs = torch.einsum("tkm,tkmh->tkh", g * u, w_down[experts].to(dtype))
    return _combine(outs, gates, dtype).to(x.dtype)


def moe_ffn_gather(x: torch.Tensor, router_w: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, *, num_experts_per_token: int = 2,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The exact (capacity-free) route for decode steps: every expert on
    every token, batched, then each token's k chosen outputs combined.
    x: [T, h]; returns [T, h] in x's dtype."""
    T, h = x.shape
    E = router_w.shape[-1]
    _, gates, experts = _route(x, router_w, num_experts_per_token)
    xin = x.to(dtype)[None].expand(E, T, h)
    out_e = _swiglu(xin, w_gate, w_up, w_down, dtype)            # [E, T, h]
    outs = out_e[experts, torch.arange(T, device=x.device)[:, None]]
    return _combine(outs, gates, dtype).to(x.dtype)
