"""Ring attention: exact causal attention over a sequence-sharded mesh axis.

Port of ray_tpu/ops/ring_attention.py.  Each rank of the `seq` axis holds
a query chunk and a K/V chunk; K/V travel one rank along the ring per
step while the chunks' (out, lse) merge by logsumexp, so the s x s score
matrix never exists.  Every step's chunk op is the offset-aware flash
kernel (ops/attention.py `flash_attention_chunk`, its plain version on
CPU tensors) at the chunk's global positions: a past chunk sees every
key, a future one none (out 0, lse -1e30, merged with weight 0).  Every
step is launched, a fully masked one too, as the reference launches it.

Where the reference moves K and V with `jax.lax.ppermute` inside
shard_map, here ranks are torch.distributed processes and the rotation
is one autograd Function (`_Rotate`): forward sends to the next rank of
the ring and receives from the previous one, backward sends the
gradient the other way (ppermute's transpose).  K and V move in one
call, so every rank's backward is one chain of P2P ops in the same
order, also when a checkpoint re-runs the forward.  The transport
follows from the group's backend (parallel/comm.py).

GQA: the reference expands the K/V heads before the ring; the port's
kernels read KVH < H heads directly, so the ring rotates the
unexpanded K/V, H/KVH times fewer bytes, with equal values.

Two entry points:
  - `ring_attention_sharded(q, k, v, mesh, causal, ...)`: this rank's
    chunks in, its chunk of the output out;
  - `ring_attention(q, k, v, mesh=None, causal=True)`: global [b, s, h,
    d] tensors, the same on every rank, in and out; the ambient mesh
    when `mesh` is None.

Layout: q, k, v are [batch, seq, heads, head_dim].
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops.attention import _NEG_INF, flash_attention_chunk
from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.mesh import Mesh, current_mesh


def _merge(o1, l1, o2, l2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two partial attention results by their logsumexps, in fp32:
    o [b, q, h, d], l [b, h, q]; an lse at or below -5e29 (the kernels'
    -1e30 sentinel) carries no weight."""
    l_max = torch.maximum(l1, l2)
    neg = l_max <= _NEG_INF / 2
    l_max_safe = torch.where(neg, torch.zeros_like(l_max), l_max)
    w1 = torch.exp(l1 - l_max_safe)
    w2 = torch.exp(l2 - l_max_safe)
    denom = (w1 + w2).clamp_min(1e-30)

    def bc(w):  # [b, h, q] onto [b, q, h, d]
        return w.permute(0, 2, 1)[..., None]

    out = (o1 * bc(w1) + o2 * bc(w2)) / bc(denom)
    lse = torch.where(neg, torch.full_like(l_max, _NEG_INF),
                      l_max_safe + torch.log(denom))
    return out, lse


def _shift(tensors, send_to, recv_from, mesh: Mesh, seq_axis: str):
    """comm.shift over `seq_axis`, counted in `mesh.rotations`: calls,
    bytes sent and host seconds (a gloo-host shift stages through the
    host synchronously)."""
    t0 = time.perf_counter()
    out = comm.shift(tensors, send_to, recv_from, mesh.get_group(seq_axis))
    tally = mesh.rotations
    tally["calls"] += 1
    tally["bytes"] += sum(t.nbytes for t in tensors)
    tally["seconds"] += time.perf_counter() - t0
    return out


class _Rotate(torch.autograd.Function):
    """(k, v) of the previous rank of the ring, this rank's sent to the
    next; the backward sends the gradients back the other way."""

    @staticmethod
    def forward(ctx, k, v, nxt, prv, mesh, seq_axis):
        ctx.peers = (nxt, prv, mesh, seq_axis)
        return _shift((k, v), nxt, prv, mesh, seq_axis)

    @staticmethod
    def backward(ctx, dk, dv):
        nxt, prv, mesh, seq_axis = ctx.peers
        dk, dv = _shift((dk.contiguous(), dv.contiguous()), prv, nxt, mesh,
                        seq_axis)
        return dk, dv, None, None, None, None


def _ring(mesh: Optional[Mesh], seq_axis: str):
    """(n, my, next rank, previous rank) of this rank's ring."""
    if mesh is None or mesh.axis_size(seq_axis) == 1:
        return 1, 0, None, None
    ranks = mesh.axis_ranks(seq_axis)
    n, my = len(ranks), mesh.axis_index(seq_axis)
    return n, my, ranks[(my + 1) % n], ranks[(my - 1) % n]


def ring_attention_sharded(q, k, v, mesh: Optional[Mesh] = None,
                           causal: bool = True,
                           sm_scale: Optional[float] = None,
                           seq_axis: str = "seq", memo=None) -> torch.Tensor:
    """This rank's output chunk: q [b, s_loc, h, d] and k, v [b, s_loc,
    kvh, d] (kvh dividing h) are this rank's chunks of the sequence,
    rank i of `seq_axis` holding positions [i * s_loc, (i + 1) * s_loc).

    `memo`, a training layer's remat policy, keeps step i's (out, lse)
    under "attn@<i>" (step 0's under "attn").  The rotations are counted
    in `mesh.rotations`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n, my, nxt, prv = _ring(mesh, seq_axis)
    b, s_loc, h, d = q.shape
    o = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s_loc), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        # After `step` rotations this rank holds the chunk that started
        # on rank (my - step) mod n.
        src = (my - step) % n
        o_c, lse_c = flash_attention_chunk(
            q, k_cur, v_cur, my * s_loc, src * s_loc, causal=causal,
            sm_scale=sm_scale, memo=memo,
            memo_name="attn" if step == 0 else f"attn@{step}")
        o, lse = _merge(o, lse, o_c.float(), lse_c.view(b, h, s_loc))
        if step != n - 1:
            k_cur, v_cur = _Rotate.apply(k_cur, v_cur, nxt, prv, mesh,
                                         seq_axis)
    return o.to(q.dtype)


class _Gather(torch.autograd.Function):
    """The chunks of every rank of an axis, concatenated along `dim` in
    axis order.  The backward takes this rank's slice of the gradient:
    right when every rank computes the same function of the gathered
    tensor (a loss replicated over the axis), whose gradients then sum
    over the ranks to the whole one."""

    @staticmethod
    def forward(ctx, x, ranks, index, group, dim):
        ctx.args = (index, x.shape[dim], dim)
        return comm.all_gather(x, ranks, group, dim)

    @staticmethod
    def backward(ctx, g):
        index, n, dim = ctx.args
        return g.narrow(dim, index * n, n), None, None, None, None


def gather_axis(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
                dim: int) -> torch.Tensor:
    """`_Gather` over `axis` of `mesh` (x itself on an axis of size 1)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    return _Gather.apply(x, mesh.axis_ranks(axis), mesh.axis_index(axis),
                         mesh.get_group(axis), dim)


def local_chunk(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
                dim: int) -> torch.Tensor:
    """This rank's chunk of `x` along `dim`, split over `axis`."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {n} ranks of {axis!r}")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * size, size)


def ring_attention(q, k, v, mesh: Optional[Mesh] = None, causal: bool = True,
                   seq_axis: str = "seq",
                   batch_axes: Tuple[str, ...] = ("data",)) -> torch.Tensor:
    """Ring attention on global tensors: q [b, s, h, d], k, v [b, s, kvh,
    d], the same on every rank.  Each rank takes its rows of
    `batch_axes` and its chunk of `seq_axis`, runs the ring, and the
    chunks are gathered back, so every rank returns the global output.
    The gradient each rank gets for q, k and v covers its own rows and
    chunk (`_Gather`): summed over the ranks it is the whole one."""
    if mesh is None:
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("ring_attention requires a mesh "
                             "(pass mesh= or run under `with mesh:`)")
    for a in batch_axes:
        q, k, v = (local_chunk(t, mesh, a, 0) for t in (q, k, v))
    q, k, v = (local_chunk(t, mesh, seq_axis, 1) for t in (q, k, v))
    out = ring_attention_sharded(q, k, v, mesh, causal=causal,
                                 seq_axis=seq_axis)
    out = gather_axis(out, mesh, seq_axis, 1)
    for a in reversed(batch_axes):
        out = gather_axis(out, mesh, a, 0)
    return out
