"""Decoder-only transformer (Llama family) in PyTorch.

Port of ray_tpu/models/transformer.py.  Params are a plain dict of
tensors in the reference's pytree layout, block params stacked on a
leading [L, ...] axis, so `params_from_numpy` carries JAX weights across
key for key.  bfloat16 activations, fp32 RMSNorm statistics and logits,
GQA, RoPE and SwiGLU, as in the reference.

Training: `loss_fn` is the reference's next-token cross-entropy, through
the fused chunked CE (ops/fused_ce.py) when `fused_ce=True`, plus
`router_aux_coef * aux / num_layers` for MoE models.  With `remat=True`
each layer runs under torch.utils.checkpoint (non-reentrant) while grad
is enabled, and `remat_policy` says what its forward keeps for the
backward (models/remat.py): "full" the layer input only; "dots" every
activation-by-weight product; "save_attn" the flash kernel's out and
lse; "dots_no_mlp" q, k and v after rope, the flash outputs and the
attention projection.  The port keeps what the reference's policies
document, which is more than they keep: the reference names the flash
residuals inside the kernel's custom_vjp rule, where its checkpoint
policy never sees them, so its "save_attn" and "dots_no_mlp" run the
flash forward again (ROADMAP.md, Queue C).  Under grad the block's
weight products, rope and flash forward go through autograd Functions
whatever the policy, so every policy and none compute the same values.

Mixture-of-experts (`num_experts > 0`) replaces the dense MLP with the
routed experts of models/moe.py (capacity route), whose aux is the
router's load-balance loss summed over layers.

Sequence parallelism: under an ambient mesh (`with mesh:`,
parallel/mesh.py) whose `seq` axis is larger than one, or with
`ring_attention=True`, attention is ring attention over that axis
(ops/ring_attention.py).  `forward_hidden` and `forward` then keep the
reference's contract, global tokens [b, S] in and global tensors out:
each rank embeds its chunk of S/n tokens at their global RoPE positions,
runs the layers with the ring, and the chunks are gathered along `seq`.
`loss_fn` never gathers: it runs the cross-entropy on the rank's chunk
and takes the mean over the (nll sum, count) pair summed over the mesh,
so every rank returns the global loss and its gradient is the rank's
share, which ShardedTrainStep sums over the mesh.  On an `fsdp` axis
the model takes whole params (ShardedTrainStep gathers them) and each
rank runs its rows of the batch.  The other axes (tensor, expert,
stage) and MoE on a mesh of more than one rank raise
NotImplementedError, naming their ROADMAP items.

`logical_axes` names each param's dims for the sharding rules
(parallel/sharding.py), as the reference's does.
With `use_flash=True`, attention on a CUDA device runs the flash kernels
(ops/attention.py); on the CPU it runs their plain versions, as the
reference does off-TPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models.moe import moe_ffn
from ray_tpu_torch.models.remat import Remat, check_policy, linear, run
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.fused_ce import fused_ce_nll
from ray_tpu_torch.ops.ring_attention import (
    gather_axis,
    local_chunk,
    ring_attention_sharded,
)
from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.mesh import (Mesh, current_mesh, one_process_mesh,
                                         require_replicated)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True
    use_flash: bool = True
    # Sequence/context parallelism: ring attention over the mesh "seq"
    # axis (ops/ring_attention.py).  "auto" uses it iff the ambient mesh
    # shards seq; True forces; False never.
    ring_attention: Any = "auto"
    fused_ce: bool = False
    num_experts: int = 0
    num_experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def llama2_7b(cls, **kw) -> "TransformerConfig":
        return cls(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=11008,
            num_layers=32, num_heads=32, num_kv_heads=32, max_seq_len=4096,
        ), **kw})

    @classmethod
    def tiny(cls, **kw) -> "TransformerConfig":
        """Test-sized config."""
        return cls(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
        ), **kw})


def check_supported(c: TransformerConfig) -> None:
    """Raise NotImplementedError for what this slice does not port."""
    if not c.scan_layers:
        raise NotImplementedError(
            "the port keeps block params stacked [L, ...] (scan_layers=True)")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def param_shapes(config: TransformerConfig) -> Dict[str, Any]:
    """{name: shape} in the reference's layout, blocks stacked [L, ...];
    with experts, router [L, h, E] and experts [L, E, h, m] / [L, E, m, h]
    in place of the dense MLP."""
    c = config
    check_supported(c)
    hd, h, m, L = c.head_dim_, c.hidden_size, c.intermediate_size, \
        c.num_layers
    blocks = {
        "attn_norm": (L, h),
        "wq": (L, h, c.num_heads * hd),
        "wk": (L, h, c.num_kv_heads * hd),
        "wv": (L, h, c.num_kv_heads * hd),
        "wo": (L, c.num_heads * hd, h),
        "mlp_norm": (L, h),
    }
    if c.num_experts > 0:
        E = c.num_experts
        blocks.update(router=(L, h, E), we_gate=(L, E, h, m),
                      we_up=(L, E, h, m), we_down=(L, E, m, h))
    else:
        blocks.update(w_gate=(L, h, m), w_up=(L, h, m), w_down=(L, m, h))
    return {"tok_embed": (c.vocab_size, h), "blocks": blocks,
            "final_norm": (h,)}


def init_params(config: TransformerConfig, seed: int = 0, *,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random params: normal / sqrt(fan_in) for matrices, ones for norms,
    drawn from a torch.Generator on `device` seeded with `seed`.

    Stored in `dtype` (default config.param_dtype).  Each matrix is
    drawn one layer at a time in fp32 and cast into its stacked tensor,
    so at most one layer's fp32 copy of one matrix exists at a time.
    Expert tensors [L, E, ...] are drawn one [in, out] matrix at a time.
    The numbers differ from the reference's jax.random draws for the
    same seed; tests carry JAX params across with params_from_numpy."""
    dev = resolve_device(device)
    dtype = dtype or config.param_dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def normal(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=dev)
        mats = out.view(-1, *shape[-2:])  # one [in, out] matrix per entry
        for dst in mats:
            dst.copy_(torch.randn(dst.shape, generator=gen, device=dev)
                      / math.sqrt(fan_in))
        return out

    def build(shapes, name=""):
        if isinstance(shapes, dict):
            return {k: build(v, k) for k, v in shapes.items()}
        if name.endswith("norm"):
            return torch.ones(shapes, dtype=dtype, device=dev)
        # fan_in is the input width: h for the embedding table [vocab, h],
        # the rows of every block matrix [L, (E,) in, out].
        return normal(shapes, shapes[-1] if name == "tok_embed"
                      else shapes[-2])

    return build(param_shapes(config))


def logical_axes(config: TransformerConfig) -> Dict[str, Any]:
    """Logical-axis tree matching init_params, for parallel.sharding rules
    (both of the reference's layouts: stacked [L, ...] blocks with
    scan_layers, one layer's shapes without)."""
    L = ("layers",) if config.scan_layers else ()
    blocks = {
        "attn_norm": L + (None,),
        "wq": L + ("embed", "heads"),
        "wk": L + ("embed", "heads"),
        "wv": L + ("embed", "heads"),
        "wo": L + ("heads", "embed"),
        "mlp_norm": L + (None,),
    }
    if config.num_experts > 0:
        blocks.update({
            "router": L + ("embed", None),
            "we_gate": L + ("expert", "embed", "mlp"),
            "we_up": L + ("expert", "embed", "mlp"),
            "we_down": L + ("expert", "mlp", "embed"),
        })
    else:
        blocks.update({
            "w_gate": L + ("embed", "mlp"),
            "w_up": L + ("embed", "mlp"),
            "w_down": L + ("mlp", "embed"),
        })
    return {
        "tok_embed": ("vocab", "embed"),
        "blocks": blocks,
        "final_norm": (None,),
    }


def params_from_numpy(tree: Dict[str, Any], config: TransformerConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's params (its pytree with numpy leaves, e.g.
    `jax.tree.map(np.asarray, params)`) as the port's dict of tensors on
    `device`, key for key, in their own dtypes."""
    dev = resolve_device(device)
    shapes = param_shapes(config)

    def convert(node, shape):
        if isinstance(shape, dict):
            if set(node) != set(shape):
                raise ValueError(f"param keys {sorted(node)} != "
                                 f"{sorted(shape)}")
            return {k: convert(node[k], shape[k]) for k in shape}
        arr = np.asarray(node)
        if arr.shape != tuple(shape):
            raise ValueError(f"param shape {arr.shape} != {shape}")
        if arr.dtype.name == "bfloat16":  # ml_dtypes: no torch equivalent
            return torch.from_numpy(arr.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(dev)  # writable copy

    return convert(tree, shapes)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """Normalise in fp32, cast back, then scale in the working dtype."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * weight.to(dtype)


def rope_freqs(head_dim: int, max_len: int, theta: float,
               device: DeviceLike = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=dev) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=dev)
    freqs = torch.outer(t, inv)  # [max_len, head_dim // 2]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    # x: [b, s, heads, hd]; cos/sin: [max_len, hd // 2]; positions: [b, s].
    return _rotate(x, cos[positions][:, :, None, :],
                   sin[positions][:, :, None, :])


def _rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor
            ) -> torch.Tensor:
    """Rope with the tables gathered at x's positions ([b, s, 1, hd/2]):
    bf16 x times fp32 c / s computes in fp32, cast back at the end."""
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


class _ProjRope(torch.autograd.Function):
    """rope(y @ w) for q or k (`name`), y [b, s, h], w [h, heads * hd];
    c / s the rope tables gathered at y's positions.  A policy may keep
    the product (`name`) or the rotated value ("attn_" + name); the
    backward needs neither, only y, w and the tables.  Rope's backward
    is the inverse rotation in fp32 with one rounding to the product's
    dtype, as the reference's transpose sums its two cotangents in fp32
    before the cast."""

    @staticmethod
    def forward(ctx, y, w, c, s, heads, memo, name):
        ctx.save_for_backward(y, w, c, s)
        b, n, _ = y.shape

        def rotated():
            pre = run(memo, name, lambda: y @ w)
            return _rotate(pre.view(b, n, heads, -1), c, s)

        return run(memo, "attn_" + name, rotated)

    @staticmethod
    def backward(ctx, g):
        y, w, c, s = ctx.saved_tensors
        g1, g2 = g.float().chunk(2, dim=-1)
        d = torch.cat([g1 * c + g2 * s, g2 * c - g1 * s], dim=-1)
        d = d.to(y.dtype).reshape(-1, w.shape[1])
        dy = dw = None
        if ctx.needs_input_grad[0]:
            dy = (d @ w.t()).view(y.shape)
        if ctx.needs_input_grad[1]:
            dw = y.reshape(-1, y.shape[-1]).t() @ d
        return dy, dw, None, None, None, None, None


def dense_attention(q, k, v, mask, head_dim: int) -> torch.Tensor:
    """Masked softmax attention, q:[b,s,h,hd] k,v:[b,t,kv,hd] (GQA heads
    repeated here), mask broadcastable to [b,h,s,t]; softmax in fp32."""
    h, kv = q.shape[2], k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(
        head_dim))
    logits = logits.float().masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _use_ring(config: TransformerConfig) -> bool:
    if config.ring_attention is True:
        return True
    if config.ring_attention == "auto":
        mesh = current_mesh()
        return mesh is not None and mesh.axis_size("seq") > 1
    return False


def _ring_mesh(config: TransformerConfig) -> Optional[Mesh]:
    """The ambient mesh when attention runs the ring, else None; raises
    for what a mesh of this slice cannot run."""
    mesh = current_mesh()
    if mesh is not None and mesh.size > 1:
        require_replicated(mesh.shape)
        if config.num_experts > 0:
            raise NotImplementedError(
                "MoE on a mesh of more than one rank: the router's aux "
                "loss is not additive over shards; expert parallelism "
                "waits for the expert-parallel slice (ROADMAP Queue A "
                "item 6d)")
    if not _use_ring(config):
        return None
    if mesh is None:
        raise ValueError("ring_attention requires a mesh "
                         "(run under `with mesh:`)")
    return mesh


def _attention(q, k, v, mask, config: TransformerConfig,
               memo: Optional[Remat] = None,
               ring: Optional[Mesh] = None) -> torch.Tensor:
    """q:[b,s,h,hd] k,v:[b,s,kv,hd] causal attention with GQA; with
    `ring` (the mesh `_ring_mesh` gave the forward) q, k and v are this
    rank's chunks of the sequence and attention is the ring over its
    `seq` axis.  The mesh travels as an argument, not as the ambient
    mesh: a checkpoint's re-run happens in the backward, on autograd's
    device thread for CUDA tensors, where no `with mesh:` is entered."""
    if ring is not None:
        return ring_attention_sharded(q, k, v, ring, causal=True, memo=memo)
    if config.use_flash:
        return flash_attention(q, k, v, causal=True, memo=memo)
    return dense_attention(q, k, v, mask, config.head_dim_)


def _block(x, bp, cos, sin, positions, mask, config: TransformerConfig,
           memo: Optional[Remat] = None, ring: Optional[Mesh] = None):
    """One layer; `memo` is the layer's remat policy under checkpoint,
    `ring` the mesh whose `seq` axis attention runs the ring over."""
    c = config
    hd = c.head_dim_
    b, s, _ = x.shape
    y = rms_norm(x, bp["attn_norm"], c.rms_eps)
    cg = cos[positions][:, :, None, :]
    sg = sin[positions][:, :, None, :]
    q = _ProjRope.apply(y, bp["wq"].to(c.dtype), cg, sg, c.num_heads, memo,
                        "q")
    k = _ProjRope.apply(y, bp["wk"].to(c.dtype), cg, sg, c.num_kv_heads,
                        memo, "k")
    v = linear(y, bp["wv"].to(c.dtype), memo, "v").reshape(
        b, s, c.num_kv_heads, hd)
    attn = _attention(q, k, v, mask, c, memo, ring).reshape(b, s,
                                                      c.num_heads * hd)
    x = x + linear(attn, bp["wo"].to(c.dtype), memo, "attn_proj")
    y = rms_norm(x, bp["mlp_norm"], c.rms_eps)
    if c.num_experts > 0:
        out, aux = moe_ffn(
            y.reshape(b * s, -1), bp["router"], bp["we_gate"], bp["we_up"],
            bp["we_down"], num_experts_per_token=c.num_experts_per_token,
            capacity_factor=c.capacity_factor, dtype=c.dtype, memo=memo)
        return x + out.reshape(x.shape), aux
    gate = F.silu(linear(y, bp["w_gate"].to(c.dtype), memo, "gate"))
    up = linear(y, bp["w_up"].to(c.dtype), memo, "up")
    return x + (gate * up) @ bp["w_down"].to(c.dtype), None


def _embed_tokens(params, tokens, c: TransformerConfig) -> torch.Tensor:
    return params["tok_embed"].to(c.dtype)[tokens]


def lm_logits(x: torch.Tensor, tok_embed: torch.Tensor,
              c: TransformerConfig) -> torch.Tensor:
    """x [..., h] against the tied embedding [vocab, h]: fp32 logits from
    operands in the working dtype.  On a CUDA device a bf16 product that
    no gradient flows through goes through the matmul's fp32-output form
    (torch.mm with out_dtype), so no fp32 copy of the [vocab, h] table is
    made; elsewhere, and under autograd (that form has no derivative:
    the unfused cross-entropy's training step), both operands are widened
    to fp32 (exact for bf16 values) and multiplied there."""
    x = x.to(c.dtype)
    w = tok_embed.to(c.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    differentiable = torch.is_grad_enabled() and (x.requires_grad
                                                  or w.requires_grad)
    if x.is_cuda and c.dtype != torch.float32 and not differentiable:
        out = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float().t()
    return out.reshape(*lead, w.shape[0])


def forward_hidden(params: Dict[str, Any], tokens: torch.Tensor,
                   config: TransformerConfig,
                   positions: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed + layer stack + final RMSNorm (no lm head): returns
    (x_normed [b, s, h], moe_aux), moe_aux a zero for dense models.
    Under the ring (module docstring) each rank runs its chunk of the
    sequence and the chunks are gathered along `seq`."""
    c = config
    check_supported(c)
    mesh = _ring_mesh(c)
    if mesh is None:
        return _forward_chunk(params, tokens, c, positions)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x, aux = _forward_chunk(params, local_chunk(tokens, mesh, "seq", 1), c,
                            local_chunk(positions, mesh, "seq", 1), mesh)
    return gather_axis(x, mesh, "seq", 1), aux


def _forward_chunk(params: Dict[str, Any], tokens: torch.Tensor,
                   c: TransformerConfig,
                   positions: Optional[torch.Tensor] = None,
                   ring: Optional[Mesh] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """forward_hidden on this rank's tokens at `positions` (their global
    positions under the ring; 0..s-1 by default), with the ring over
    `ring`'s seq axis when it is given."""
    b, s = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(s, device=dev).expand(b, s)
    x = _embed_tokens(params, tokens, c)
    cos, sin = rope_freqs(c.head_dim_, c.max_seq_len, c.rope_theta,
                          device=dev)
    mask = torch.ones((s, s), dtype=torch.bool, device=dev).tril()[None,
                                                                    None]
    # unbind, not indexing: its backward stacks the layers' gradients
    # once, where a select per layer would add a zero-filled [L, ...]
    # gradient per layer.
    names = list(params["blocks"])
    per_layer = zip(*(params["blocks"][k].unbind(0) for k in names))
    if c.remat:
        check_policy(c.remat_policy)
    remat = c.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for weights in per_layer:
        bp = dict(zip(names, weights))
        if remat:
            memo = Remat(c.remat_policy)
            x, layer_aux = checkpoint(_block, x, bp, cos, sin, positions,
                                      mask, c, memo, ring,
                                      use_reentrant=False)
            memo.replay = True
        else:
            x, layer_aux = _block(x, bp, cos, sin, positions, mask, c,
                                  ring=ring)
        if layer_aux is not None:
            aux = aux + layer_aux
    return rms_norm(x, params["final_norm"], c.rms_eps), aux


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            config: TransformerConfig,
            positions: Optional[torch.Tensor] = None,
            return_aux: bool = False):
    """tokens: [b, s] int → logits [b, s, vocab] (fp32).  With
    return_aux=True also the router's load-balance loss summed over
    layers (zero for dense models)."""
    x, aux = forward_hidden(params, tokens, config, positions)
    logits = lm_logits(x, params["tok_embed"], config)
    if return_aux:
        return logits, aux
    return logits


def _token_nll(params, inputs, targets, config: TransformerConfig,
               positions: Optional[torch.Tensor] = None,
               ring: Optional[Mesh] = None):
    """(nll [b, s] fp32, moe aux) of next-token prediction, fused or not."""
    x, aux = _forward_chunk(params, inputs, config, positions, ring)
    if config.fused_ce:
        b, s = inputs.shape
        nll = fused_ce_nll(x.reshape(b * s, -1), params["tok_embed"],
                           targets.reshape(-1))
        return nll.view(b, s), aux
    logp = torch.log_softmax(lm_logits(x, params["tok_embed"], config),
                             dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0], aux


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            config: TransformerConfig) -> torch.Tensor:
    """Next-token cross-entropy, fp32, plus the router's load-balance loss
    for MoE models (`router_aux_coef` times its mean over layers).
    batch: {"tokens": [b, s+1]} and an optional {"mask": [b, s+1]} (the
    cross-entropy averages over mask[:, 1:], with a denominator of at
    least 1; the aux term covers every token).

    On a mesh (the ambient one, else this process alone) the
    cross-entropy runs on this rank's rows and, under the ring, its
    chunk of the sequence at their global positions, never gathered.
    The (nll sum, count) pair is summed over the whole mesh, so every
    rank returns the global mean, bit for bit the same; its gradient is
    this rank's share (its own sum over the global count), which the
    step sums over the mesh.  Without the ring every seq rank runs the
    whole sequence, and the sum counts it once per rank in both terms."""
    check_supported(config)
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:]
    ring = _ring_mesh(config) is not None
    mesh = current_mesh() or one_process_mesh()
    b, s = inputs.shape
    n = mesh.axis_size("seq") if ring else 1
    if s % n:
        raise ValueError(f"sequence of {s} tokens does not split over {n} "
                         "seq ranks")
    s_loc = s // n
    off = mesh.axis_index("seq") * s_loc if ring else 0
    positions = (off + torch.arange(s_loc, device=inputs.device)).expand(
        b, s_loc)
    nll, aux = _token_nll(params, inputs[:, off:off + s_loc],
                          targets[:, off:off + s_loc], config, positions,
                          mesh if ring else None)
    if mask is None:
        local = nll.sum()
        count = torch.tensor(float(nll.numel()), device=nll.device)
    else:
        m = mask[:, off:off + s_loc].to(nll.dtype)
        local = (nll * m).sum()
        count = m.sum().detach()
    pair = comm.all_reduce_(torch.stack([local.detach(), count]),
                            mesh.get_group())
    total = pair[1].clamp_min(1)
    # The value is the global mean exactly (local - local is 0); the
    # gradient flows through this rank's own sum.
    ce = pair[0] / total + (local - local.detach()) / total
    if config.num_experts > 0:
        # MoE runs on one rank only (_ring_mesh).
        ce = ce + config.router_aux_coef * aux / config.num_layers
    return ce


def num_params(config: TransformerConfig) -> int:
    c = config
    hd = c.head_dim_
    per_layer = (c.hidden_size * (c.num_heads * hd)
                 + 2 * c.hidden_size * (c.num_kv_heads * hd)
                 + (c.num_heads * hd) * c.hidden_size
                 + 3 * c.hidden_size * c.intermediate_size
                 + 2 * c.hidden_size)
    return (c.vocab_size * c.hidden_size + c.num_layers * per_layer
            + c.hidden_size)


def flops_per_token(config: TransformerConfig, seq_len: int) -> float:
    """Approximate forward+backward FLOPs/token (6ND + attention).  As in
    the reference, N counts a dense FFN once (`num_params`): for an MoE
    model the experts and the router are left out."""
    n = num_params(config) - config.vocab_size * config.hidden_size
    attn = 12 * config.num_layers * config.hidden_size * seq_len
    return 6 * n + attn
