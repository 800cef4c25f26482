"""Autoregressive decoding over a paged KV cache.

Port of ray_tpu/models/decoding.py.  `prefill` writes a prompt's K/V into
pages, `decode_step` advances every active sequence one token with paged
attention, and `prefill_with_context` processes a prompt suffix whose
prefix already lives in the pages (prefix caching).  The engine's other
modes run on the rest:

  - `decode_multi_step`: n greedy steps with no host read between them
    (stop rules for EOS and each slot's limit), returning the chained
    state; `merge_slot_state` folds host-side slot changes into that
    state in place;
  - `packed_prefill_admit`: many prompt segments of one bucket in one
    call, their first greedy tokens folded into the decode state;
  - `verify_step`: logits at every position of [last token, draft...]
    (speculative decoding);
  - `gather_kv_pages` / `splice_kv_pages`: a request's pages out of one
    cache and into another (KV handoff).

JAX donated the cache to each call; here each call writes the cache
tensors in place, through the flat [L*P, page, KD] view of the
[L, P, page, KD] cache (a view, never a copy, so the kernels' writes land
in the caller's cache).  Functions still return (logits, cache), the
cache being the same dict, so callers and tests read like the reference.
Where the reference scatters with mode="drop" (pad rows, unused wave
segments), the port writes to the scratch page or selects per slot, so
that no call waits on the card.

The rope tables are built once per (head dim, max_seq_len, theta,
device) and shared (`rope_tables`), so that a captured decode step reads
them and rebuilds nothing (models/decode_graph.py).

Numerics mirror models/transformer.py `forward` (same rms_norm / rope /
projection order), so greedy decode reproduces the full forward's argmax
token for token (with experts: where the capacity route drops nothing).
On a CUDA device prefill attention runs the flash kernel, and decode the
rotating row-write kernel (rotary embedding and K/V row write, one launch
per layer) and the paged-attention kernel; on the CPU prefill attention
is the dense masked softmax the reference runs off-TPU.  MoE layers
follow the reference's `_mlp`: a decode step takes the exact route
(models/moe.py `moe_ffn_gather`: no weight gather, no sync), every other
call the capacity route with pad rows kept out of routing.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models.moe import moe_ffn, moe_ffn_gather
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_rope,
    check_supported,
    dense_attention,
    lm_logits,
    rms_norm,
    rope_freqs,
)
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.paged_attention import (
    paged_attention,
    rope_write_token_rows,
    write_page_tokens,
)
from ray_tpu_torch.util import device_stats

Cache = Dict[str, torch.Tensor]
_ROPE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _prefill_attention(q, k, v, positions, c: TransformerConfig):
    """Segment-local causal attention for prefill bodies.  q/k/v:
    [B, S, H|KVH, D].  CUDA: the flash kernel, causal by row index, which
    equals the position mask because prefill positions are an arange
    prefix followed by -1 pads (a valid query never sees a pad key; pad
    queries' outputs are never read).  CPU: the dense masked softmax with
    the position mask, as the reference runs it off-TPU."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=True)
    q_pos = positions[:, :, None]
    k_pos = positions[:, None, :]
    mask = (k_pos >= 0) & (q_pos >= 0) & (k_pos <= q_pos)
    return dense_attention(q, k, v, mask[:, None], c.head_dim_)


def init_kv_pages(config: TransformerConfig, num_pages: int,
                  page_size: int, device: DeviceLike = None) -> Cache:
    """Paged KV cache for all layers, fused-head rows:
    [L, P, page, KVH * head_dim], zeros in config.dtype.  L and P are
    adjacent, so layer l's page p is flat page l*P + p of the
    [L*P, page, KD] view."""
    c = config
    dev = resolve_device(device)
    shape = (c.num_layers, num_pages, page_size,
             c.num_kv_heads * c.head_dim_)
    return {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
            "v": torch.zeros(shape, dtype=c.dtype, device=dev)}


def _layer_params(params: Dict[str, Any], l: int) -> Dict[str, torch.Tensor]:
    """Blocks are stacked [L, ...]; layer l's params (views)."""
    return {k: v[l] for k, v in params["blocks"].items()}


def _flat_cache(cache: Cache) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """The [L, P, page, KD] cache as [L*P, page, KD] views (`view`
    raises rather than copy), so writes through them update `cache`."""
    L, P = cache["k"].shape[:2]
    rest = cache["k"].shape[2:]
    return (cache["k"].view(L * P, *rest), cache["v"].view(L * P, *rest),
            L, P)


def _project(x, bp, c: TransformerConfig):
    """Q/K/V projections ([B, S, heads, hd]), not yet rotated."""
    b, s, _ = x.shape
    hd = c.head_dim_
    y = rms_norm(x, bp["attn_norm"], c.rms_eps)
    q = (y @ bp["wq"].to(c.dtype)).reshape(b, s, c.num_heads, hd)
    k = (y @ bp["wk"].to(c.dtype)).reshape(b, s, c.num_kv_heads, hd)
    v = (y @ bp["wv"].to(c.dtype)).reshape(b, s, c.num_kv_heads, hd)
    return q, k, v


def _project_qkv(x, bp, positions, cos, sin, c: TransformerConfig):
    """Shared prefill Q/K/V computation ([B, S, ...]): the projections,
    q and k rotated at max(position, 0).  Decode rotates inside the row
    write instead (`_decode_one`)."""
    q, k, v = _project(x, bp, c)
    safe_pos = positions.clamp_min(0)
    q = apply_rope(q, cos, sin, safe_pos)
    k = apply_rope(k, cos, sin, safe_pos)
    return q, k, v


def _mlp(x, bp, c: TransformerConfig, positions=None):
    """The MLP block with its residual.  With experts, the reference's
    rule: a decode step (S == 1) takes the exact route, whatever the
    caller (a capacity cutoff over the slots could drop a live
    sequence's token); every other call the capacity route, with pad
    rows (positions < 0) kept out of routing."""
    y = rms_norm(x, bp["mlp_norm"], c.rms_eps)
    if c.num_experts > 0:
        B, S, h = x.shape
        y2d = y.reshape(B * S, h)
        if S == 1:
            out = moe_ffn_gather(
                y2d, bp["router"], bp["we_gate"], bp["we_up"],
                bp["we_down"], num_experts_per_token=c.num_experts_per_token,
                dtype=c.dtype)
        else:
            valid = (positions.reshape(-1) >= 0
                     if positions is not None else None)
            out, _ = moe_ffn(
                y2d, bp["router"], bp["we_gate"], bp["we_up"], bp["we_down"],
                num_experts_per_token=c.num_experts_per_token,
                capacity_factor=c.capacity_factor, dtype=c.dtype,
                valid=valid)
        return x + out.reshape(B, S, h)
    gate = F.silu(y @ bp["w_gate"].to(c.dtype))
    up = y @ bp["w_up"].to(c.dtype)
    return x + (gate * up) @ bp["w_down"].to(c.dtype)


def _lm_head(x, params, c: TransformerConfig) -> torch.Tensor:
    """Final norm + tied head: fp32 logits from working-dtype operands."""
    return lm_logits(rms_norm(x, params["final_norm"], c.rms_eps),
                     params["tok_embed"], c)


def _last_valid(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Each row's hidden state at its last valid (max) position."""
    last = torch.argmax(positions, dim=1)
    return x[torch.arange(x.shape[0], device=x.device), last]


def rope_tables(config: TransformerConfig, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (cos, sin) tables of `config` on `device` (a tensor's device,
    so that CUDA devices carry their index), built at the first call and
    returned by every later one."""
    key = (config.head_dim_, config.max_seq_len, config.rope_theta, device)
    tables = _ROPE.get(key)
    if tables is None:
        tables = _ROPE[key] = rope_freqs(config.head_dim_,
                                         config.max_seq_len,
                                         config.rope_theta, device=device)
    return tables


def _start(config: TransformerConfig, tokens: torch.Tensor, params):
    check_supported(config)
    x = params["tok_embed"].to(config.dtype)[tokens]
    cos, sin = rope_tables(config, tokens.device)
    return x, cos, sin


def prefill(params, tokens, positions, cache: Cache, block_tables,
            config: TransformerConfig) -> Tuple[torch.Tensor, Cache]:
    """Process a (padded) prompt, writing its K/V into pages.

    tokens: [B, S] int (pad with anything); positions: [B, S] absolute
    positions, -1 on padding (pad K/V writes are dropped and pad queries
    masked); block_tables: [B, W].  Returns (logits at each row's LAST
    valid position [B, vocab] fp32, cache written in place)."""
    c = config
    B, S = tokens.shape
    x, cos, sin = _start(c, tokens, params)
    ck, cv, L, P = _flat_cache(cache)
    for l in range(c.num_layers):
        bp = _layer_params(params, l)
        q, k, v = _project_qkv(x, bp, positions, cos, sin, c)
        write_page_tokens(ck, cv, k, v, block_tables + l * P, positions)
        attn = _prefill_attention(q, k, v, positions, c)
        x = x + attn.reshape(B, S, -1) @ bp["wo"].to(c.dtype)
        x = _mlp(x, bp, c, positions)
    return _lm_head(_last_valid(x, positions), params, c), cache


def _chunk_forward(params, tokens, positions, cache: Cache, block_tables,
                   c: TransformerConfig) -> Tuple[torch.Tensor, Cache]:
    """Shared body of chunked prefill and speculative verification:
    process a token chunk whose PRIOR context already lives in this
    sequence's pages: write the chunk's K/V, then attend to the full
    context through a page gather.  Returns (x [B, S, h], cache).

    The gather covers the whole table width; slots past the written
    region (or a stale tenant's rows) carry k_pos > q_pos and are masked,
    not cleared.  This is dense attention on every device, as in the
    reference (an XLA gather there, not a kernel)."""
    B, S = tokens.shape
    x, cos, sin = _start(c, tokens, params)
    page = cache["k"].shape[2]
    max_ctx = block_tables.shape[1] * page
    q_pos = positions[:, :, None]                                # [B,S,1]
    k_pos = torch.arange(max_ctx, device=tokens.device)[None, None, :]
    mask = ((q_pos >= 0) & (k_pos <= q_pos))[:, None]           # [B,1,S,ctx]
    ck, cv, L, P = _flat_cache(cache)
    kvh, hd = c.num_kv_heads, c.head_dim_
    for l in range(c.num_layers):
        bp = _layer_params(params, l)
        q, k, v = _project_qkv(x, bp, positions, cos, sin, c)
        tables_l = (block_tables + l * P).long()
        write_page_tokens(ck, cv, k, v, tables_l, positions)
        # Cached prefix + just-written suffix; K in pages is already
        # rotary-encoded.  [B, W, page, KVH*D] -> [B, ctx, KVH, D].
        kf = ck[tables_l].reshape(B, max_ctx, kvh, hd)
        vf = cv[tables_l].reshape(B, max_ctx, kvh, hd)
        attn = dense_attention(q, kf, vf, mask, hd)
        x = x + attn.reshape(B, S, -1) @ bp["wo"].to(c.dtype)
        x = _mlp(x, bp, c, positions)
    return x, cache


def prefill_with_context(params, tokens, positions, cache: Cache,
                         block_tables, config: TransformerConfig
                         ) -> Tuple[torch.Tensor, Cache]:
    """Chunked prefill: process a prompt SUFFIX whose earlier tokens'
    K/V already live in this sequence's pages (prefix caching).

    tokens: [B, S] the suffix (padded); positions: [B, S] absolute
    positions starting at the first uncached token, -1 on padding.
    Returns (logits at each row's LAST valid position [B, vocab] fp32,
    cache)."""
    x, cache = _chunk_forward(params, tokens, positions, cache,
                              block_tables, config)
    return _lm_head(_last_valid(x, positions), params, config), cache


def verify_step(params, tokens, positions, cache: Cache, block_tables,
                config: TransformerConfig) -> Tuple[torch.Tensor, Cache]:
    """Speculative verification: process [last_token, draft...] as one
    chunk and return logits at EVERY position ([B, S, vocab] fp32);
    position i's argmax is the model's token after tokens[:i+1], which
    the engine compares with the draft."""
    x, cache = _chunk_forward(params, tokens, positions, cache,
                              block_tables, config)
    B, S, h = x.shape
    logits = _lm_head(x.reshape(B * S, h), params, config)
    return logits.reshape(B, S, -1), cache


def _decode_one(params, tokens, cache: Cache, block_tables, positions,
                context_lens, config: TransformerConfig
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step's body (shared by decode_step and
    decode_multi_step)."""
    c = config
    B = tokens.shape[0]
    x, cos, sin = _start(c, tokens, params)
    x = x[:, None, :]                                            # [B,1,h]
    ck, cv, L, P = _flat_cache(cache)
    for l in range(c.num_layers):
        bp = _layer_params(params, l)
        q, k, v = _project(x, bp, c)
        tables_l = block_tables + l * P
        # Rotary embedding of q and k and the K/V row write: one kernel.
        q = rope_write_token_rows(q[:, 0], k[:, 0], v[:, 0], cos, sin, ck,
                                  cv, tables_l, positions)
        attn = paged_attention(q, ck, cv, tables_l, context_lens)
        x = x + attn.reshape(B, 1, -1) @ bp["wo"].to(c.dtype)
        x = _mlp(x, bp, c)
    return _lm_head(x[:, 0], params, c), cache


def decode_step(params, tokens, cache: Cache, block_tables, positions,
                context_lens, config: TransformerConfig
                ) -> Tuple[torch.Tensor, Cache]:
    """Advance every slot one token.

    tokens: [B] int (the previously emitted token per slot); positions:
    [B] its absolute position (< 0: the slot is idle and its K/V row goes
    to the scratch page); context_lens: [B] cache length INCLUDING this
    token.  Returns (logits [B, vocab] fp32, cache written in place)."""
    return _decode_one(params, tokens, cache, block_tables, positions,
                       context_lens, config)


def decode_multi_step(params, tokens, cache: Cache, block_tables, positions,
                      context_lens, limits, eos, config: TransformerConfig,
                      n_steps: int):
    """Advance every slot up to n_steps GREEDY tokens with no host read
    in between: each step's argmax feeds the next.

    limits: [B] highest absolute position a slot may WRITE
    (len(prompt) + max_new - 1); a slot stops when its next write would
    pass it.  eos: [B] per-slot EOS token id, -1 for none; a slot stops
    after emitting it.  A slot whose position is < 0 is dead: its rows
    of `out` are -1 and its K/V row goes to the scratch page.

    Returns (out [B, n_steps] int32 tokens, -1 past a slot's stop;
    tokens [B]; positions [B]; context_lens [B]; cache): the final state
    as new tensors (the inputs are not written), so the caller can chain
    the next chunk off it (serve/llm_engine.py pipelined decode)."""
    B = tokens.shape[0]
    out = torch.full((B, n_steps), -1, dtype=torch.int32,
                     device=tokens.device)
    ctx = context_lens
    for i in range(n_steps):
        alive = positions >= 0
        logits, cache = _decode_one(params, tokens, cache, block_tables,
                                    positions, ctx, config)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(alive, nxt, -1)
        out[:, i] = nxt
        hit_eos = alive & (eos >= 0) & (nxt == eos)
        new_pos = positions + 1
        go = alive & ~(hit_eos | (new_pos > limits))
        positions = torch.where(go, new_pos, -1)
        ctx = torch.where(go, ctx + 1, ctx)
        tokens = torch.where(alive, nxt, tokens)
    return out, tokens, positions, ctx, cache


def merge_slot_state(tokens, positions, context_lens, limits, eos, mask,
                     new_tokens, new_positions, new_context_lens,
                     new_limits, new_eos):
    """Fold host-side slot changes (admissions, frees) into the chained
    decode state without reading it back: a masked select per tensor,
    written in place (the state tensors are a captured graph's inputs).
    Returns the same five tensors."""
    state = (tokens, positions, context_lens, limits, eos)
    new = (new_tokens, new_positions, new_context_lens, new_limits, new_eos)
    for old, fresh in zip(state, new):
        torch.where(mask, fresh.to(old.dtype), old, out=old)
    return state


def packed_prefill_admit(params, tokens, positions, row_tables, seg_slot,
                         seg_limit, seg_eos, cache: Cache, st_tokens,
                         st_positions, st_ctx, st_limits, st_eos,
                         config: TransformerConfig, seg_len: int):
    """Packed prefill: process MANY equal-bucket prompt segments in one
    call, write their K/V pages, compute each segment's first greedy
    token, and fold the new slots into the chained decode state, with
    no host read.

    Two layouts of one buffer: matmuls and the MLP run on [R, S] rows
    packing S / seg_len segments each; attention runs on the
    [R*S/seg_len, seg_len] per-segment view (the flash kernel on a CUDA
    device).  Segments are page-aligned within their row (seg_len a
    multiple of the page, positions starting at 0), so a segment's token
    at row-local index j lands at page row_tables[r, j // page], offset
    j % page, which is its absolute position's slot.

    tokens/positions: [R, S] (-1 positions: pad, K/V to the scratch
    page, queries masked); row_tables: [R, S // page]; seg_slot, limit,
    eos: [NSEG = R*S/seg_len] per-segment decode-slot metadata, slot ==
    max_batch for an unused segment, which changes no slot.

    Returns (first_tokens [NSEG] int32, cache, st_tokens, st_positions,
    st_ctx, st_limits, st_eos), the st_* the same tensors, written in
    place with merge_slot_state's meaning (st_positions = next write
    position, -1 when the first token already finishes the request)."""
    c = config
    R, S = tokens.shape
    nseg = (R * S) // seg_len
    x, cos, sin = _start(c, tokens, params)
    pos_seg = positions.reshape(nseg, seg_len)
    # Row-local positions drive paging, true positions RoPE and the mask.
    rpos = torch.arange(S, dtype=positions.dtype,
                        device=positions.device)[None]
    rpos = torch.where(positions >= 0, rpos, -1)
    ck, cv, L, P = _flat_cache(cache)
    hd = c.head_dim_
    for layer in range(c.num_layers):
        bp = _layer_params(params, layer)
        q, k, v = _project_qkv(x, bp, positions, cos, sin, c)
        write_page_tokens(ck, cv, k, v, row_tables + layer * P, rpos)
        attn = _prefill_attention(
            q.reshape(nseg, seg_len, c.num_heads, hd),
            k.reshape(nseg, seg_len, c.num_kv_heads, hd),
            v.reshape(nseg, seg_len, c.num_kv_heads, hd), pos_seg, c)
        x = x + attn.reshape(R, S, -1) @ bp["wo"].to(c.dtype)
        x = _mlp(x, bp, c, positions)

    xs = x.reshape(nseg, seg_len, -1)
    logits = _lm_head(_last_valid(xs, pos_seg), params, c)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    ctx_len = (pos_seg >= 0).sum(dim=1, dtype=torch.int32)
    # ctx_len == limit: the first token was the last one allowed.
    finished = ((seg_eos >= 0) & (first == seg_eos)) | (ctx_len >= seg_limit)
    new_pos = torch.where(finished, -1, ctx_len)
    # Fold into the state per slot: the segment that names a slot, if
    # any (the reference scatters by slot and drops slot == max_batch).
    B = st_tokens.shape[0]
    hit = seg_slot[None, :] == torch.arange(B, device=seg_slot.device)[:, None]
    src = hit.to(torch.int32).argmax(dim=1)
    mask = hit.any(dim=1)
    merge_slot_state(st_tokens, st_positions, st_ctx, st_limits, st_eos,
                     mask, first[src], new_pos[src], ctx_len[src] + 1,
                     seg_limit[src], seg_eos[src])
    return first, cache, st_tokens, st_positions, st_ctx, st_limits, st_eos


def gather_kv_pages(cache: Cache, page_ids) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Read one request's KV pages out of the paged cache for handoff.

    page_ids: [N] physical page indices (pad rows read an arbitrary live
    page; the caller slices them off).  Returns (k, v) each
    [L, N, page, KD], the all-layer column of those pages."""
    idx = page_ids.long()
    return cache["k"][:, idx], cache["v"][:, idx]


def splice_kv_pages(cache: Cache, k_pages, v_pages, page_ids) -> Cache:
    """Write imported KV pages into the paged cache in place, one
    index_copy_ into the flat [L*P, ...] view per tensor.

    k_pages/v_pages: [L, N, page, KD]; page_ids: [N] destination pages,
    -1 for pad rows.  Pad rows go to the scratch page (flat L*P - 1, never
    allocated), never to a per-layer sentinel, which would alias the next
    layer's page 0; every other page ends up as the reference's, which
    drops them."""
    kf, vf, L, P = _flat_cache(cache)
    ids = page_ids.long()
    layer = torch.arange(L, device=ids.device)[:, None] * P
    idx = torch.where(ids[None, :] >= 0, layer + ids[None, :],
                      L * P - 1).reshape(-1)
    rest = kf.shape[1:]
    kf.index_copy_(0, idx, k_pages.reshape(-1, *rest).to(kf.dtype))
    vf.index_copy_(0, idx, v_pages.reshape(-1, *rest).to(vf.dtype))
    return cache


# Compile accounting, under the reference's names: each entry point's
# first call per argument signature (shapes, dtypes, plain ints) counts
# as one compilation (util/device_stats.py).  The decode graphs capture
# the unwrapped decode_step / decode_multi_step (`__wrapped__`), so
# nothing of this runs inside a capture; a capture is counted as one
# compilation of "decode_graph.<kind>" instead.
prefill = device_stats.count_compiles(prefill, "decoding.prefill")
prefill_with_context = device_stats.count_compiles(
    prefill_with_context, "decoding.prefill_with_context")
verify_step = device_stats.count_compiles(
    verify_step, "decoding.verify_step")
decode_step = device_stats.count_compiles(
    decode_step, "decoding.decode_step")
decode_multi_step = device_stats.count_compiles(
    decode_multi_step, "decoding.decode_multi_step")
packed_prefill_admit = device_stats.count_compiles(
    packed_prefill_admit, "decoding.packed_prefill_admit")
merge_slot_state = device_stats.count_compiles(
    merge_slot_state, "decoding.merge_slot_state")
gather_kv_pages = device_stats.count_compiles(
    gather_kv_pages, "decoding.gather_kv_pages")
splice_kv_pages = device_stats.count_compiles(
    splice_kv_pages, "decoding.splice_kv_pages")
