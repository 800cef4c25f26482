"""The collectives the parallel layer runs over a mesh's groups.

The reference has none of these: XLA compiles its psum, all-gather,
reduce-scatter and ppermute into the program.  Here each is a
torch.distributed call on the group of a mesh axis, and its transport
follows from the group's backend, chosen before the call and never
retried another way (gloo takes reduce_scatter_tensor on CPU and pinned
host tensors under the torch of the card's machine, 2.11, as under the
CPU tests', 2.13):

  "nccl"        NCCL on the CUDA tensors themselves;
  "gloo"        gloo on CPU tensors;
  "gloo-host"   gloo with CUDA tensors staged through pinned host
                buffers, explicitly (gloo's P2P takes CPU tensors only).

NCCL needs one card per rank, so two ranks sharing one card run gloo.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Gradient buckets of the all-reduce: this many bytes per flat buffer.
BUCKET_BYTES = 256 << 20


def transport(group, device: torch.device) -> str:
    """The transport a collective on `group` takes for tensors on
    `device` (module docstring)."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("an NCCL group moves CUDA tensors only")
        return "nccl"
    if backend != "gloo":
        raise ValueError(f"no transport for backend {backend!r}")
    return "gloo-host" if device.type == "cuda" else "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of CUDA tensor `t` (blocking)."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` in place over `group`; a no-op for no group."""
    if group is None:
        return t
    if transport(group, t.device) == "gloo-host":
        buf = _host(t)
        dist.all_reduce(buf, group=group)
        t.copy_(buf)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Overwrite `t` with rank `src`'s (a global rank) over `group`."""
    if group is None:
        return t
    if transport(group, t.device) == "gloo-host":
        buf = _host(t)
        dist.broadcast(buf, src=src, group=group)
        t.copy_(buf)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def all_reduce_tree_(leaves: Sequence[torch.Tensor], group) -> int:
    """Sum every tensor of `leaves` in place over `group`, packed into
    flat buckets of one dtype up to BUCKET_BYTES each (one collective
    per bucket, not per leaf).  Returns the bytes reduced."""
    if group is None:
        return 0
    by_dtype = {}
    for t in leaves:
        by_dtype.setdefault(t.dtype, []).append(t)
    buckets = []
    for ts in by_dtype.values():
        bucket, size = [], 0
        for t in ts:
            if bucket and size + t.nbytes > BUCKET_BYTES:
                buckets.append(bucket)
                bucket, size = [], 0
            bucket.append(t)
            size += t.nbytes
        buckets.append(bucket)
    total = 0
    for bucket in buckets:
        flat = all_reduce_(torch.cat([t.reshape(-1) for t in bucket]), group)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view(t.shape))
        total += flat.nbytes
        del flat
    return total


def shift(tensors: Tuple[torch.Tensor, ...], send_to: int, recv_from: int,
          group) -> Tuple[torch.Tensor, ...]:
    """Send `tensors` to global rank `send_to` and return those received
    from `recv_from`, the same shapes and dtypes, packed into one
    message: one isend and one irecv per call."""
    dev = tensors[0].device
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mode = transport(group, dev)
    out = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True) \
        if mode == "gloo-host" else torch.empty_like(flat)
    send = _host(flat) if mode == "gloo-host" else flat
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, send_to, group=group),
        dist.P2POp(dist.irecv, out, recv_from, group=group)])
    for r in reqs:
        r.wait()
    if mode == "gloo-host":
        out = out.to(dev)
    parts, off = [], 0
    for t in tensors:
        parts.append(out[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return tuple(parts)


def all_gather(t: torch.Tensor, ranks: List[int], group,
               dim: int) -> torch.Tensor:
    """Concatenate along `dim` the `t` of every rank of `group`, in the
    order `ranks` gives (the axis order; the group's own rank order is
    sorted)."""
    if group is None or len(ranks) == 1:
        return t
    mode = transport(group, t.device)
    src = _host(t.contiguous()) if mode == "gloo-host" else t.contiguous()
    parts = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(parts, src, group=group)
    by_rank = dict(zip(sorted(ranks), parts))
    out = torch.cat([by_rank[r] for r in ranks], dim=dim)
    return out.to(t.device) if mode == "gloo-host" else out


def reduce_scatter(t: torch.Tensor, ranks: List[int], group,
                   dim: int) -> torch.Tensor:
    """This rank's block of the sum of every rank's `t` over `group`:
    `t` cut along `dim` into len(ranks) equal blocks, the i-th for the
    rank at position i of `ranks` (the axis order), one
    reduce_scatter_tensor on the blocks laid out in the group's own
    (sorted) rank order."""
    if group is None or len(ranks) == 1:
        return t
    n = len(ranks)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                         f"over {n} ranks")
    blocks = dict(zip(ranks, t.chunk(n, dim)))
    flat = torch.cat([blocks[r].reshape(-1) for r in sorted(ranks)])
    mode = transport(group, t.device)
    if mode == "gloo-host":
        src = _host(flat)
        out = torch.empty(flat.numel() // n, dtype=flat.dtype,
                          pin_memory=True)
    else:
        src, out = flat, flat.new_empty(flat.numel() // n)
    del flat
    dist.reduce_scatter_tensor(out, src, group=group)
    shape = list(t.shape)
    shape[dim] //= n
    out = out.view(shape)
    return out.to(t.device) if mode == "gloo-host" else out


# Elements per step of tree_digest: bounds its int64 temporaries.
DIGEST_CHUNK = 1 << 24


def tree_digest(leaves: Sequence[torch.Tensor]) -> int:
    """An exact digest of the tensors' bits, computed on their device:
    the sum, mod 2**64, of every element's bit pattern (as an integer of
    its width) times (its index mod 1000003) + 1, over the leaves in
    order.  Equal trees give equal digests; two trees whose bits differ
    anywhere give different ones but for a collision."""
    acc = 0
    for leaf in leaves:
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[leaf.element_size()]
        flat = leaf.detach().contiguous().reshape(-1).view(ints)
        for start in range(0, flat.numel(), DIGEST_CHUNK):
            part = flat[start:start + DIGEST_CHUNK].to(torch.int64)
            w = (torch.arange(start, start + part.numel(),
                              device=part.device) % 1000003) + 1
            acc = (acc + int((part * w).sum())) % (1 << 64)
        acc = (acc * 1000033 + leaf.numel()) % (1 << 64)
    return acc


def digests_equal(leaves: Sequence[torch.Tensor], group
                  ) -> Tuple[bool, List[int]]:
    """(whether every rank of `group` holds the same bits, each rank's
    digest), by `tree_digest` and an all-gather of the digests."""
    d = tree_digest(leaves)
    if group is None:
        return True, [d]
    got: List[Optional[int]] = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, d, group=group)
    return all(g == d for g in got), list(got)
