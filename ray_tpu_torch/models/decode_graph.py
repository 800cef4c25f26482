"""CUDA graphs of the decode step and of the n-step decode chunk.

The engine decodes over static buffers held here: the chained slot state
`state` ([5, max_batch] int32; rows tokens, positions, context_lens,
limits, eos) and the block tables `tables` ([max_batch,
max_pages_per_seq] int32).  The engine writes into them (host uploads,
`merge_slot_state`, the packed wave's fold) and then calls

  - `decode_step(W)`: fp32 logits [max_batch, vocab] of one step over
    `tables[:, :W]` (rows tokens, positions and context_lens);
  - `multi_step(W, n)`: `decode_multi_step`'s tokens [max_batch, n],
    with the new tokens, positions and context_lens written back into
    `state`.

On a CUDA device each (kind, W, n) is one `torch.cuda.CUDAGraph`,
captured at first use after a warm-up call on a side stream and replayed
from then on; every graph shares one memory pool.  W is the engine's
pow-2 table-width bucket, so there are at most ceil(log2(max pages per
sequence)) + 1 graphs per kind and n (`bucket_bound`).  A capture that
fails raises: there is no eager retry.  The outputs live at fixed
addresses and the next replay overwrites them, so a caller copies out
what it keeps (`download`).  On the CPU the same calls run the eager
functions on the same buffers.

A capture launches nothing on the card: the kernel wrappers log their
calls under capture instead of counting them (ops/_build.py), and each
replay adds its graph's logged launches, so that `Kernel.launches` keeps
counting launches on the card.  Each capture is also one compilation of
"decode_graph.<kind>" for util/device_stats.py (the card's counterpart
of the reference's XLA recompile); the graphs run the unwrapped decoding
functions, so no Python-side accounting runs inside a capture.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models import decoding
from ray_tpu_torch.models.decoding import Cache, rope_tables
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.ops._build import take_captured
from ray_tpu_torch.util import device_stats

# The eager functions behind decoding's compile-accounting wrappers.
_decode_step = decoding.decode_step.__wrapped__
_decode_multi_step = decoding.decode_multi_step.__wrapped__

KINDS = ("decode_step", "decode_multi_step")


def upload(dst: torch.Tensor, arr: np.ndarray) -> torch.Tensor:
    """Copy a host array into `dst` in place.  To a CUDA tensor the copy
    goes through pinned memory with non_blocking=True, so the host does
    not wait on the card (the pinned block is not reused before the copy
    has run: PyTorch's host allocator records the stream on it)."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)
    return dst


def download(src: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """A host copy of `src` and, for a CUDA tensor, the event after which
    it holds the values: a non_blocking copy into pinned memory, so the
    host waits only where it reads it (`read`)."""
    if not src.is_cuda:
        return src.clone(), None
    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    host.copy_(src, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def read(host: torch.Tensor, event: Optional[torch.cuda.Event]
         ) -> np.ndarray:
    """The values of a `download`, waiting for its event."""
    if event is not None:
        event.synchronize()
    return host.numpy()


class DecodeGraphs:
    """The decode calls of one engine over its static buffers: captured
    graphs replayed on a CUDA device, the eager functions on the CPU.

    `captures` counts the graphs captured and `capture_seconds` their
    total host time (warm-up included)."""

    def __init__(self, params, cache: Cache, config: TransformerConfig,
                 max_batch: int, max_pages_per_seq: int,
                 device: torch.device):
        self.params = params
        self.cache = cache
        self.config = config
        self.device = device
        self.max_pages_per_seq = max_pages_per_seq
        self.state = torch.zeros((5, max_batch), dtype=torch.int32,
                                 device=device)
        rope_tables(config, self.state.device)  # before any capture
        self.tables = torch.zeros((max_batch, max_pages_per_seq),
                                  dtype=torch.int32, device=device)
        self.graphed = device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self._graphs: Dict[tuple, tuple] = {}
        self.captures = 0
        self.capture_seconds = 0.0

    def bucket_bound(self) -> int:
        """Most graphs one kind and n can take: one per pow-2 W."""
        return math.ceil(math.log2(self.max_pages_per_seq)) + 1

    # -- the two calls ------------------------------------------------------
    def decode_step(self, W: int) -> torch.Tensor:
        """fp32 logits [max_batch, vocab] of one decode step over rows
        tokens, positions, context_lens of `state` and `tables[:, :W]`."""
        return self._run(("decode_step", W, 1),
                         lambda state, live: self._step(state, W))

    def multi_step(self, W: int, n: int) -> torch.Tensor:
        """n greedy steps off `state`, written back into it; returns the
        tokens [max_batch, n] (-1 past each slot's stop)."""
        return self._run(("decode_multi_step", W, n),
                         lambda state, live: self._chunk(state, W, n, live))

    # -- eager bodies -------------------------------------------------------
    def _step(self, state: torch.Tensor, W: int) -> torch.Tensor:
        logits, _ = _decode_step(self.params, state[0], self.cache,
                                self.tables[:, :W], state[1], state[2],
                                self.config)
        return logits

    def _chunk(self, state: torch.Tensor, W: int, n: int,
               live: bool) -> torch.Tensor:
        out, tokens, positions, ctx, _ = _decode_multi_step(
            self.params, state[0], self.cache, self.tables[:, :W],
            state[1], state[2], state[3], state[4], self.config, n)
        if live:
            state[0].copy_(tokens)
            state[1].copy_(positions)
            state[2].copy_(ctx)
        return out

    # -- graphs -------------------------------------------------------------
    def _run(self, key: tuple, body) -> torch.Tensor:
        if not self.graphed:
            return body(self.state, True)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(key, body)
        graph, out, launches = entry
        graph.replay()
        for kernel, n in launches.items():
            kernel.launches += n
        return out

    def _capture(self, key: tuple, body
                 ) -> Tuple[torch.cuda.CUDAGraph, torch.Tensor,
                            collections.Counter]:
        """Warm up `body` on a side stream over a dead copy of the state
        (every position -1: its K/V rows go to the scratch page and the
        live state is not touched), then capture it over the live state
        and note the capture as a compilation of "decode_graph.<kind>".
        Returns (graph, its output, the launches of one replay)."""
        t0 = time.perf_counter()
        dead = self.state.clone()
        dead[1].fill_(-1)
        dead[2].zero_()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            body(dead, False)
        torch.cuda.current_stream(self.device).wait_stream(side)
        take_captured()  # drop any other capture's log
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = body(self.state, True)
        launches = collections.Counter(take_captured())
        seconds = time.perf_counter() - t0
        self.captures += 1
        self.capture_seconds += seconds
        if device_stats.enabled():
            kind, W, n = key
            device_stats.note_compile(
                f"decode_graph.{kind}", seconds,
                [[self.tables.shape[0], W], n])
        return graph, out, launches
