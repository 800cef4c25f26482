"""LLMEngine: continuous-batching inference over the paged KV cache.

Port of ray_tpu/serve/llm_engine.py:

  - one prefill call per pow-2 prompt-length bucket (or a chunked
    prefill after a prefix-cache hit), one decode call per step over
    [max_batch] slots;
  - page-granular cache memory via a free-list allocator, so long and
    short sequences share the pool with no fragmentation copies;
  - continuous batching: finished sequences release their slot and pages
    at the end of any step and queued requests join at the next one;
  - admission control: a bounded queue (QueueFull), a queueing deadline
    past which waiting requests are shed, and a per-step prefill token
    budget so prompt bursts interleave with decode;
  - prefix caching of full prompt pages (PrefixCache);
  - multi-step decoding (`multi_step` > 1, greedy): chunks of n steps
    dispatched off the chained device state, `pipeline_depth` of them in
    flight, each read back once; admissions fold in between chunks;
  - packed admission (`packed_admit`): greedy prompts of one bucket
    prefilled in one call whose first tokens come back with the chunks;
  - speculative decoding (`speculative_k` > 0): prompt-lookup drafts
    verified in one chunked forward;
  - KV handoff: `export_kv` / `import_kv` and `export_on_finish` bundles
    (`serve_kv_export`: prompt, tokens, context length and the pages).

On a CUDA device every decode step and chunk is the replay of a captured
CUDA graph over static buffers (models/decode_graph.py), and neither a
chunk's nor a packed wave's dispatch waits on the card: inputs go up
through pinned memory, outputs come down into pinned memory behind an
event, and the only wait is on the oldest chunk's event when it is
reconciled.

Observability, as the reference's: the serve metrics (requests, sheds,
queue depth and wait, TTFT, TPOT, KV handoffs), per-request SLO samples
(`slo_samples`), phase spans (serve.queue / serve.prefill or serve.import
/ serve.decode) for requests that carry a `trace_ctx`, flight-recorder
events for every shed, abort and handoff, the every-Nth-step sampler
(`engine_sample`) with its roofline/MFU fields, and the HBM ledger's
weights and kv_pages (util/).  Every hook reads host state only: no hook
waits on the card, and none runs inside a graph capture.  Settings come
from the reference's RAY_TPU_SERVE_* environment variables where a
constructor argument is left None.

The engine is synchronous and serves one replica; `add_request` /
`step` / `generate` are its entry points.
"""

from __future__ import annotations

import hashlib
import math
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.models.decode_graph import (
    DecodeGraphs,
    download,
    read,
    upload,
)
from ray_tpu_torch.models.decoding import (
    gather_kv_pages,
    init_kv_pages,
    merge_slot_state,
    packed_prefill_admit,
    prefill,
    prefill_with_context,
    splice_kv_pages,
    verify_step,
)
from ray_tpu_torch.train.optim import tree_leaves
from ray_tpu_torch.util import device_stats, flight_recorder, tracing
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

_REQUESTS = Counter(
    "ray_tpu_serve_requests_total",
    "Requests admitted into an LLMEngine queue.")
_SHED = Counter(
    "ray_tpu_serve_shed_total",
    "Requests shed by engine admission control.",
    tag_keys=("reason",))
_QUEUE_DEPTH = Gauge(
    "ray_tpu_serve_queue_depth",
    "Requests waiting in the engine admission queue.")
_KV_HANDOFF = Counter(
    "ray_tpu_serve_kv_handoff_total",
    "KV-page handoffs between prefill and decode replicas.",
    tag_keys=("direction",))
_KV_HANDOFF_BYTES = Counter(
    "ray_tpu_serve_kv_handoff_bytes_total",
    "KV page bytes moved by prefill->decode handoffs.",
    tag_keys=("direction",))
_HANDOFF_FALLBACK = Counter(
    "ray_tpu_serve_handoff_fallback_total",
    "Handoffs that fell back to re-prefill on the decode replica.",
    tag_keys=("reason",))
_QUEUE_WAIT = Histogram(
    "ray_tpu_serve_queue_wait_seconds",
    "Time a request spent in the engine admission queue, observed on "
    "EVERY outcome: admitted into a slot, or shed while waiting.",
    tag_keys=("outcome",))
_TTFT = Histogram(
    "ray_tpu_serve_ttft_seconds",
    "Time to first generated token (enqueue to first token).")
_TPOT = Histogram(
    "ray_tpu_serve_tpot_seconds",
    "Mean inter-token time after the first generated token.",
    boundaries=(0.0001, 0.001, 0.01, 0.1, 1.0, 10.0))

# Bundles keep only the newest export_on_finish captures.
KV_READY_MAX = 32
# The fields of a serve_kv_export bundle (the reference's wire schema):
# name -> (accepted types, required).
_KV_EXPORT_FIELDS = {
    "req": ((int,), True), "prompt": ((list, tuple), True),
    "generated": ((list, tuple), True), "context_len": ((int,), True),
    "page_size": ((int,), True), "num_layers": ((int,), True),
    "kd": ((int,), True), "dtype": ((str,), True),
    "chain_keys": ((list, tuple), False), "done": ((list, tuple), False),
    "k": (None, False), "v": (None, False), "trace": ((list, tuple), False),
}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


class QueueFull(RuntimeError):
    """Raised by add_request when the admission queue is at capacity."""


class RequestShed(RuntimeError):
    """Raised to a waiter whose queued request was shed (queueing
    deadline passed, or the request was aborted) before completing."""


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class PageAllocator:
    """Free-list page allocator."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        # The LAST physical page is the decode write path's scratch
        # target for idle slots (ops/paged_attention.py write_token_rows)
        # — never allocate it.
        self._free: List[int] = list(range(num_pages - 2, -1, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV cache exhausted: need {n} pages, "
                f"{len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        self._free.extend(pages)


@dataclass
class _CacheEntry:
    page: int
    refcount: int
    depth: int  # chain position; leaves (deepest) evict first


class PrefixCache:
    """Hash-based sharing of full prompt-prefix KV pages across requests.

    A FULL page of `page_size` prompt tokens is keyed by the chain hash
    of every token up to and including that page, so a hit at page i
    implies hits at 0..i-1 and the block-table prefix can be reused
    verbatim.  Pages enter with refcount 1 (the computing request);
    refcount-0 pages stay cached but evictable, deepest chains first."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._entries: Dict[bytes, _CacheEntry] = {}
        self.hits = 0
        self.tokens_saved = 0

    @staticmethod
    def chain_hashes(tokens: Sequence[int], page_size: int,
                     max_pages: int) -> List[bytes]:
        """Chain hash per full page: h_i = sha256(h_{i-1} || page
        tokens).  Cryptographic: a collision would serve another
        prompt's KV pages."""
        arr = np.asarray(tokens, dtype=np.int64)
        out: List[bytes] = []
        h = b""
        for i in range(max_pages):
            chunk = arr[i * page_size:(i + 1) * page_size].tobytes()
            h = hashlib.sha256(h + chunk).digest()
            out.append(h)
        return out

    def match(self, keys: Sequence[bytes]) -> List[int]:
        """Longest cached prefix: pages for keys[0..k), refcounts
        bumped."""
        pages = []
        for key in keys:
            e = self._entries.get(key)
            if e is None:
                break
            e.refcount += 1
            pages.append(e.page)
        return pages

    def peek(self, keys: Sequence[bytes]) -> int:
        """Length of the cached chain WITHOUT touching refcounts (the
        packed-admission eligibility probe)."""
        n = 0
        for key in keys:
            if key not in self._entries:
                break
            n += 1
        return n

    def register(self, key: bytes, page: int, depth: int) -> bool:
        """Adopt a freshly computed full prompt page (refcount 1).  False
        if the key is already cached: the caller keeps the page."""
        if key in self._entries:
            return False
        self._entries[key] = _CacheEntry(page, 1, depth)
        return True

    def release(self, keys: Sequence[bytes]) -> None:
        for key in keys:
            e = self._entries.get(key)
            if e is not None:
                e.refcount = max(0, e.refcount - 1)

    def evict(self, n: int) -> List[int]:
        """Free up to n unreferenced pages (deepest chains first)."""
        victims = sorted(
            (k for k, e in self._entries.items() if e.refcount == 0),
            key=lambda k: -self._entries[k].depth)[:n]
        return [self._entries.pop(k).page for k in victims]

    @property
    def num_idle(self) -> int:
        return sum(e.refcount == 0 for e in self._entries.values())

    def digest(self, k: int = 16) -> List[str]:
        """Top-k hot prefix keys (most-referenced first, shallower pages
        breaking ties) as truncated hex strings: the compact digest a
        router matches incoming prompts against."""
        keys = sorted(
            self._entries,
            key=lambda key: (-self._entries[key].refcount,
                             self._entries[key].depth))[:max(0, k)]
        return [key.hex()[:16] for key in keys]


@dataclass
class _Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    generated: List[int] = field(default_factory=list)
    slot: int = -1
    pages: List[int] = field(default_factory=list)  # privately owned
    eos_token: Optional[int] = None
    # Prefix-cache chain keys this request holds refs on (reused +
    # self-registered); released on finish.
    cache_keys: List[bytes] = field(default_factory=list)
    # Full-prompt chain hashes, computed once.
    chain_keys: Optional[List[bytes]] = None
    # Speculative drafting: n-gram -> latest start index, kept
    # incrementally so a draft lookup is O(1) per decode step.
    ngram_index: Dict[tuple, int] = field(default_factory=dict)
    indexed_upto: int = 0
    # Queueing deadline (time.monotonic(); 0 = none): still WAITING past
    # it means the request is shed at the next step.
    deadline: float = 0.0
    enqueued_at: float = 0.0
    # A serve_kv_export bundle whose pages this request splices in at
    # admission instead of running prefill (import_kv / _admit_import).
    kv_bundle: Optional[Dict[str, Any]] = None
    # Export the KV pages into kv_ready when the request finishes,
    # before its pages are freed.
    export_on_finish: bool = False
    # Request-journey trace context (trace_id, parent_span_id); phase
    # spans (serve.queue/prefill/decode) parent under it.  None =
    # untraced.
    trace_ctx: Optional[tuple] = None
    # Phase timeline, epoch seconds (0.0 = not reached): enqueue into
    # the waiting queue, seated into a slot, first generated token.
    # The derived SLO sample (TTFT/TPOT/queue-wait) folds into
    # slo_samples at finish.
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    # Whether the request resumed from an imported KV bundle (its
    # admission phase is a page splice, not a prefill).
    imported: bool = False


class LLMEngine:
    """Continuous-batching engine over the paged KV cache on `device`
    (default "cuda"; "cpu" must be asked for).

    params: the port's param dict (models/transformer.py), cast once to
    config.dtype; None draws random params from `seed` on the device.
    max_queue / queue_timeout_s / prefill_budget: admission control, 0
    disables each; None reads RAY_TPU_SERVE_MAX_QUEUE (1024),
    RAY_TPU_SERVE_QUEUE_TIMEOUT_S (60) and RAY_TPU_SERVE_PREFILL_BUDGET
    (8192).  RAY_TPU_SERVE_SLO_SAMPLES (256) bounds `slo_samples` and
    RAY_TPU_SERVE_STEP_SAMPLE_EVERY (8; 0 disables) sets the sampler's
    period, both read at construction.  multi_step, pipeline_depth, packed_admit,
    prefill_wave_tokens, prefill_row_tokens, speculative_k and
    speculative_ngram: the reference's modes, with its defaults
    (multi-step decoding and packed admission serve greedy requests;
    sampling and speculative slots take the classic per-token step)."""

    def __init__(self, config: tfm.TransformerConfig,
                 params: Optional[Dict[str, Any]] = None, *,
                 page_size: int = 16, num_pages: int = 512,
                 max_batch: int = 8, seed: int = 0,
                 enable_prefix_caching: bool = True,
                 speculative_k: int = 0, speculative_ngram: int = 2,
                 multi_step: int = 1, pipeline_depth: int = 2,
                 packed_admit: bool = True,
                 prefill_wave_tokens: int = 8192,
                 prefill_row_tokens: int = 1024,
                 max_queue: Optional[int] = None,
                 queue_timeout_s: Optional[float] = None,
                 prefill_budget: Optional[int] = None,
                 device: DeviceLike = None):
        c = config
        self.device = resolve_device(device)
        self.config = c
        self.page_size = page_size
        self.max_batch = max_batch
        # Speculative decoding (greedy prompt lookup): draft up to k
        # tokens by matching the trailing n-gram earlier in the
        # sequence, verify them in ONE chunked forward.  0 disables.
        self.spec_k = int(speculative_k)
        self.spec_ngram = max(1, int(speculative_ngram))
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        # Multi-step decoding (greedy only): n decode iterations on the
        # card per chunk, read back once.  1 = classic per-token steps.
        self.multi_step = max(1, int(multi_step))
        # Chunk k+1 is dispatched off chunk k's device-resident final
        # state while chunk k's tokens are still on their way back, so
        # the card runs chunks back to back; depth 1 = dispatch, then
        # reconcile.
        self.pipeline_depth = max(1, int(pipeline_depth))
        # Packed admission (greedy pipelined path): waiting prompts pad
        # to a pow-2 page-multiple bucket, pack into long rows, and are
        # prefilled AND folded into the device state in one call.
        self.packed_admit = bool(packed_admit) \
            and page_size & (page_size - 1) == 0
        self.prefill_wave_tokens = max(page_size, int(prefill_wave_tokens))
        self.prefill_row_tokens = max(page_size, int(prefill_row_tokens))
        # Step classification: waves dispatched, and wave records read
        # back (their first tokens reconciled).
        self.waves_dispatched = 0
        self.prefill_reconciles = 0
        self._inflight: List[dict] = []  # FIFO of dispatched records
        # The chained device state (tokens, positions, ctx, limits, eos
        # rows of the graphs' static state) while pipelined; None when
        # the host mirrors are authoritative.
        self._dstate: Optional[torch.Tensor] = None
        self._dirty_slots: set = set()  # freed slots to zero on device
        self._just_admitted: set = set()  # slots to fold into dstate
        self.max_pages_per_seq = math.ceil(c.max_seq_len / page_size)
        if params is None:
            params = tfm.init_params(c, seed, device=self.device,
                                     dtype=c.dtype)
        # Serve in the compute dtype: every decode step streams all
        # weights, so fp32 master weights would double its traffic.
        # The forward casts per use, so a one-time cast is numerically
        # identical (and a no-op for params already in c.dtype).
        self.params = _cast_tree(params, c.dtype, self.device)
        self.cache = init_kv_pages(c, num_pages, page_size,
                                   device=self.device)
        self.allocator = PageAllocator(num_pages)
        self.prefix_cache = (PrefixCache(page_size)
                             if enable_prefix_caching else None)
        self._rng = np.random.default_rng(seed)
        # Static decode buffers and, on a CUDA device, the graphs.
        self.graphs = DecodeGraphs(self.params, self.cache, c, max_batch,
                                   self.max_pages_per_seq, self.device)

        # Slot state (fixed [max_batch] shapes), host mirrors.
        self.block_tables = np.zeros(
            (max_batch, self.max_pages_per_seq), dtype=np.int32)
        self.context_lens = np.zeros(max_batch, dtype=np.int32)
        self.last_tokens = np.zeros(max_batch, dtype=np.int32)
        self.slot_req: List[Optional[_Request]] = [None] * max_batch

        self._next_id = 0
        self.waiting: List[_Request] = []
        self.num_completed = 0
        # Prefill/decode handoff counters.
        self.kv_exports = 0
        self.kv_imports = 0
        # Completions surfaced by an out-of-band pipeline flush (export_kv
        # draining in-flight chunks), merged into the next step()'s done
        # map so no finish is dropped.
        self._pending_done: Dict[int, List[int]] = {}
        # req_id -> serve_kv_export bundle captured at finish for
        # export_on_finish requests (oldest evicted past KV_READY_MAX).
        self.kv_ready: Dict[int, Dict[str, Any]] = {}
        self.max_queue = (_env_int("RAY_TPU_SERVE_MAX_QUEUE", 1024)
                          if max_queue is None else int(max_queue))
        self.queue_timeout_s = (
            _env_float("RAY_TPU_SERVE_QUEUE_TIMEOUT_S", 60.0)
            if queue_timeout_s is None else float(queue_timeout_s))
        self.prefill_budget = (
            _env_int("RAY_TPU_SERVE_PREFILL_BUDGET", 8192)
            if prefill_budget is None else int(prefill_budget))
        self.num_shed = 0
        self.num_aborted = 0
        # Requests shed/aborted since the caller last drained this map
        # ({req_id: reason}).
        self.shed: Dict[int, str] = {}
        self._step_prefill_left = 1 << 30
        # Per-request SLO samples (TTFT/TPOT/queue-wait), appended at
        # finish (queue-wait-only at shed).
        self.slo_samples: deque = deque(maxlen=max(
            1, _env_int("RAY_TPU_SERVE_SLO_SAMPLES", 256)))
        # Every Nth step snapshots batch occupancy, queue depth, free KV
        # pages and the previous step's prefill-token spend into
        # engine_sample (0 disables): host state, no device sync.
        self._sample_every = _env_int(
            "RAY_TPU_SERVE_STEP_SAMPLE_EVERY", 8)
        self._step_count = 0
        self.engine_sample: Optional[Dict[str, Any]] = None
        # Device-plane attribution: modeled per-iteration traffic and
        # per-token compute for the sampler's roofline/MFU, plus the HBM
        # ledger's two resident pools.  A tensor two names share (a tied
        # head) is counted once.
        self._weight_bytes = sum({
            t.data_ptr(): t.numel() * t.element_size()
            for t in tree_leaves(self.params)}.values())
        self._kv_per_token_bytes = (
            2 * c.num_layers * c.num_kv_heads * c.head_dim_
            * torch.empty((), dtype=c.dtype).element_size())
        self._flops_per_token = 2 * tfm.num_params(c)
        device_stats.attribute("weights", self._weight_bytes)
        device_stats.attribute("kv_pages", sum(
            v.numel() * v.element_size() for v in self.cache.values()))
        self._finished_tokens = 0
        # Decode iterations whose tokens have reached the host (a chunk
        # counts its n steps, a prefill call or a wave one).
        self._iterations = 0
        self._last_sample_t: Optional[float] = None
        self._last_sample_tokens = 0
        self._last_sample_iterations = 0

    # -- public API --------------------------------------------------------
    def add_request(self, prompt_tokens: Sequence[int],
                    max_new_tokens: int = 32, *,
                    temperature: float = 0.0,
                    eos_token: Optional[int] = None,
                    deadline_s: Optional[float] = None,
                    export_on_finish: bool = False,
                    trace_ctx: Optional[tuple] = None) -> int:
        if not prompt_tokens:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        self._check_fits(len(prompt_tokens), max_new_tokens)
        req = _Request(self._next_id, list(prompt_tokens), max_new_tokens,
                       temperature, eos_token=eos_token,
                       export_on_finish=export_on_finish)
        self._enqueue(req, deadline_s, trace_ctx)
        return req.req_id

    def _check_fits(self, prompt_len: int, max_new_tokens: int) -> None:
        if prompt_len + max_new_tokens > self.config.max_seq_len:
            raise ValueError(
                f"prompt+generation ({prompt_len}+{max_new_tokens})"
                f" exceeds max_seq_len={self.config.max_seq_len}")
        need = math.ceil((prompt_len + max_new_tokens) / self.page_size)
        # num_pages - 1: the last physical page is the decode scratch
        # target (PageAllocator) and can never be allocated.
        if need > self.allocator.num_pages - 1:
            raise ValueError(
                f"request needs {need} KV pages but the pool only has "
                f"{self.allocator.num_pages - 1} allocatable; raise "
                "num_pages or shorten the request")

    def _enqueue(self, req: _Request, deadline_s: Optional[float],
                 trace_ctx: Optional[tuple]) -> None:
        """Queue a checked request (QueueFull past max_queue)."""
        if self.max_queue > 0 and len(self.waiting) >= self.max_queue:
            # Backpressure instead of unbounded queue growth: shedding
            # at the door is the one point where the caller can still
            # retry another replica.
            self.num_shed += 1
            _SHED.inc(tags={"reason": "queue_full"})
            flight_recorder.record("serve", "queue_full",
                                   waiting=len(self.waiting),
                                   max_queue=self.max_queue)
            raise QueueFull(
                f"admission queue full ({len(self.waiting)} waiting, "
                f"cap {self.max_queue})")
        if trace_ctx:
            req.trace_ctx = tuple(trace_ctx)
        req.t_enqueue = time.time()
        req.enqueued_at = time.monotonic()
        ttl = self.queue_timeout_s if deadline_s is None else deadline_s
        if ttl and ttl > 0:
            req.deadline = req.enqueued_at + ttl
        self._next_id += 1
        self.waiting.append(req)
        _REQUESTS.inc()
        _QUEUE_DEPTH.set(len(self.waiting))

    def abort(self, req_id: int, reason: str = "aborted") -> bool:
        """Cancel a request wherever it is (waiting or active) and
        reclaim its slot and KV pages; the slot is zeroed on the device
        at the next merge (in-flight chunks skip it at reconcile).
        False when the id is unknown (already finished or shed)."""
        for i, req in enumerate(self.waiting):
            if req.req_id == req_id:
                self.waiting.pop(i)
                self._retire_unstarted(req, reason)
                _QUEUE_DEPTH.set(len(self.waiting))
                return True
        for slot, req in enumerate(self.slot_req):
            if req is not None and req.req_id == req_id:
                self.slot_req[slot] = None
                self.context_lens[slot] = 0
                self.allocator.free(req.pages)
                req.pages = []
                if self.prefix_cache is not None and req.cache_keys:
                    self.prefix_cache.release(req.cache_keys)
                    req.cache_keys = []
                self._dirty_slots.add(slot)
                self.num_aborted += 1
                self.shed[req_id] = reason
                flight_recorder.record("serve", "abort", req_id=req_id,
                                       reason=reason, slot=slot)
                return True
        return False

    def export_kv(self, req_id: int) -> Dict[str, Any]:
        """Export an ACTIVE request's KV pages and resume state as a
        `serve_kv_export` bundle (the prefill side of a handoff): the
        prompt, the tokens so far, the context length, the prefix-cache
        chain keys and the [L, n_ctx, page, KD] K/V pages, read out of
        the cache in one gather.  The request stays active here."""
        slot, req = -1, None
        for s, r in enumerate(self.slot_req):
            if r is not None and r.req_id == req_id:
                slot, req = s, r
                break
        if req is None:
            raise KeyError(f"request {req_id} is not active")
        if self._inflight:
            # The host mirrors must be authoritative: drain the
            # pipeline; its completions surface at the next step().
            self._flush_pipeline(self._pending_done)
            if self.slot_req[slot] is not req:
                raise KeyError(f"request {req_id} finished before export")
        if not req.generated:
            raise RuntimeError(
                f"request {req_id} has no generated token yet")
        return self._kv_bundle(req, slot, int(self.context_lens[slot]))

    def _kv_bundle(self, req: _Request, slot: int,
                   ctx: int) -> Dict[str, Any]:
        """Gather slot's first ceil(ctx/page_size) KV pages into a
        serve_kv_export bundle.  The cache holds KV for positions
        [0, ctx) of this slot.  bf16 pages travel as ml_dtypes.bfloat16
        arrays, the form the reference's engines write and accept."""
        n_ctx = max(1, math.ceil(ctx / self.page_size))
        # Pow-2 padded gather, as the reference's; pad rows read an
        # arbitrary live page and are sliced off.
        N = 1 << (n_ctx - 1).bit_length()
        ids = np.zeros(N, dtype=np.int32)
        ids[:n_ctx] = self.block_tables[slot][:n_ctx]
        k, v = gather_kv_pages(self.cache, *self._upload(ids))
        k, v = _host_pages(k[:, :n_ctx]), _host_pages(v[:, :n_ctx])
        bundle: Dict[str, Any] = {
            "op": "serve_kv_export",
            "req": req.req_id,
            "prompt": list(req.prompt),
            "generated": list(req.generated),
            "context_len": ctx,
            "page_size": self.page_size,
            "num_layers": int(k.shape[0]),
            "kd": int(k.shape[-1]),
            "dtype": _DTYPE_NAMES[self.config.dtype],
            "chain_keys": list(req.chain_keys or []),
            "k": k,
            "v": v,
        }
        self.kv_exports += 1
        nbytes = k.nbytes + v.nbytes
        _KV_HANDOFF.inc(tags={"direction": "export"})
        _KV_HANDOFF_BYTES.inc(nbytes, tags={"direction": "export"})
        flight_recorder.record("serve", "kv_export", req_id=req.req_id,
                               pages=n_ctx, bytes=nbytes)
        return bundle

    def import_kv(self, bundle: Dict[str, Any],
                  max_new_tokens: int = 32, *,
                  temperature: float = 0.0,
                  eos_token: Optional[int] = None,
                  deadline_s: Optional[float] = None,
                  trace_ctx: Optional[tuple] = None) -> int:
        """Enqueue a request resuming from an exported KV bundle (the
        decode side of a handoff), with add_request's admission contract
        (bounds checks, QueueFull, deadlines); the pages are spliced in
        at admission (_admit_import).  max_new_tokens is the request's
        TOTAL budget, counting the tokens the bundle already holds.
        Bundles of the reference's engine are accepted, bf16 ones too
        (read through their bits); so are bf16 pages given as their
        uint16 bits, the form this engine wrote before."""
        _check_bundle_fields(bundle)
        for key, want in (("page_size", self.page_size),
                          ("num_layers", self.config.num_layers)):
            if int(bundle[key]) != want:
                raise ValueError(
                    f"KV bundle {key}={bundle[key]} incompatible with "
                    f"engine {key}={want}")
        cache_dtype = _DTYPE_NAMES[self.config.dtype]
        got = np.asarray(bundle["k"]).dtype.name
        if not (got == cache_dtype or (
                cache_dtype == "bfloat16" and got == "uint16"
                and bundle["dtype"] == "bfloat16")):
            raise ValueError(
                f"KV bundle dtype {bundle['dtype']} incompatible with "
                f"cache dtype {cache_dtype}")
        prompt = list(bundle["prompt"])
        generated = list(bundle["generated"])
        if not prompt:
            raise ValueError("bundle prompt must contain at least one token")
        if not generated:
            raise ValueError("bundle carries no generated token to resume")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if len(generated) >= max_new_tokens:
            raise ValueError(
                f"bundle already has {len(generated)} generated tokens; "
                f"nothing left of a {max_new_tokens}-token budget")
        self._check_fits(len(prompt), max_new_tokens)
        if int(bundle["context_len"]) != \
                len(prompt) + len(generated) - 1:
            raise ValueError(
                f"bundle context_len {bundle['context_len']} does not "
                f"match prompt+generated-1 "
                f"({len(prompt)}+{len(generated)}-1)")
        req = _Request(self._next_id, prompt, max_new_tokens, temperature,
                       generated=generated, eos_token=eos_token)
        req.kv_bundle = bundle
        req.imported = True
        keys = bundle.get("chain_keys")
        if keys:
            req.chain_keys = [bytes(k) for k in keys]
        self._enqueue(req, deadline_s, trace_ctx)
        return req.req_id

    def _retire_unstarted(self, req: _Request, reason: str) -> None:
        """Drop a request that never reached a slot (shed or aborted
        while waiting): it holds no pages and no prefix-cache refs, so
        this is queue bookkeeping, its queue-wait SLO sample, the
        partial serve.queue span of a traced request, and a flight
        recorder event."""
        self.num_shed += 1
        self.shed[req.req_id] = reason
        _SHED.inc(tags={"reason": reason})
        now = time.time()
        waited = (time.monotonic() - req.enqueued_at
                  if req.enqueued_at else 0.0)
        # Queue wait is observed on EVERY outcome, sheds included, so
        # the histogram reflects what waiting requests experienced.
        _QUEUE_WAIT.observe(max(0.0, waited), tags={"outcome": "shed"})
        self.slo_samples.append({
            "queue_wait": round(max(0.0, waited), 6),
            "shed": reason, "ts": now})
        if req.trace_ctx is not None:
            tracing.record_span(
                "serve.queue", req.t_enqueue or now - waited, now,
                attributes={"req": req.req_id, "shed": reason,
                            "clock_off": round(tracing.clock_offset(),
                                               6)},
                parent_id=req.trace_ctx[1] or None,
                trace_id=req.trace_ctx[0], force=True)
        flight_recorder.record(
            "serve", "shed", req_id=req.req_id, reason=reason,
            waited_s=round(waited, 3) if req.enqueued_at else 0.0)

    def _note_admitted(self, req: _Request) -> None:
        """Seat-time bookkeeping shared by every admission path
        (classic _admit, KV import, packed wave): the queue-wait
        histogram plus the serve.queue phase span of traced requests."""
        now = time.time()
        req.t_admit = now
        waited = (time.monotonic() - req.enqueued_at
                  if req.enqueued_at else 0.0)
        _QUEUE_WAIT.observe(max(0.0, waited),
                            tags={"outcome": "admitted"})
        if req.trace_ctx is not None:
            tracing.record_span(
                "serve.queue", req.t_enqueue or now - waited, now,
                attributes={"req": req.req_id,
                            "clock_off": round(tracing.clock_offset(),
                                               6)},
                parent_id=req.trace_ctx[1] or None,
                trace_id=req.trace_ctx[0], force=True)

    def _stamp_first(self, req: _Request) -> None:
        """First generated token (or KV splice done): closes the
        prefill/import phase.  Idempotent.  Pipelined, a wave's first
        token is stamped when its record is reconciled."""
        if req.t_first:
            return
        req.t_first = time.time()
        if req.trace_ctx is not None and req.t_admit:
            tracing.record_span(
                "serve.import" if req.imported else "serve.prefill",
                req.t_admit, req.t_first,
                attributes={"req": req.req_id,
                            "prompt_tokens": len(req.prompt)},
                parent_id=req.trace_ctx[1] or None,
                trace_id=req.trace_ctx[0], force=True)

    def _note_finished(self, req: _Request) -> None:
        """Finish-time SLO accounting: TTFT/TPOT histograms, the SLO
        sample ring, and the decode phase span of traced requests."""
        now = time.time()
        if not req.t_first:
            req.t_first = now
        ttft = (max(0.0, req.t_first - req.t_enqueue)
                if req.t_enqueue else 0.0)
        n_out = len(req.generated)
        tpot = (max(0.0, now - req.t_first) / (n_out - 1)
                if n_out > 1 else 0.0)
        qwait = (max(0.0, (req.t_admit or req.t_first) - req.t_enqueue)
                 if req.t_enqueue else 0.0)
        _TTFT.observe(ttft)
        _TPOT.observe(tpot)
        self._finished_tokens += n_out
        self.slo_samples.append({
            "ttft": round(ttft, 6), "tpot": round(tpot, 6),
            "queue_wait": round(qwait, 6), "tokens": n_out, "ts": now})
        if req.trace_ctx is not None:
            tracing.record_span(
                "serve.decode", req.t_first, now,
                attributes={"req": req.req_id, "tokens": n_out,
                            "tpot": round(tpot, 6)},
                parent_id=req.trace_ctx[1] or None,
                trace_id=req.trace_ctx[0], force=True)

    def _shed_expired(self) -> None:
        """Drop waiting requests whose queueing deadline passed."""
        if not self.waiting:
            return
        now = time.monotonic()
        kept: List[_Request] = []
        for req in self.waiting:
            if req.deadline and now > req.deadline:
                self._retire_unstarted(req, "deadline")
            else:
                kept.append(req)
        self.waiting = kept
        _QUEUE_DEPTH.set(len(self.waiting))

    def _sample_device(self, sample: Dict[str, Any]) -> None:
        """Device-plane extension of the every-Nth-step sampler: the
        tokens that reached the host since the last sample, over the
        host time between the two, against the modeled bytes and flops
        behind them: continuous roofline/MFU gauges, a `device.step`
        span (when tracing is on) and fields of engine_sample.  Host
        math on values the engine already tracks: no device sync.

        The port departs from the reference's byte model, which divides
        one iteration's bytes by the slots active at the sample: when
        slots finish within the window (or, pipelined, when chunks of a
        fuller batch are reconciled after it has shrunk) that inflates
        the bytes per token, and the fraction passes 1.0.  Here the
        window's bytes are its iterations' (each streams the weights
        and the live KV context), over the tokens they produced."""
        now = sample["ts"]
        total = self._finished_tokens + sum(
            len(r.generated) for r in self.slot_req if r is not None)
        prev_t, prev_tok = self._last_sample_t, self._last_sample_tokens
        prev_it = self._last_sample_iterations
        self._last_sample_t, self._last_sample_tokens = now, total
        self._last_sample_iterations = self._iterations
        if not device_stats.enabled() or prev_t is None \
                or now <= prev_t:
            return
        try:
            tokens = max(0, total - prev_tok)
            tok_s = tokens / (now - prev_t)
            live_ctx = int(self.context_lens.sum())
            window_bytes = (self._iterations - prev_it) * (
                self._weight_bytes + live_ctx * self._kv_per_token_bytes)
            bytes_per_token = window_bytes / max(1, tokens)
            frac, mfu = device_stats.note_step(
                tokens_per_s=tok_s, bytes_per_token=bytes_per_token,
                flops_per_token=self._flops_per_token, plane="serve",
                extra={"active": sample["active"],
                       "step": sample["step"]})
            sample["tokens_per_s"] = round(tok_s, 2)
            sample["roofline_fraction"] = round(frac, 5)
            sample["mfu"] = round(mfu, 5)
            sample["modeled_bytes_per_token"] = int(bytes_per_token)
            tracing.record_span(
                "device.step", prev_t, now,
                attributes={"plane": "serve",
                            "tokens_per_s": round(tok_s, 2),
                            "roofline_fraction": round(frac, 5),
                            "mfu": round(mfu, 5),
                            "active": sample["active"]})
        except Exception:  # raylint: allow-swallow(telemetry must never fail an engine step)
            pass

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.num_active > 0 \
            or bool(self._inflight) or bool(self._pending_done)

    def step(self) -> Dict[int, List[int]]:
        """Shed expired requests, admit waiting ones, then one batched
        decode step (a pipelined multi_step chunk on the greedy path).
        Returns requests that finished THIS step ({req_id: tokens});
        pipelined, a request's finish surfaces when its chunk's tokens
        are reconciled (<= pipeline_depth steps after the chunk that
        produced them)."""
        done: Dict[int, List[int]] = {}
        if self._pending_done:
            done.update(self._pending_done)
            self._pending_done.clear()
        self._step_count += 1
        if self._sample_every > 0 \
                and self._step_count % self._sample_every == 0:
            # Snapshot BEFORE this step's work: _step_prefill_left still
            # holds the previous step's remainder, so prefill_tokens is
            # that step's actual prompt-token spend.
            budget = (self.prefill_budget
                      if self.prefill_budget > 0 else 0)
            self.engine_sample = {
                "ts": time.time(),
                "step": self._step_count,
                "active": self.num_active,
                "waiting": len(self.waiting),
                "free_pages": self.allocator.num_free,
                "inflight_chunks": len(self._inflight),
                "prefill_tokens": (
                    max(0, budget - min(self._step_prefill_left,
                                        budget)) if budget else 0),
                "completed": self.num_completed,
            }
            self._sample_device(self.engine_sample)
        self._shed_expired()
        self._step_prefill_left = (self.prefill_budget
                                   if self.prefill_budget > 0
                                   else (1 << 30))
        if self._pipelined_ok():
            # Finished in-flight work costs nothing to fold in.
            self._eager_reconcile(done)
            # Admissions need free slots: recycle the oldest in-flight
            # chunk first when the queue would otherwise starve.
            if self.waiting and not self._free_slots() and self._inflight:
                self._reconcile_oldest(done)
            self._dispatch_prefill_wave()
            if self.waiting and self._free_slots() \
                    and not self._wave_eligible(self.waiting[0]):
                # The head of the queue needs the classic synchronous
                # path (sampling, prefix-cache hit, imported KV).
                done.update(self._admit())
                if not self._pipelined_ok():
                    # A sampling request was just seated: drain and run
                    # this step on the classic per-token path.
                    self._flush_pipeline(done)
                    if self.num_active:
                        done.update(self._decode())
                    return done
            dispatched = self._dispatch_chunk()
            ndecode = sum(1 for ch in self._inflight
                          if ch.get("type") != "prefill")
            if ndecode >= self.pipeline_depth \
                    or (self._inflight and not dispatched):
                self._reconcile_oldest(done)
            return done
        self._flush_pipeline(done)
        done.update(self._admit())
        if self.num_active:
            done.update(self._decode())
        return done

    def _pipelined_ok(self) -> bool:
        """Pipelined chunks serve the greedy multi-step path; sampling
        and speculative slots need per-token host control and take the
        classic step.  Only ACTIVE slots count: a sampling request still
        in the queue must not degrade a full greedy batch."""
        if self.multi_step <= 1 or self.spec_k > 0:
            return False
        return not any(r is not None and r.temperature > 0.0
                       for r in self.slot_req)

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, *,
                 temperature: float = 0.0) -> List[List[int]]:
        """Blocking batch generation (greedy by default)."""
        ids = [self.add_request(p, max_new_tokens, temperature=temperature)
               for p in prompts]
        results: Dict[int, List[int]] = {}
        while self.has_work():
            results.update(self.step())
        return [results[i] for i in ids]

    # -- internals ---------------------------------------------------------
    def _upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """int32 host arrays as device tensors of their shapes, in ONE
        copy that does not wait on the card (decode_graph.upload)."""
        flat = np.concatenate([np.asarray(a, dtype=np.int32).ravel()
                               for a in arrays])
        buf = upload(torch.empty(flat.size, dtype=torch.int32,
                                 device=self.device), flat)
        out, at = [], 0
        for a in arrays:
            out.append(buf[at:at + a.size].view(a.shape))
            at += a.size
        return out

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _alloc_evicting(self, n: int) -> List[int]:
        """Allocate n pages, reclaiming idle prefix-cache pages when the
        free list runs short."""
        short = n - self.allocator.num_free
        if short > 0 and self.prefix_cache is not None:
            self.allocator.free(self.prefix_cache.evict(short))
        return self.allocator.alloc(n)

    def _available_pages(self) -> int:
        idle = (self.prefix_cache.num_idle
                if self.prefix_cache is not None else 0)
        return self.allocator.num_free + idle

    def _seat(self, req: _Request, slot: int, pages: List[int]) -> None:
        """Put req in slot with its block table (shared + private)."""
        req.slot = slot
        table = np.zeros(self.max_pages_per_seq, dtype=np.int32)
        table[:len(pages)] = pages
        self.block_tables[slot] = table

    def _adopt_prompt_pages(self, req: _Request, pages: List[int],
                            first: int) -> None:
        """Register req's full prompt pages from index `first` on into
        the prefix cache (depth = page index); registered pages belong
        to the cache, no longer to the request.  A full prompt page
        never receives later writes, so it is immutable."""
        own = []
        for i in range(first, len(req.prompt) // self.page_size):
            page = pages[i]
            if self.prefix_cache.register(req.chain_keys[i], page, i):
                req.cache_keys.append(req.chain_keys[i])
                own.append(page)
        req.pages = [p for p in req.pages if p not in own]

    def _admit(self) -> Dict[int, List[int]]:
        done: Dict[int, List[int]] = {}
        free = self._free_slots()
        # Phase 1: admit (slot + page allocation, table build) WITHOUT
        # prefilling, so phase 2 can batch uncached prompts of one length
        # bucket into a single prefill call.
        admitted: List[tuple] = []  # (req, shared, pages, start)
        # Prompt-page keys the CURRENT wave will register: a same-wave
        # request sharing a prefix is deferred one step so it admits
        # against the registered cache instead of recomputing it.
        pending_keys: set = set()
        while self.waiting and free:
            req = self.waiting[0]
            if req.kv_bundle is not None:
                # Imported KV needs no prefill (budget-exempt).
                if not self._admit_import(req, free, done):
                    break
                continue
            L = len(req.prompt)
            total = math.ceil((L + req.max_new_tokens) / self.page_size)

            # Prefix-cache hit: reuse the longest chain of FULL prompt
            # pages, capped so at least one prompt token is recomputed
            # (its logits seed the first generated token).
            shared: List[int] = []
            if self.prefix_cache is not None:
                if req.chain_keys is None:
                    req.chain_keys = PrefixCache.chain_hashes(
                        req.prompt, self.page_size, L // self.page_size)
                if req.chain_keys and req.chain_keys[0] in pending_keys:
                    break  # defer: this wave is computing its prefix
                matchable = max(0, (L - 1) // self.page_size)
                shared = self.prefix_cache.match(
                    req.chain_keys[:matchable])
                req.cache_keys = req.chain_keys[:len(shared)]
            n_private = total - len(shared)
            n_suffix = L - len(shared) * self.page_size
            over_budget = ((admitted or self.num_active or self._inflight)
                           and n_suffix > self._step_prefill_left)
            if n_private > self._available_pages() or over_budget:
                # Backpressure (pages) or the step's prefill budget is
                # spent: release the reservation and wait; an idle engine
                # admits regardless of the budget.
                if self.prefix_cache is not None and req.cache_keys:
                    self.prefix_cache.release(req.cache_keys)
                    req.cache_keys = []
                break
            self._step_prefill_left = max(
                0, self._step_prefill_left - n_suffix)
            self.waiting.pop(0)
            self._note_admitted(req)
            req.pages = self._alloc_evicting(n_private)
            pages = shared + req.pages
            self._seat(req, free.pop(0), pages)
            if self.prefix_cache is not None and req.chain_keys:
                pending_keys.update(req.chain_keys[:L // self.page_size])
            admitted.append((req, shared, pages,
                             len(shared) * self.page_size))

        # Phase 2: prefill.  Uncached prompts (start == 0) batch by pow-2
        # suffix bucket; cache-hit suffixes take the per-request chunked
        # path (their table widths differ).
        groups: Dict[int, List[tuple]] = {}
        singles: List[tuple] = []
        for item in admitted:
            req, shared, pages, start = item
            n_suffix = len(req.prompt) - start
            S = max(8, 1 << (n_suffix - 1).bit_length())
            if start == 0:
                groups.setdefault(S, []).append(item)
            else:
                singles.append((item, S))

        for S, items in groups.items():
            # Batch dim bucketed pow-2 (pad rows carry positions -1, so
            # their K/V writes go to the scratch page).
            B = 1 << (len(items) - 1).bit_length()
            tokens = np.zeros((B, S), dtype=np.int32)
            positions = np.full((B, S), -1, dtype=np.int32)
            tables = np.zeros((B, self.max_pages_per_seq), dtype=np.int32)
            for r, (req, _, _, _) in enumerate(items):
                L = len(req.prompt)
                tokens[r, :L] = req.prompt
                positions[r, :L] = np.arange(L)
                tables[r] = self.block_tables[req.slot]
            tokens, positions, tables = self._upload(tokens, positions,
                                                     tables)
            logits, self.cache = prefill(self.params, tokens, positions,
                                         self.cache, tables, self.config)
            logits = logits.cpu().numpy()  # one sync for the whole group
            self._iterations += 1
            for r, item in enumerate(items):
                self._finish_admit(item, logits[r], done)

        for (item, S) in singles:
            req, shared, pages, start = item
            L = len(req.prompt)
            n_suffix = L - start
            tokens = np.zeros((1, S), dtype=np.int32)
            tokens[0, :n_suffix] = req.prompt[start:]
            positions = np.full((1, S), -1, dtype=np.int32)
            positions[0, :n_suffix] = np.arange(start, L)
            # The chunked prefill gathers the WHOLE table width as
            # context: bucket it to the pages this prompt spans (pow-2).
            W = min(self.max_pages_per_seq, max(1, 1 << (
                math.ceil(L / self.page_size) - 1).bit_length()))
            table = self.block_tables[req.slot]
            tokens, positions, table = self._upload(tokens, positions,
                                                    table[None, :W])
            logits, self.cache = prefill_with_context(
                self.params, tokens, positions, self.cache, table,
                self.config)
            self._iterations += 1
            self._finish_admit(item, logits.cpu().numpy()[0], done)
        return done

    def _finish_admit(self, item: tuple, logits_row: np.ndarray,
                      done: Dict[int, List[int]]) -> None:
        """Post-prefill bookkeeping for one admitted request: adopt its
        full prompt pages into the prefix cache, sample the first token,
        arm the decode slot."""
        req, shared, pages, start = item
        L = len(req.prompt)
        if self.prefix_cache is not None:
            if shared:
                self.prefix_cache.hits += 1
                self.prefix_cache.tokens_saved += start
            self._adopt_prompt_pages(req, pages, len(shared))

        next_tok = self._sample(logits_row, req)
        self.context_lens[req.slot] = L
        self.last_tokens[req.slot] = next_tok
        req.generated.append(int(next_tok))
        self._stamp_first(req)
        self._just_admitted.add(req.slot)  # the pipelined path merges it
        fin = self._maybe_finish(req)
        if fin is not None:  # e.g. max_new_tokens == 1
            done[req.req_id] = fin

    def _admit_import(self, req: _Request, free: List[int],
                      done: Dict[int, List[int]]) -> bool:
        """Seat one KV-import request: match shared prompt pages against
        the LOCAL prefix cache (only the other context pages are
        spliced), allocate the rest, write the imported pages into the
        cache in one call (splice_kv_pages), and arm the decode slot at
        the exported context.  False on page backpressure (the request
        stays at the head of the queue)."""
        bundle = req.kv_bundle
        L = len(req.prompt)
        ps = self.page_size
        ctx = int(bundle["context_len"])
        total = math.ceil((L + req.max_new_tokens) / ps)
        n_ctx = max(1, math.ceil(ctx / ps))
        full = L // ps
        shared: List[int] = []
        if self.prefix_cache is not None:
            if req.chain_keys is None:
                req.chain_keys = PrefixCache.chain_hashes(req.prompt, ps,
                                                          full)
            # No (L-1) cap here: the first token is already generated,
            # so ALL full prompt pages are reusable.
            shared = self.prefix_cache.match(req.chain_keys[:full])
            req.cache_keys = req.chain_keys[:len(shared)]
        n_shared = len(shared)
        n_private = total - n_shared
        if n_private > self._available_pages():
            if self.prefix_cache is not None and req.cache_keys:
                self.prefix_cache.release(req.cache_keys)
                req.cache_keys = []
            return False
        self.waiting.pop(0)
        self._note_admitted(req)
        slot = free.pop(0)
        req.pages = self._alloc_evicting(n_private)
        pages = shared + req.pages
        self._seat(req, slot, pages)

        # Splice the non-shared context pages (pow-2 padded; -1 rows go
        # to the scratch page).  Pages 0..n_shared-1 already hold the
        # same KV locally through the prefix cache.
        n_splice = n_ctx - n_shared
        nbytes = 0
        if n_splice > 0:
            k = np.asarray(bundle["k"])[:, n_shared:n_ctx]
            v = np.asarray(bundle["v"])[:, n_shared:n_ctx]
            nbytes = k.nbytes + v.nbytes
            N = 1 << (n_splice - 1).bit_length()
            ids = np.full(N, -1, dtype=np.int32)
            ids[:n_splice] = pages[n_shared:n_ctx]
            pad = ((0, 0), (0, N - n_splice), (0, 0), (0, 0))
            self.cache = splice_kv_pages(
                self.cache, self._device_pages(np.pad(k, pad)),
                self._device_pages(np.pad(v, pad)), *self._upload(ids))

        # Adopt the full prompt pages into the local prefix cache (valid
        # after the splice) so later requests sharing the prefix hit.
        if self.prefix_cache is not None and req.chain_keys:
            if shared:
                self.prefix_cache.hits += 1
                self.prefix_cache.tokens_saved += n_shared * ps
            self._adopt_prompt_pages(req, pages, n_shared)

        self.context_lens[slot] = ctx
        self.last_tokens[slot] = req.generated[-1]
        self._stamp_first(req)  # splice done; tokens already exist
        self._just_admitted.add(slot)
        self.kv_imports += 1
        _KV_HANDOFF.inc(tags={"direction": "import"})
        _KV_HANDOFF_BYTES.inc(nbytes, tags={"direction": "import"})
        flight_recorder.record(
            "serve", "kv_import", req_id=req.req_id, pages=n_splice,
            shared_pages=n_shared, bytes=nbytes)
        req.kv_bundle = None  # release the page arrays
        _QUEUE_DEPTH.set(len(self.waiting))
        fin = self._maybe_finish(req)
        if fin is not None:
            done[req.req_id] = fin
        return True

    def _device_pages(self, arr: np.ndarray) -> torch.Tensor:
        """Bundle pages as a tensor of the cache's dtype on the device;
        bf16 pages arrive as bfloat16 (the reference's ml_dtypes arrays)
        or as their uint16 bits, and are read through the bits."""
        arr = np.ascontiguousarray(arr)
        if self.config.dtype == torch.bfloat16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(self.device)

    # -- packed admission (greedy pipelined path) --------------------------
    def _seg_len(self, prompt_len: int) -> int:
        """Pow-2 page-multiple bucket a prompt pads to inside a packed
        row (pow-2 >= page_size is automatically a page multiple)."""
        return max(self.page_size, 1 << (prompt_len - 1).bit_length())

    def _wave_eligible(self, req: _Request) -> bool:
        """Packed admission serves greedy, prefix-cache-miss prompts;
        sampling needs host logits, cache hits the chunked program and
        imported KV a splice: all stay on the classic path."""
        if not self.packed_admit or req.temperature > 0.0:
            return False
        if req.kv_bundle is not None:
            return False
        if self.prefix_cache is not None:
            L = len(req.prompt)
            if req.chain_keys is None:
                req.chain_keys = PrefixCache.chain_hashes(
                    req.prompt, self.page_size, L // self.page_size)
            matchable = max(0, (L - 1) // self.page_size)
            if self.prefix_cache.peek(req.chain_keys[:matchable]) > 0:
                return False
        return True

    def _dispatch_prefill_wave(self) -> int:
        """Admit a FIFO prefix of wave-eligible same-bucket requests in
        ONE call (packed_prefill_admit): prompts pack into rows, K/V
        pages are written, first greedy tokens computed and the device
        decode state updated, with no wait on the card.  The first
        tokens surface at reconcile time.  Returns the number seated."""
        if not self.packed_admit or not self._pipelined_ok():
            return 0
        free = self._free_slots()
        if not free or not self.waiting:
            return 0
        batch: List[_Request] = []
        head_sl = None
        budget = min(self.prefill_wave_tokens, self._step_prefill_left)
        budget0 = budget
        # Same-wave shared-prefix dedup (as classic _admit's
        # pending_keys): a request whose prefix THIS wave registers
        # defers one step, then admits through the cache-hit path.
        pending_keys: set = set()
        while self.waiting and free:
            req = self.waiting[0]
            if not self._wave_eligible(req):
                break
            if req.chain_keys and req.chain_keys[0] in pending_keys:
                break
            L = len(req.prompt)
            sl = self._seg_len(L)
            if head_sl is None:
                head_sl = sl
            elif sl != head_sl:
                break  # the next bucket gets its own wave next step
            if budget < sl and (batch or self.num_active or self._inflight):
                # Budget spent (or too small for the bucket): live decode
                # work keeps the card; an idle engine still admits the
                # head so progress is never starved.
                break
            total = math.ceil((L + req.max_new_tokens) / self.page_size)
            if total > self._available_pages():
                break  # backpressure: wait for pages
            self.waiting.pop(0)
            self._note_admitted(req)
            req.slot = free.pop(0)
            req.pages = self._alloc_evicting(total)
            if self.prefix_cache is not None and req.chain_keys:
                pending_keys.update(req.chain_keys[:L // self.page_size])
            batch.append(req)
            budget -= sl
        if not batch:
            return 0
        self._step_prefill_left = max(
            0, self._step_prefill_left - (budget0 - budget))
        # Fold pending host-side slot changes in BEFORE the wave slots
        # become live: a freed-slot merge arriving after the wave would
        # overwrite the wave's device-computed rows.
        self._sync_dstate()

        seg_len = head_sl
        ps = self.page_size
        segs_per_row = max(1, self.prefill_row_tokens // seg_len)
        rows = math.ceil(len(batch) / segs_per_row)
        R = 1 << (rows - 1).bit_length()
        S_row = segs_per_row * seg_len
        nseg = R * segs_per_row
        seg_pages = seg_len // ps
        tokens = np.zeros((R, S_row), dtype=np.int32)
        positions = np.full((R, S_row), -1, dtype=np.int32)
        row_tables = np.zeros((R, S_row // ps), dtype=np.int32)
        seg_slot = np.full(nseg, self.max_batch, dtype=np.int32)
        seg_limit = np.zeros(nseg, dtype=np.int32)
        seg_eos = np.full(nseg, -1, dtype=np.int32)
        for i, req in enumerate(batch):
            r, si = divmod(i, segs_per_row)
            L = len(req.prompt)
            j0 = si * seg_len
            tokens[r, j0:j0 + L] = req.prompt
            positions[r, j0:j0 + L] = np.arange(L)
            npg = min(len(req.pages), seg_pages)
            row_tables[r, si * seg_pages:si * seg_pages + npg] = \
                req.pages[:npg]
            seg_slot[i] = req.slot
            seg_limit[i] = L + req.max_new_tokens - 1
            seg_eos[i] = -1 if req.eos_token is None else req.eos_token
            self._seat(req, req.slot, req.pages)
            self.context_lens[req.slot] = L
            self.slot_req[req.slot] = req
            # Wave slots are device-authoritative from here on.  Adopt
            # the full prompt pages now: later matches run behind this
            # call on the card's stream.
            if self.prefix_cache is not None and req.chain_keys:
                self._adopt_prompt_pages(req, list(req.pages), 0)

        first, self.cache, *_ = packed_prefill_admit(
            self.params, *self._upload(tokens, positions, row_tables,
                                       seg_slot, seg_limit, seg_eos),
            self.cache, *self._dstate.unbind(0), self.config, seg_len)
        host, event = download(first)
        self._inflight.append({
            "type": "prefill", "first": host, "event": event,
            "segs": list(batch), "planned": {req.slot: 1 for req in batch}})
        self.waves_dispatched += 1
        return len(batch)

    def _eager_reconcile(self, done: Dict[int, List[int]]) -> None:
        """Fold in the in-flight records whose results have already
        reached the host (their event has fired): no waiting.  On the
        CPU nothing is in flight ahead of the host, so records wait for
        their turn as the pipeline depth says."""
        while self._inflight:
            event = self._inflight[0]["event"]
            if event is None or not event.query():
                break
            self._reconcile_oldest(done)

    # -- pipelined chunk decode (greedy multi-step) ------------------------
    def _slot_state_rows(self, slot: int):
        """Host-authoritative device-state row for one slot: live slots
        mirror the armed decode state; empty slots read as dead
        (pos=-1, ctx=0) so the device skips their attention and sends
        their writes to the scratch page."""
        req = self.slot_req[slot]
        if req is None:
            return 0, -1, 0, -1, -1
        cl = int(self.context_lens[slot])
        limit = len(req.prompt) + req.max_new_tokens - 1
        eos = req.eos_token if req.eos_token is not None else -1
        return int(self.last_tokens[slot]), cl, cl + 1, limit, eos

    def _sync_dstate(self) -> None:
        """Create or update the device-chained decode state.  A full
        upload only happens entering pipelined mode; afterwards host
        slot changes (admissions, frees) fold in through ONE upload and
        merge_slot_state's masked select in place, never a read-back."""
        B = self.max_batch
        if self._dstate is None:
            rows = np.array([self._slot_state_rows(s) for s in range(B)],
                            dtype=np.int32).T
            self._dstate = upload(self.graphs.state, rows)
            self._just_admitted.clear()
            self._dirty_slots.clear()
            return
        changed = self._just_admitted | self._dirty_slots
        if not changed:
            return
        new = np.zeros((6, B), dtype=np.int32)
        for s in changed:
            new[0, s] = 1
            new[1:, s] = self._slot_state_rows(s)
        (new_d,) = self._upload(new)
        merge_slot_state(*self._dstate.unbind(0), new_d[0].bool(),
                         *new_d[1:].unbind(0))
        self._just_admitted.clear()
        self._dirty_slots.clear()

    def _inflight_tokens(self, slot: int) -> int:
        """Upper bound on tokens already dispatched for the slot's
        current request in records not yet reconciled.

        The port departs from the reference's code here, which has the
        same fault: it sums `planned[slot]` over every record, so after
        an abort the records dispatched for the aborted request count
        against the slot's next occupant, which is then left out of
        later chunks and never finishes.  A record counts only where its
        snapshot (a wave: its segments) holds the current request."""
        req = self.slot_req[slot]
        total = 0
        for ch in self._inflight:
            if ch.get("type") == "prefill":
                held = any(r is req for r in ch["segs"])
            else:
                held = ch["snapshot"].get(slot) is req
            if held:
                total += ch["planned"].get(slot, 0)
        return total

    def _table_width(self, max_pos: int) -> int:
        """Pow-2 bucket of the table width that covers positions below
        max_pos: the decode's reads scale with it, and each bucket is one
        graph."""
        pages_needed = max(1, math.ceil(max_pos / self.page_size))
        return min(self.max_pages_per_seq,
                   1 << (pages_needed - 1).bit_length())

    def _dispatch_chunk(self) -> bool:
        """Dispatch one multi_step chunk off the device-chained state (a
        graph replay on a CUDA device).  Never waits on the card: its
        inputs are the state already there and the block tables, which
        go up through pinned memory.  False when every expected token is
        already in flight."""
        n = self.multi_step
        snapshot: Dict[int, _Request] = {}
        planned: Dict[int, int] = {}
        max_ub = 1
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            rem = (req.max_new_tokens - len(req.generated)
                   - self._inflight_tokens(slot))
            if rem > 0:
                snapshot[slot] = req
                planned[slot] = min(n, rem)
                # Furthest position this chunk can WRITE for the slot.
                max_ub = max(max_ub, int(self.context_lens[slot])
                             + self._inflight_tokens(slot) + min(n, rem))
        if not snapshot:
            return False
        self._sync_dstate()
        upload(self.graphs.tables, self.block_tables)
        out = self.graphs.multi_step(self._table_width(max_ub), n)
        host, event = download(out)
        self._inflight.append({"out": host, "event": event,
                               "snapshot": snapshot, "planned": planned,
                               "n": n})
        return True

    def _reconcile_oldest(self, done: Dict[int, List[int]]) -> None:
        """Read the oldest in-flight record's tokens (the only point the
        pipelined path waits on the card) and replay them into host
        state: append tokens, advance context mirrors, finish and free
        requests.  Rows of slots that stopped on the card (limit, EOS)
        carry -1 past the stop."""
        ch = self._inflight.pop(0)
        if ch.get("type") == "prefill":
            self.prefill_reconciles += 1
            first = read(ch["first"], ch["event"])
            self._iterations += 1
            for i, req in enumerate(ch["segs"]):
                if self.slot_req[req.slot] is not req:
                    continue
                tok = int(first[i])
                # Keep the host mirror authoritative: a switch to the
                # classic path resumes decoding from last_tokens.
                self.last_tokens[req.slot] = tok
                req.generated.append(tok)
                self._stamp_first(req)
                fin = self._maybe_finish(req)
                if fin is not None:
                    done[req.req_id] = fin
                    self._dirty_slots.add(req.slot)
            return
        toks = read(ch["out"], ch["event"])
        self._iterations += ch["n"]
        for slot, req in ch["snapshot"].items():
            if self.slot_req[slot] is not req:
                continue  # finished in an earlier record; rows are -1
            for j in range(ch["n"]):
                tok = int(toks[slot, j])
                if tok < 0:
                    break
                self.context_lens[slot] += 1
                self.last_tokens[slot] = tok
                req.generated.append(tok)
                fin = self._maybe_finish(req)
                if fin is not None:
                    done[req.req_id] = fin
                    # Zero the slot on the device at the next merge, so
                    # in-flight chunks stop reading its freed pages.
                    self._dirty_slots.add(slot)
                    break

    def _flush_pipeline(self, done: Dict[int, List[int]]) -> None:
        """Drain every in-flight record and drop the device state (host
        mirrors become authoritative): the classic path and mode
        switches run against host state."""
        while self._inflight:
            self._reconcile_oldest(done)
        self._dstate = None
        self._just_admitted.clear()
        self._dirty_slots.clear()

    # -- speculative decoding ----------------------------------------------
    def _draft_for(self, req: _Request, k: int) -> List[int]:
        """Prompt-lookup drafting (n-gram match): copy what followed the
        most recent earlier occurrence of the trailing n-gram.  The
        n-gram -> latest-start index grows incrementally, so a step
        costs O(new_tokens * n + k)."""
        n = self.spec_ngram
        P = len(req.prompt)
        L = P + len(req.generated)
        if k <= 0 or L <= n:
            return []

        def tok(i: int) -> int:
            return req.prompt[i] if i < P else req.generated[i - P]

        # Index n-grams that have at least one continuation token
        # (ending at position <= L-2), from where we left off.
        for j in range(max(req.indexed_upto, n - 1), L - 1):
            gram = tuple(tok(j - n + 1 + t) for t in range(n))
            req.ngram_index[gram] = j - n + 1
        req.indexed_upto = max(req.indexed_upto, L - 1)
        tail = tuple(tok(L - n + t) for t in range(n))
        i = req.ngram_index.get(tail)
        if i is None:
            return []
        return [tok(p) for p in range(i + n, min(i + n + k, L))]

    def _spec_decode_batch(self, items: List[tuple]
                           ) -> Dict[int, List[int]]:
        """Verify every eligible slot's [last_token, draft...] in ONE
        batched chunked forward; returns {slot: new tokens} after
        updating slot state.  The first rejected position still yields
        the model's own token, so each slot advances by >= 1."""
        B = len(items)
        # Every axis is pow-2 bucketed, B included (pad rows carry
        # position -1: K/V to the scratch page, logits ignored).
        Bb = 1 << (B - 1).bit_length()
        n_chunks = [1 + len(d) for _, _, d in items]
        S = max(2, 1 << (max(n_chunks) - 1).bit_length())
        max_end = max(int(self.context_lens[s]) + n
                      for (s, _, _), n in zip(items, n_chunks))
        W = min(self.max_pages_per_seq, max(1, 1 << (
            math.ceil(max_end / self.page_size) - 1).bit_length()))
        tokens = np.zeros((Bb, S), dtype=np.int32)
        positions = np.full((Bb, S), -1, dtype=np.int32)
        tables = np.zeros((Bb, W), dtype=np.int32)
        for r, ((slot, req, draft), n_chunk) in enumerate(
                zip(items, n_chunks)):
            cl = int(self.context_lens[slot])
            tokens[r, 0] = self.last_tokens[slot]
            tokens[r, 1:n_chunk] = draft
            positions[r, :n_chunk] = np.arange(cl, cl + n_chunk)
            tables[r] = self.block_tables[slot][:W]
        tokens, positions, tables = self._upload(tokens, positions, tables)
        logits, self.cache = verify_step(self.params, tokens, positions,
                                         self.cache, tables, self.config)
        preds_all = logits.argmax(dim=-1).cpu().numpy()
        self._iterations += 1

        advanced: Dict[int, List[int]] = {}
        for r, ((slot, req, draft), n_chunk) in enumerate(
                zip(items, n_chunks)):
            preds = preds_all[r, :n_chunk]
            accepted: List[int] = []
            for i, d in enumerate(draft):
                if int(preds[i]) != d:
                    break
                accepted.append(d)
            # The model's token at the first mismatch (or after a full
            # acceptance) comes free from the same forward.
            new_tokens = accepted + [int(preds[len(accepted)])]
            # Rejected drafts' K/V sit beyond the new context length;
            # the attention mask hides them until overwritten.
            self.context_lens[slot] = \
                int(self.context_lens[slot]) + len(new_tokens)
            self.last_tokens[slot] = new_tokens[-1]
            self.spec_drafted += len(draft)
            self.spec_accepted += len(accepted)
            advanced[slot] = new_tokens
        self.spec_steps += 1
        return advanced

    def _decode(self) -> Dict[int, List[int]]:
        """The classic step: speculative slots (speculative_k > 0) verify
        their drafts, every other live slot takes one decode step (a
        graph replay on a CUDA device) and samples from its logits."""
        done: Dict[int, List[int]] = {}
        spec_slots: set = set()
        if self.spec_k > 0:
            eligible = []
            for slot, req in enumerate(self.slot_req):
                if req is None or req.temperature > 0.0:
                    continue  # sampling needs the rejection-free path
                remaining = req.max_new_tokens - len(req.generated)
                if remaining < 2:
                    continue
                draft = self._draft_for(req,
                                        min(self.spec_k, remaining - 1))
                if draft:
                    eligible.append((slot, req, draft))
            if eligible:
                advanced = self._spec_decode_batch(eligible)
                for slot, req, _ in eligible:
                    spec_slots.add(slot)
                    for tok in advanced[slot]:
                        req.generated.append(tok)
                        fin = self._maybe_finish(req)
                        if fin is not None:
                            # EOS / max inside the accepted block: the
                            # tokens past it are discarded.
                            done[req.req_id] = fin
                            break
            if all(r is None or s in spec_slots
                   for s, r in enumerate(self.slot_req)):
                return done

        active = np.array([r is not None and s not in spec_slots
                           for s, r in enumerate(self.slot_req)])
        # Idle slots get position -1: their K/V rows go to the scratch
        # page instead of page 0 offset 0 via their zeroed tables, which
        # would corrupt whichever sequence owns page 0.
        positions = np.where(active, self.context_lens, -1).astype(np.int32)
        ctx = (self.context_lens + 1).astype(np.int32)
        # Bucket the table width to the longest live context (pow-2):
        # the decode reads O(B * W * page) per layer.
        upload(self.graphs.state[:3],
               np.stack([self.last_tokens, positions, ctx]))
        upload(self.graphs.tables, self.block_tables)
        logits = self.graphs.decode_step(
            self._table_width(int(ctx.max(initial=1)))).cpu().numpy()
        self._iterations += 1
        for slot, req in enumerate(self.slot_req):
            if req is None or slot in spec_slots:
                continue  # spec slots already advanced this step
            self.context_lens[slot] += 1
            tok = self._sample(logits[slot], req)
            self.last_tokens[slot] = tok
            req.generated.append(int(tok))
            fin = self._maybe_finish(req)
            if fin is not None:
                done[req.req_id] = fin
        return done

    def _sample(self, logits: np.ndarray, req: _Request) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        p = logits / req.temperature
        p = np.exp(p - p.max())
        p = p / p.sum()
        return int(self._rng.choice(len(p), p=p))

    def _maybe_finish(self, req: _Request) -> Optional[List[int]]:
        """Register req into its slot, or retire it if done.  Returns the
        generated tokens when finished."""
        hit_eos = (req.eos_token is not None
                   and req.generated
                   and req.generated[-1] == req.eos_token)
        if len(req.generated) >= req.max_new_tokens or hit_eos:
            if req.slot >= 0:
                if req.export_on_finish:
                    # Capture the pages before they are freed below.  ctx
                    # from the invariant (KV written for the prompt and
                    # every generated token but the last), not from
                    # context_lens, which runs ahead when a speculative
                    # block finishes early and drops its tail.
                    ctx = len(req.prompt) + len(req.generated) - 1
                    self.kv_ready[req.req_id] = self._kv_bundle(
                        req, req.slot, ctx)
                    while len(self.kv_ready) > KV_READY_MAX:
                        self.kv_ready.pop(next(iter(self.kv_ready)))
                self.slot_req[req.slot] = None
                self.context_lens[req.slot] = 0
                self.allocator.free(req.pages)
                if self.prefix_cache is not None and req.cache_keys:
                    # Shared/registered prompt pages stay cached
                    # (evictable once unreferenced).
                    self.prefix_cache.release(req.cache_keys)
            self._note_finished(req)
            self.num_completed += 1
            return req.generated
        self.slot_req[req.slot] = req
        return None


def _check_bundle_fields(bundle: Any) -> None:
    """A serve_kv_export bundle's fields and their types, as the
    reference's wire schema checks them (ValueError otherwise)."""
    if not isinstance(bundle, dict):
        raise ValueError(f"KV bundle must be a dict, got "
                         f"{type(bundle).__name__}")
    if bundle.get("op") != "serve_kv_export":
        raise ValueError(
            f"expected serve_kv_export bundle, got {bundle.get('op')}")
    for name, (types, required) in _KV_EXPORT_FIELDS.items():
        if bundle.get(name) is None:
            if required:
                raise ValueError(f"KV bundle missing required field "
                                 f"{name!r}")
            continue
        if types is not None and not isinstance(bundle[name], types):
            raise ValueError(f"KV bundle field {name!r}: expected "
                             f"{types}, got {type(bundle[name]).__name__}")
    extra = set(bundle) - set(_KV_EXPORT_FIELDS) - {"op"}
    if extra:
        raise ValueError(f"KV bundle has undeclared fields {sorted(extra)}")


def _host_pages(t: torch.Tensor) -> np.ndarray:
    """Pages as a numpy array: float32 as is, bf16 as an ml_dtypes.bfloat16
    array over the same bits.  numpy has no bfloat16 of its own, and the
    reference's import_kv compares the array's dtype name with its cache's
    ("bfloat16"), so a bundle of bits typed uint16 would be refused there.
    ml_dtypes is a standalone numpy dtype package (not the JAX package),
    imported at this boundary only."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _cast_tree(tree, dtype: torch.dtype, device: torch.device):
    """Floating leaves of a param dict cast to `dtype` on `device`."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, device) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)
