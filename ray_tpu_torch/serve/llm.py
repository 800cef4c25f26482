"""LLM serving deployment: the paged-attention engine behind serve.

Port of ray_tpu/serve/llm.py.  Counterpart of the reference's
vLLM-on-Ray serving recipe (compiled DAGs + NCCL channels, SURVEY.md
P12) as a first-class deployment: each replica owns one LLMEngine
(continuous batching over a paged KV cache on its card); serve's
router/pow-2 scheduler spreads requests across replicas.

Usage:
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMServer
    handle = serve.run(LLMServer.options(
        ray_actor_options={"num_gpus": 1}).bind(config_kwargs={...}),
        name="llm")
    tokens = handle.generate.remote([1, 2, 3], max_new_tokens=8).result()
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.serve.deployment import deployment
from ray_tpu_torch.serve import llm_engine as _eng
from ray_tpu_torch.serve.llm_engine import (PrefixCache,
                                            RequestShed, _env_float, _env_int)
from ray_tpu_torch.util import flight_recorder, tracing


def _request_trace() -> Optional[tuple]:
    """(trace_id, parent_span_id) for the CURRENT replica call: the
    request-journey context the ingress proxy minted, parented under
    this replica call's pre-allocated span (replica.py _prepare_call),
    so engine phase spans nest inside the replica leg.  None outside a
    replica request, or when the call is untraced."""
    from ray_tpu_torch.serve.replica import _live_request_context

    ctx = _live_request_context()
    if ctx is None or ctx.trace_ctx is None:
        return None
    return (ctx.trace_ctx[0], ctx.span_id or ctx.trace_ctx[1])


@deployment(name="llm_server")
class LLMServer:
    """One replica = one engine + one background engine thread.

    Replica request handlers run in a thread pool (replica.py
    max_concurrency), and the engine itself is synchronous, so a single
    engine thread runs step() and concurrent generate() calls SHARE
    decode batches (continuous batching across requests) instead of
    serializing.  `params` may come from checkpoint_path (a pickle of
    the reference's parameter tree with numpy leaves) or be random from
    the engine's `seed` (tests).

    Departure from the reference's loop (ray_tpu/serve/llm.py
    _engine_loop), which holds its condition across every engine.step()
    and calls into the engine from handler threads under it: here ONLY
    the engine thread calls into the LLMEngine (step, add_request,
    abort, import_kv, kv_ready, and the reads behind stats()).  Other
    threads hand such a call to it through `_calls`, drained between
    steps, and wait on a future that carries its result or exception.
    step() runs outside `_cv`, which is taken only to publish results,
    sheds, errors and stream progress, and to wake waiters.  Reasons:
    the engine is not thread-safe (stats() iterating the prefix cache
    while a step inserts into it would raise); PyTorch's current CUDA
    stream is per thread, so device work issued from handler threads
    beside the engine thread's graph replays would race; and a stream's
    poll, a load report or a new request then waits at most one step
    (a pipelined Llama-2-7B step takes 127-140 ms on an H100, PERF.md),
    where under the reference's lock it waits until the engine thread
    happens to be descheduled."""

    def __init__(self, config_kwargs: Optional[Dict[str, Any]] = None, *,
                 config: Optional[tfm.TransformerConfig] = None,
                 checkpoint_path: Optional[str] = None,
                 page_size: int = 16, num_pages: int = 512,
                 max_batch: int = 8, **engine_kwargs):
        """Extra engine knobs pass through to LLMEngine (multi_step,
        pipeline_depth, enable_prefix_caching, speculative_k, seed,
        device, ...).  The engine runs on the card unless `device` says
        otherwise, so a replica without a GPU lease raises here.
        Serving guidance on an H100 (PERF.md): page_size >= 64 and
        multi_step 16-32 with the default pipelined dispatch keep the
        card busy while bounding admission latency; the tiny defaults
        here suit CPU tests.  On a CUDA device every decode graph the
        engine can ask for is captured here, up front: a capture
        synchronizes the card, and so does a profiler's stop from
        another thread."""
        if config is None:
            config = tfm.TransformerConfig.tiny(**(config_kwargs or {}))
        params = None
        if checkpoint_path:
            import pickle

            with open(checkpoint_path, "rb") as f:
                tree = pickle.load(f)
            params = tfm.params_from_numpy(
                tree, config, device=engine_kwargs.get("device"))
        from ray_tpu_torch.serve.llm_engine import LLMEngine

        self.engine = LLMEngine(
            config, params, page_size=page_size, num_pages=num_pages,
            max_batch=max_batch, **engine_kwargs)
        # Every decode graph now (counted in engine.graphs.captures and
        # .capture_seconds); nothing to capture on the CPU.
        self.engine.graphs.capture_all(self.engine.multi_step)
        self._cv = threading.Condition()
        self._results: Dict[int, List[int]] = {}
        self._shed: Dict[int, str] = {}
        self._engine_error: Optional[BaseException] = None
        # Calls handed to the engine thread: (fn, future), FIFO.
        self._calls: collections.deque = collections.deque()
        # Open streams: req_id -> the engine's request (engine thread
        # only), and req_id -> a copy of its tokens so far, published
        # under _cv after every step for the streams' polls.
        self._streams: Dict[int, Any] = {}
        self._progress: Dict[int, List[int]] = {}
        # Exported KV bundles ride the object plane; pinning the refs
        # here keeps them alive until the decode replica has pulled them
        # (bounded ring: old exports age out).
        self._export_ring = collections.deque(maxlen=64)
        self.handoff_fallbacks = 0
        self._stopped = False
        self._thread = threading.Thread(
            target=self._engine_loop, daemon=True, name="llm-engine")
        self._thread.start()
        if self.engine.device.type == "cuda":
            # The runtime's torch_trace starts and stops its profiler
            # session on the engine thread, the one that replays graphs.
            from ray_tpu_torch.core import runtime

            runtime.set_profile_runner(self._on_engine)

    # -- the engine thread -------------------------------------------------
    def _engine_loop(self):
        eng = self.engine
        while True:
            with self._cv:
                while (not self._calls and not self._stopped
                       and not eng.has_work()):
                    self._cv.wait(timeout=1.0)
                if self._stopped:
                    break
                calls = list(self._calls)
                self._calls.clear()
            for fn, fut in calls:
                try:
                    fut.set_result(fn())
                except BaseException as e:  # noqa: BLE001 (to the caller)
                    fut.set_exception(e)
            if not eng.has_work():
                continue
            try:
                done = eng.step()
            except Exception as e:  # noqa: BLE001
                # A dead engine must fail waiters loudly, not hang them:
                # record the error and wake everyone.
                with self._cv:
                    self._engine_error = e
                    self._cv.notify_all()
                break
            shed = dict(eng.shed)
            eng.shed.clear()
            for rid in list(done) + list(shed):
                self._streams.pop(rid, None)
            progress = {rid: list(req.generated)
                        for rid, req in self._streams.items()}
            with self._cv:
                self._shed.update(shed)
                self._results.update(done)
                self._progress.update(progress)
                self._cv.notify_all()
        self._fail_calls()

    def _fail_calls(self):
        """Fail every call still queued once the engine thread has left
        its loop (engine death or a stopped server)."""
        with self._cv:
            calls = list(self._calls)
            self._calls.clear()
            err = self._dead_error()
        for _, fut in calls:
            fut.set_exception(err)

    def _dead_error(self) -> RuntimeError:
        if self._engine_error is not None:
            return RuntimeError(f"LLM engine failed: {self._engine_error}")
        return RuntimeError("LLM server stopped")

    def _on_engine(self, fn: Callable[[], Any]) -> Any:
        """Run fn() on the engine thread, between two steps, and return
        its result (or raise its exception) here."""
        fut: Future = Future()
        with self._cv:
            if self._engine_error is not None or self._stopped:
                raise self._dead_error()
            self._calls.append((fn, fut))
            self._cv.notify_all()
        return fut.result()

    def _wait_locked(self, ids: Sequence[int]) -> List[List[int]]:
        """Wait (self._cv held) until every id finishes; raises on shed
        requests and engine death."""
        while not all(i in self._results for i in ids):
            if self._engine_error is not None:
                raise RuntimeError(
                    f"LLM engine failed: {self._engine_error}")
            for i in ids:
                if i in self._shed:
                    reason = self._shed.pop(i)
                    raise RequestShed(
                        f"request {i} shed before completion "
                        f"({reason})")
            self._cv.wait()
        return [self._results.pop(i) for i in ids]

    def _submit_and_wait(self, prompts: Sequence[Sequence[int]],
                         max_new_tokens: int, temperature: float
                         ) -> List[List[int]]:
        trace = _request_trace()
        ids = self._on_engine(lambda: [self.engine.add_request(
            list(p), max_new_tokens, temperature=temperature,
            trace_ctx=trace) for p in prompts])
        with self._cv:
            return self._wait_locked(ids)

    def generate(self, prompt_tokens: Sequence[int],
                 max_new_tokens: int = 32,
                 temperature: float = 0.0) -> List[int]:
        return self._submit_and_wait([prompt_tokens], max_new_tokens,
                                     temperature)[0]

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int = 32,
                       temperature: float = 0.0) -> List[List[int]]:
        return self._submit_and_wait(prompts, max_new_tokens, temperature)

    # -- prefill/decode disaggregation ------------------------------------
    def _done_bundle(self, rid: int, prompt: List[int],
                     toks: List[int]) -> Dict[str, Any]:
        """serve_kv_export-shaped message for a generation that is
        already complete: "done" carries the tokens, no pages ride."""
        return {"op": "serve_kv_export", "req": rid,
                "prompt": prompt, "generated": list(toks),
                "context_len": 0,
                "page_size": self.engine.page_size,
                "num_layers": self.engine.config.num_layers,
                "kd": 0, "dtype": "", "done": list(toks)}

    def prefill_only(self, prompt_tokens: Sequence[int],
                     max_new_tokens: int = 32,
                     temperature: float = 0.0) -> Dict[str, Any]:
        """Run admission + prefill for a request here, then EXPORT its
        KV pages instead of decoding (the prefill leg of disaggregated
        serving).  The request is submitted with a 1-token budget and
        export_on_finish: the engine captures the KV bundle at finish
        time, before the pages are freed, so the capture cannot race
        the engine thread (a polled export could miss fast requests
        that complete within one multi-token step).  Returns a
        `serve_kv_import` pointer message — the bundle itself rides the
        object plane, pinned in a bounded ring until the decode replica
        pulls it — or the inline `serve_kv_export` bundle when no
        cluster runtime is up (unit tests, benchmarks).  A request
        whose full budget is a single token returns a bundle with
        "done" set: the caller skips the decode leg entirely."""
        import ray_tpu_torch

        prompt = list(prompt_tokens)
        trace = _request_trace()
        rid = self._on_engine(lambda: self.engine.add_request(
            prompt, 1, temperature=temperature,
            export_on_finish=True, trace_ctx=trace))
        with self._cv:
            toks = self._wait_locked([rid])[0]
        bundle = self._on_engine(lambda: self.engine.kv_ready.pop(rid, None))
        if bundle is None or max_new_tokens <= 1:
            # Generation complete (1-token budget), or the bundle was
            # evicted from kv_ready before we got here: return the
            # finished tokens inline; the caller skips the decode leg.
            # (On eviction with budget > 1 the DONE tokens are still
            # only the prefill token — resume via re-prefill.)
            if bundle is None and max_new_tokens > 1:
                return self._done_bundle(rid, prompt,
                                         self._submit_and_wait(
                                             [prompt], max_new_tokens,
                                             temperature)[0])
            return self._done_bundle(rid, prompt, toks)
        if trace is not None:
            # Cross-replica linkage: the decode replica parents its
            # handoff-pull span under THIS prefill leg's replica span,
            # stitching the two legs into one request-journey trace.
            bundle["trace"] = [trace[0], trace[1]]
        if not ray_tpu_torch.is_initialized():
            return bundle
        ref = ray_tpu_torch.put(bundle)
        self._export_ring.append(ref)
        size = int(bundle["k"].nbytes + bundle["v"].nbytes)
        out = {"op": "serve_kv_import", "obj": ref._hex, "size": size}
        if trace is not None:
            out["trace"] = [trace[0], trace[1]]
        return out

    def decode_from(self, prompt_tokens: Sequence[int],
                    kv: Dict[str, Any],
                    max_new_tokens: int = 32,
                    temperature: float = 0.0) -> List[int]:
        """Resume generation from an exported KV bundle (the decode leg
        of disaggregated serving).  `kv` is either the serve_kv_import
        pointer from prefill_only (pulled off the object plane here) or
        an inline serve_kv_export bundle.  A failed pull or an
        incompatible bundle falls back to re-prefilling locally — the
        request is NEVER lost, just slower (counted in
        ray_tpu_serve_handoff_fallback_total)."""
        from ray_tpu_torch.core import wire_schema

        prompt = list(prompt_tokens)
        bundle: Any = kv
        reason: Optional[str] = None
        trace = _request_trace()
        # Trace linkage carried IN the handoff payload: [trace_id,
        # prefill_replica_span_id].  The pull span parents under the
        # prefill leg, so the two replicas' spans stitch into one
        # request journey with no side-channel.
        link = (list(kv["trace"]) if isinstance(kv, dict)
                and kv.get("trace") else None)
        if isinstance(kv, dict) and kv.get("op") == "serve_kv_import":
            t_pull = time.time()
            try:
                import ray_tpu_torch
                from ray_tpu_torch.core.ids import ObjectID
                from ray_tpu_torch.core.object_ref import ObjectRef

                wire_schema.validate(kv)
                ref = ObjectRef(ObjectID.from_hex(kv["obj"]))
                bundle = ray_tpu_torch.get(ref, timeout=_env_float(
                    "RAY_TPU_SERVE_HANDOFF_TIMEOUT_S", 30.0))
            except Exception:  # noqa: BLE001
                bundle, reason = None, "pull_failed"
            if isinstance(bundle, dict) and bundle.get("trace"):
                link = list(bundle["trace"])
            if link or trace:
                anchor = link or [trace[0], trace[1]]
                tracing.record_span(
                    "serve.handoff_pull", t_pull, time.time(),
                    attributes={"bytes": int(kv.get("size") or 0),
                                "ok": reason is None,
                                "clock_off": round(
                                    tracing.clock_offset(), 6)},
                    parent_id=anchor[1] or None, trace_id=anchor[0],
                    force=True)
        elif isinstance(bundle, dict) and bundle.get("trace"):
            link = list(bundle["trace"])
        if isinstance(bundle, dict) and bundle.get("done") is not None:
            return list(bundle["done"])
        rid = None
        if reason is None:
            try:
                rid = self._on_engine(lambda: self.engine.import_kv(
                    bundle, max_new_tokens, temperature=temperature,
                    trace_ctx=trace or (tuple(link) if link else None)))
            except (ValueError, TypeError, KeyError):
                # Malformed/incompatible bundle (SchemaError is a
                # ValueError).  QueueFull and engine death propagate:
                # re-prefilling HERE couldn't admit either.
                reason = "import_failed"
        if reason is not None:
            with self._cv:
                self.handoff_fallbacks += 1
            _eng._HANDOFF_FALLBACK.inc(tags={"reason": reason})
            flight_recorder.record("serve", "handoff_fallback",
                                   reason=reason, req=-1)
            return self._submit_and_wait(
                [prompt], max_new_tokens, temperature)[0]
        with self._cv:
            return self._wait_locked([rid])[0]

    def _open_stream(self, prompt: List[int], max_new_tokens: int,
                     temperature: float, trace: Optional[tuple]) -> int:
        """(Engine thread.)  Add a streamed request and register it, so
        the loop publishes its tokens after every step."""
        rid = self.engine.add_request(prompt, max_new_tokens,
                                      temperature=temperature,
                                      trace_ctx=trace)
        self._streams[rid] = next(r for r in self.engine.waiting
                                  if r.req_id == rid)
        with self._cv:
            self._progress[rid] = []
        return rid

    def _cancel(self, rid: int) -> None:
        """(Engine thread.)  Abort a streamed request and forget it."""
        self.engine.abort(rid, "cancelled")
        self.engine.shed.pop(rid, None)
        self._streams.pop(rid, None)
        self._forget(rid)

    def _forget(self, rid: int) -> None:
        with self._cv:
            self._shed.pop(rid, None)
            self._results.pop(rid, None)
            self._progress.pop(rid, None)

    def _cancel_stream(self, rid: int) -> None:
        """Abort a streamed request from a handler thread; with the
        engine dead or stopped there is nothing to abort."""
        try:
            self._on_engine(lambda: self._cancel(rid))
        except RuntimeError:
            self._forget(rid)

    def generate_stream(self, prompt_tokens: Sequence[int],
                        max_new_tokens: int = 32,
                        temperature: float = 0.0):
        """Generator: yields tokens AS the engine decodes them — call
        through handle.options(stream=True) (or the HTTP proxy's
        streaming mode) for streamed chat completions.  The request
        still rides the shared continuous-batching engine loop, which
        publishes a copy of its tokens after every step.

        Cancellation: when called through a streaming proxy the request
        context carries a cancel_event (replica.cancel_stream sets it
        on client disconnect); the poll loop observes it and aborts the
        engine request so its slot + KV pages free immediately.  The
        same cleanup runs if the consumer close()s this generator."""
        from ray_tpu_torch.serve.replica import _live_request_context

        ctx = _live_request_context()
        cancel = ctx.cancel_event if ctx is not None else None
        trace = None
        if ctx is not None and ctx.trace_ctx is not None:
            trace = (ctx.trace_ctx[0], ctx.span_id or ctx.trace_ctx[1])
        prompt = list(prompt_tokens)
        rid = self._on_engine(lambda: self._open_stream(
            prompt, max_new_tokens, temperature, trace))
        sent = 0
        try:
            while True:
                with self._cv:
                    if self._engine_error is not None:
                        raise RuntimeError(
                            f"LLM engine failed: {self._engine_error}")
                    cancelled = cancel is not None and cancel.is_set()
                    if not cancelled:
                        if rid in self._shed:
                            self._progress.pop(rid, None)
                            raise RequestShed(
                                f"request {rid} shed before completion "
                                f"({self._shed.pop(rid)})")
                        finished = rid in self._results
                        toks = (self._results[rid] if finished
                                else self._progress.get(rid, []))
                        if not finished and len(toks) == sent:
                            self._cv.wait(timeout=0.05)
                            continue
                        if finished:
                            self._results.pop(rid, None)
                            self._progress.pop(rid, None)
                if cancelled:
                    self._cancel_stream(rid)
                    return
                for t in toks[sent:]:
                    yield int(t)
                sent = len(toks)
                if finished:
                    return
        except GeneratorExit:
            # Consumer dropped the stream mid-generation.
            self._cancel_stream(rid)
            raise

    def _stats(self) -> Dict[str, Any]:
        """(Engine thread.)  The engine's counters, its prefix digest
        and the SLO samples drained from its ring."""
        eng = self.engine
        out = {
            "active": eng.num_active,
            "waiting": len(eng.waiting),
            "free_pages": eng.allocator.num_free,
            "num_pages": eng.allocator.num_pages,
            "num_completed": eng.num_completed,
            "num_shed": eng.num_shed,
            "num_aborted": eng.num_aborted,
            "max_queue": eng.max_queue,
            "kv_exports": eng.kv_exports,
            "kv_imports": eng.kv_imports,
            "handoff_fallbacks": self.handoff_fallbacks,
        }
        if eng.prefix_cache is not None:
            # Compact hot-prefix digest: rides the load report so
            # the router can prefix-match incoming prompts against
            # what this replica already has cached.
            out["prefix_digest"] = {
                "op": "serve_prefix_digest",
                "keys": eng.prefix_cache.digest(
                    _env_int("RAY_TPU_SERVE_DIGEST_K", 16)),
            }
        if eng.slo_samples:
            # Drain the per-request SLO ring: samples ride the load
            # report exactly once, to the controller's sliding
            # windows (serve_slo / /api/serve_slo).
            samples = list(eng.slo_samples)
            eng.slo_samples.clear()
            out["slo_samples"] = samples
        if eng.engine_sample is not None:
            out["engine_sample"] = eng.engine_sample
        return out

    def stats(self) -> Dict[str, Any]:
        return self._on_engine(self._stats)

    def __del__(self):
        self._stopped = True


class DisaggLLMClient:
    """Client-side orchestration of disaggregated serving: prefill on
    the prefill pool (routed by prefix locality), decode on the decode
    pool (routed by free KV pages), the KV pages riding the object
    plane between them.  Either leg failing degrades to plain mixed
    serving on the decode handle — a request is never lost.

    Usage:
        pre = serve.get_deployment_handle("prefill", app_name="llm")
        dec = serve.get_deployment_handle("decode", app_name="llm")
        client = DisaggLLMClient(pre, dec, page_size=16)
        tokens = client.generate([1, 2, 3], max_new_tokens=8)
    """

    def __init__(self, prefill_handle, decode_handle, *,
                 page_size: int = 16,
                 timeout_s: Optional[float] = None):
        self.prefill = prefill_handle
        self.decode = decode_handle
        self.page_size = page_size
        self.timeout_s = (timeout_s if timeout_s is not None
                          else _env_float(
                              "RAY_TPU_SERVE_HANDOFF_TIMEOUT_S", 30.0))
        self.handoffs = 0
        self.fallbacks = 0

    def _prefix_hint(self, prompt: List[int]) -> List[str]:
        """Truncated-hex chain keys of the prompt's full pages — the
        same form replicas publish in their load-report digest, so the
        router can longest-prefix match them."""
        full = len(prompt) // self.page_size
        if full <= 0:
            return []
        keys = PrefixCache.chain_hashes(prompt, self.page_size, full)
        return [k.hex()[:16] for k in keys]

    def generate(self, prompt_tokens: Sequence[int],
                 max_new_tokens: int = 32,
                 temperature: float = 0.0, *,
                 trace_ctx: Optional[tuple] = None) -> List[int]:
        prompt = list(prompt_tokens)
        # Request-journey threading across BOTH legs: explicit
        # trace_ctx wins; otherwise inherit the live replica request's
        # context (composition: an ingress deployment driving this
        # client), so prefill and decode replica spans share one trace.
        trace = trace_ctx or _request_trace()
        kv = None
        try:
            h = self.prefill.options(
                phase="prefill", prefix_hint=self._prefix_hint(prompt))
            if trace is not None:
                h = h.options(trace_ctx=trace)
            kv = h.prefill_only.remote(
                prompt, max_new_tokens, temperature).result(
                    timeout_s=self.timeout_s)
        except Exception:  # noqa: BLE001
            # No prefill pool / replica died mid-prefill: mixed-mode
            # degradation on the decode pool.  The request survives.
            self.fallbacks += 1
            _eng._HANDOFF_FALLBACK.inc(tags={"reason": "prefill_failed"})
            flight_recorder.record("serve", "handoff_fallback",
                                   reason="prefill_failed", req=-1)
        if kv is None:
            h = self.decode
            if trace is not None:
                h = h.options(trace_ctx=trace)
            return h.generate.remote(
                prompt, max_new_tokens, temperature).result(
                    timeout_s=self.timeout_s)
        if isinstance(kv, dict) and kv.get("done") is not None:
            return list(kv["done"])
        self.handoffs += 1
        h = self.decode.options(phase="decode")
        if trace is not None:
            h = h.options(trace_ctx=trace)
        return h.decode_from.remote(
            prompt, kv, max_new_tokens, temperature).result(
                timeout_s=self.timeout_s)
