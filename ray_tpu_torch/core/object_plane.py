"""Object-plane transfer managers: demand pulls and push broadcast.

Counterpart of the reference's PushManager/PullManager pair
(src/ray/object_manager/object_manager.h:206 — push_manager chunk
scheduling; pull_manager.h:52 — memory-bounded admission).

PULL side (`PullManager` + `pull_into_store`): demand-driven transfer
used by runtime._pull_remote_object against node_manager/head
`fetch_chunk` servers.  Chunks are windowed (rpc.pull_object_chunked)
and land DIRECTLY in a pre-created arena segment — no full-size
intermediate buffer, no extra copy on the cache path — and concurrent
pulls of one object are single-flighted: the first caller drives the
wire, everyone else waits on its outcome and attaches to the sealed
segment (reference pull_manager.h request coalescing).

PUSH side (`PushManager`) — one source fans an object's chunks out to N
node arenas concurrently, under a global in-flight byte budget, so a
1-GiB broadcast to a cluster neither serializes per node nor floods
memory/sockets.

Admission control exists on BOTH ends:
  - sender: a byte-budget semaphore caps the total chunk payload in
    flight across every destination (the PullManager idea applied to
    pushes); destinations stream independently, so one slow or dead
    node never stalls the others.
  - receiver: `push_begin` allocates the object up front from the
    node's arena and REJECTS (not blocks) when the arena can't hold
    it; partial transfers are reaped by age so an aborted sender never
    leaks arena memory.

Failure model: per-destination isolation.  A node dying mid-broadcast
fails that one destination (reported in the result map); the remaining
destinations complete — pinned by tests/test_chaos.py.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.log_once import warn_once

logger = logging.getLogger(__name__)

# Cached lazy import: util/__init__ pulls in placement groups → runtime
# → this module, so a top-level flight-recorder import here would cycle
# (same shape as rpc._flight_recorder).
_flight = None


def _flight_recorder():
    global _flight
    if _flight is None:
        try:
            from ray_tpu_torch.util import flight_recorder as fr

            _flight = fr
        except Exception:
            _flight = False
    return _flight


def _record(event: str, **fields) -> None:
    fr = _flight_recorder()
    if fr:
        fr.record("object", event, **fields)


class _ObjPlaneStats:
    """Process-wide object-plane telemetry, exported through
    util/metrics.py via object_metric_snapshots() — same pattern as
    rpc._WireStats: a module-level singleton so the transfer hot path
    never touches the metrics registry."""

    def __init__(self):
        self.lock = threading.Lock()
        self.bytes_pulled = 0
        self.bytes_pushed = 0
        self.pulls_started = 0
        self.pulls_deduped = 0
        self.pull_errors = 0
        self.arena_cache_hits = 0
        self.arena_cache_stores = 0
        self.arena_cache_failures = 0

    def _inc(self, field: str, n: int = 1):
        with self.lock:
            setattr(self, field, getattr(self, field) + n)


OBJ = _ObjPlaneStats()


def object_metric_snapshots() -> list:
    """This process's object-plane counters as metric-snapshot dicts in
    the util/metrics.py exposition shape (merged into local_snapshots()).
    Locality-hit counting lives head-side in gcs.py as a registry
    Counter — placement decisions only happen there."""
    o = OBJ
    with o.lock:
        bytes_pulled, bytes_pushed = o.bytes_pulled, o.bytes_pushed
        started, deduped, errors = (o.pulls_started, o.pulls_deduped,
                                    o.pull_errors)
        hits, stores, failures = (o.arena_cache_hits,
                                  o.arena_cache_stores,
                                  o.arena_cache_failures)
    return [
        {"name": "object_transfer_bytes_total", "kind": "counter",
         "description": "Object-plane payload bytes moved between nodes",
         "series": {(("direction", "pulled"),): float(bytes_pulled),
                    (("direction", "pushed"),): float(bytes_pushed)}},
        {"name": "object_pulls_total", "kind": "counter",
         "description": "Object pulls by outcome (deduped = coalesced "
                        "onto an in-flight pull of the same object)",
         "series": {(("result", "started"),): float(started),
                    (("result", "deduped"),): float(deduped),
                    (("result", "error"),): float(errors)}},
        {"name": "object_arena_cache_total", "kind": "counter",
         "description": "Local-arena replica cache events for remote "
                        "objects (hit = later read served from shm)",
         "series": {(("event", "hit"),): float(hits),
                    (("event", "store"),): float(stores),
                    (("event", "failure"),): float(failures)}},
    ]


# -- rate-limited arena-cache diagnostics -----------------------------------
# Caching a pulled object into the local arena is best-effort, but the
# old bare `except Exception: pass` made a persistently full arena
# undiagnosable (every read re-pulled over the wire, silently).  Warn
# once per distinct cause per interval (shared impl: core/log_once.py).


def _warn_arena_cache(exc: BaseException, obj_hex: str = "") -> None:
    OBJ._inc("arena_cache_failures")
    warn_once(logger, "arena-cache", exc,
              "could not cache pulled object %s in the local arena "
              "(reads will keep pulling over the wire)",
              obj_hex or "<unknown>")


class PullManager:
    """Single-flight table for concurrent pulls of one object
    (reference pull_manager.h request coalescing): the first caller
    becomes the leader and drives the wire; callers arriving while that
    pull is in flight wait on its event and share the outcome.  An
    error propagates to every waiter, and the entry is cleared BEFORE
    waiters wake so a retry re-pulls instead of joining the corpse."""

    class _Flight:
        __slots__ = ("done", "result", "error")

        def __init__(self):
            self.done = threading.Event()
            self.result: Any = None
            self.error: Optional[BaseException] = None

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: Dict[str, "PullManager._Flight"] = {}

    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def pull(self, obj_hex: str, fn: Callable[[], Any],
             timeout: float = 600.0) -> Any:
        """Run `fn` single-flighted under `obj_hex`; concurrent callers
        for the same key block on the leader and receive its result (or
        its exception)."""
        with self._lock:
            fl = self._inflight.get(obj_hex)
            if fl is None:
                fl = self._Flight()
                self._inflight[obj_hex] = fl
                leader = True
            else:
                leader = False
        if not leader:
            OBJ._inc("pulls_deduped")
            _record("dedup_join", obj=obj_hex)
            if not fl.done.wait(timeout):
                raise TimeoutError(
                    f"waited {timeout}s on an in-flight pull of "
                    f"{obj_hex}")
            if fl.error is not None:
                raise fl.error
            return fl.result
        try:
            fl.result = fn()
            return fl.result
        except BaseException as e:
            fl.error = e
            raise
        finally:
            # Clear the entry first, wake waiters second: a waiter that
            # sees the error and retries must start a FRESH flight.
            with self._lock:
                self._inflight.pop(obj_hex, None)
            fl.done.set()


def pull_into_store(client, store, obj_hex: str, size: int, chunk: int,
                    *, window: Optional[int] = None,
                    timeout: float = 120.0) -> Tuple[Any, bool]:
    """Pull an object's bytes from the peer behind `client`, landing
    chunks directly in a pre-created local arena segment (reference
    ObjectBufferPool: chunks write into the plasma allocation, not an
    intermediate buffer).  Returns (data, cached): `data` is a buffer
    of the payload (a zero-copy view of the sealed segment when caching
    succeeded), `cached` says whether the local store now holds a
    replica.

    Failure model: a wire error mid-pull deletes the partial segment
    (nothing half-written survives in the arena) and re-raises; arena
    failures (full, race) degrade to an uncached in-memory pull with a
    rate-limited warning.
    """
    OBJ._inc("pulls_started")
    peer = getattr(client, "address", "")
    _record("pull_begin", obj=obj_hex,
                           peer=peer, bytes=size)
    t0 = time.monotonic()
    from ray_tpu_torch.core import rpc

    oid = ObjectID.from_hex(obj_hex)
    seg = None
    if store is not None:
        try:
            seg = store.create(oid, size)
        except Exception as e:  # noqa: BLE001 — cache is best-effort
            _warn_arena_cache(e, obj_hex)
    try:
        if seg is None:
            data = rpc.pull_object_chunked(client, obj_hex, size, chunk,
                                           timeout=timeout, window=window)
            cached = False
        else:
            try:
                rpc.pull_object_chunked(client, obj_hex, size, chunk,
                                        timeout=timeout, window=window,
                                        into=seg.buf)
            except BaseException:
                # Reap the partial segment: an aborted pull must not
                # leave a half-written object for attach() to find.
                try:
                    store.delete(oid)
                except Exception as e:  # noqa: BLE001
                    # A reap failure leaks an arena block per aborted
                    # pull — that slow leak must be visible.
                    warn_once(logger, "arena-reap", e,
                              "could not reap partial segment for %s",
                              obj_hex)
                raise
            data, cached = _seal_and_reattach(store, oid, obj_hex, size,
                                              seg)
    except BaseException:
        OBJ._inc("pull_errors")
        _record("pull_end", obj=obj_hex,
                               peer=peer, bytes=size, ok=False,
                               duration_s=round(time.monotonic() - t0, 6))
        raise
    OBJ._inc("bytes_pulled", size)
    if cached:
        OBJ._inc("arena_cache_stores")
    _record("pull_end", obj=obj_hex, peer=peer,
                           bytes=size, ok=True, cached=cached,
                           duration_s=round(time.monotonic() - t0, 6))
    return data, cached


def _seal_and_reattach(store, oid, obj_hex: str, size: int,
                       seg) -> Tuple[Any, bool]:
    """Seal a fully-written segment and return a fresh read view.
    seal() evicts the creator's writable view in the native arena (its
    block may be reused once the create pin drops), so the bytes MUST
    be re-read through attach()."""
    try:
        store.seal(oid)
    except Exception as e:  # noqa: BLE001
        # Unsealed: the creator's view is still pinned and readable.
        # Copy out, drop the segment, serve uncached.
        _warn_arena_cache(e, obj_hex)
        data = bytes(seg.buf[:size])
        try:
            store.delete(oid)
        except Exception as e2:  # noqa: BLE001
            warn_once(logger, "arena-reap", e2,
                      "could not drop unsealed segment for %s", obj_hex)
        return data, False
    try:
        view = store.attach(oid, size)
        return view.buf[:size], True
    except Exception as e:  # noqa: BLE001
        # Sealed but unreadable here (pin race): the replica EXISTS —
        # report cached=True — but these bytes must come from a copy.
        _warn_arena_cache(e, obj_hex)
        return bytes(seg.buf[:size]), True


class PushManager:
    """Fan one local object's bytes out to peer node arenas."""

    def __init__(self, runtime, *, chunk_bytes: Optional[int] = None,
                 max_inflight_bytes: int = 64 * 1024 * 1024):
        self._rt = runtime
        self.chunk_bytes = max(
            1 << 20, chunk_bytes or runtime.config.transfer_chunk_bytes)
        self._max_inflight_bytes = max_inflight_bytes

    def broadcast(self, obj_hex: str, size: int,
                  destinations: Sequence[str], *,
                  timeout: float = 600.0) -> Dict[str, str]:
        """Push object bytes to every destination address concurrently.

        Returns {address: "ok" | "have" | "reject: ..." | "error: ..."}.
        The source segment is the local arena copy (it must exist
        here); each destination streams independently on its own node
        connection.
        """
        seg = self._rt.store.attach(ObjectID.from_hex(obj_hex), size)
        results: Dict[str, str] = {}
        lock = threading.Lock()
        # PER-DESTINATION budgets, one global total: a destination that
        # stalls inside a blocking send (partitioned peer with the TCP
        # connection held open) can pin at most ITS OWN permits — the
        # documented "one slow or dead node never stalls the others"
        # invariant would not survive a shared semaphore.
        per_dest = max(1, (self._max_inflight_bytes // self.chunk_bytes)
                       // max(1, len(destinations)))
        budgets = {a: threading.BoundedSemaphore(per_dest)
                   for a in destinations}

        def one(addr: str):
            try:
                results_val = self._push_one(addr, obj_hex, size, seg,
                                             timeout, budgets[addr])
            except Exception as e:  # noqa: BLE001 — per-dest isolation
                results_val = f"error: {type(e).__name__}: {e}"
            with lock:
                results[addr] = results_val

        threads = [threading.Thread(target=one, args=(a,), daemon=True,
                                    name=f"push-{a}")
                   for a in destinations]
        for t in threads:
            t.start()
        # ONE deadline across every join — sequential full-timeout joins
        # would make the worst case len(destinations) * timeout.
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        for a in destinations:
            with lock:
                results.setdefault(a, "error: timeout")
        return results

    def _push_one(self, addr: str, obj_hex: str, size: int, seg,
                  timeout: float, budget) -> str:
        t0 = time.monotonic()
        _record("push_begin", obj=obj_hex,
                               peer=addr, bytes=size)
        try:
            status = self._push_one_inner(addr, obj_hex, size, seg,
                                          timeout, budget)
        except BaseException as e:
            _record(
                "push_end", obj=obj_hex, peer=addr, bytes=size,
                ok=False, status=f"error: {type(e).__name__}",
                duration_s=round(time.monotonic() - t0, 6))
            raise
        if status in ("ok", "have"):
            if status == "ok":
                OBJ._inc("bytes_pushed", size)
            _record(
                "push_end", obj=obj_hex, peer=addr, bytes=size,
                ok=True, status=status,
                duration_s=round(time.monotonic() - t0, 6))
        else:
            _record(
                "push_end", obj=obj_hex, peer=addr, bytes=size,
                ok=False, status=status,
                duration_s=round(time.monotonic() - t0, 6))
        return status

    def _push_one_inner(self, addr: str, obj_hex: str, size: int, seg,
                        timeout: float, budget) -> str:
        from ray_tpu_torch.core import rpc

        conn = self._rt._node_conn(addr)
        begin = conn.call({"op": "push_begin", "obj": obj_hex,
                           "size": size}, timeout=30.0)
        if begin.get("have"):
            return "have"
        if begin.get("reject"):
            return f"reject: {begin['reject']}"
        deadline = time.monotonic() + timeout
        window = rpc.pull_window()
        if window <= 1:
            self._stream_legacy(conn, addr, obj_hex, size, seg, budget,
                                deadline)
        else:
            self._stream_windowed(conn, addr, obj_hex, size, seg,
                                  budget, deadline, timeout, window)
        reply = conn.call({"op": "push_end", "obj": obj_hex},
                          timeout=timeout)
        if not (reply or {}).get("ok"):
            return f"error: {(reply or {}).get('error', 'push_end failed')}"
        return "ok"

    def _stream_legacy(self, conn, addr: str, obj_hex: str, size: int,
                       seg, budget, deadline: float) -> None:
        """RAY_TPU_PULL_WINDOW=1: the legacy wire byte for byte —
        ONE-WAY chunk frames, serialized by the blocking send.  The TCP
        stream orders chunks, a blocking send applies receiver
        backpressure, and push_end's byte-count check catches any
        loss.  wait=True keeps the budget accounting honest under rpc
        coalescing (the slot must not be released while the chunk still
        sits in the send buffer)."""
        off = 0
        while off < size:
            n = min(self.chunk_bytes, size - off)
            budget.acquire()
            try:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"broadcast to {addr} timed out")
                conn.send({"op": "push_chunk", "obj": obj_hex,
                           "offset": off,
                           "data": bytes(seg.buf[off:off + n])},
                          wait=True)
            finally:
                budget.release()
            off += n

    def _stream_windowed(self, conn, addr: str, obj_hex: str,
                         size: int, seg, budget, deadline: float,
                         timeout: float, window: int) -> None:
        """Windowed chunk pipeline, mirroring rpc.pull_object_chunked:
        up to `window` push_chunk call_asyncs stay in flight, so the
        peer writes chunk k while chunk k+1 rides the wire — one
        round-trip TOTAL of pipeline fill instead of one serialized
        send per chunk.  The per-destination budget still bounds
        in-flight bytes: a slot is held from issue until the peer's
        ack, and acquire(blocking=False) can only fail while our own
        chunks hold slots, so popping the oldest ack always makes
        progress (no deadlock)."""
        inflight: deque = deque()  # (offset, pending call)
        off = 0
        try:
            while inflight or off < size:
                while off < size and len(inflight) < window \
                        and budget.acquire(blocking=False):
                    if time.monotonic() > deadline:
                        budget.release()
                        raise TimeoutError(
                            f"broadcast to {addr} timed out")
                    n = min(self.chunk_bytes, size - off)
                    try:
                        pending = conn.call_async(
                            {"op": "push_chunk", "obj": obj_hex,
                             "offset": off,
                             "data": bytes(seg.buf[off:off + n])})
                    except BaseException:
                        budget.release()
                        raise
                    inflight.append((off, pending))
                    off += n
                _chunk_off, pending = inflight.popleft()
                try:
                    reply = pending.result(
                        timeout=max(0.1, min(
                            timeout, deadline - time.monotonic())))
                finally:
                    budget.release()
                if reply is not None and reply.get("ok") is False:
                    raise RuntimeError(
                        f"peer rejected chunk at {_chunk_off}")
        except BaseException:
            # Abandon outstanding requests (late acks are dropped by
            # the recv loop) and give their budget slots back.
            while inflight:
                _o, pending = inflight.popleft()
                try:
                    pending.discard()
                finally:
                    budget.release()
            raise


def broadcast_object(ref, node_ids: Optional[List[str]] = None, *,
                     chunk_bytes: Optional[int] = None,
                     max_inflight_bytes: int = 64 * 1024 * 1024,
                     timeout: float = 600.0) -> Dict[str, str]:
    """Push a shm-resident object to other nodes' arenas ahead of use
    (reference `ObjectManager::Push`): consumers there then read shm
    locally instead of pulling over the wire at first access.

    node_ids: target node ids (default: every alive non-head node that
    doesn't already hold a copy).  Returns {node_id: status}.
    """
    from ray_tpu_torch.core.runtime import get_runtime

    rt = get_runtime()
    core = getattr(rt, "core", rt)
    obj_hex = ref.hex() if hasattr(ref, "hex") else str(ref)
    info = core.client.call({"op": "object_info", "obj": obj_hex},
                            timeout=30.0)
    if not info or not info.get("in_shm"):
        raise ValueError(
            f"broadcast_object needs a sealed shm object; {obj_hex} is "
            f"{'inline' if info else 'unknown'}")
    holder = info.get("node", "head")
    if holder != core.store_node:
        # The push source streams from the LOCAL arena; a copy living
        # on another node would fail deep inside store.attach with an
        # arena-internal error — say what is actually wrong instead.
        raise ValueError(
            f"broadcast_object must run where the object lives: "
            f"{obj_hex} is in node {holder!r}'s arena, this process is "
            f"on {core.store_node!r} (fetch it locally first, or "
            "broadcast from that node)")
    nodes = core.client.call({"op": "list_nodes"}, timeout=30.0)
    targets = []
    for n in nodes:
        if not n.get("alive") or n.get("is_head"):
            continue
        if node_ids is not None and n["node_id"] not in node_ids:
            continue
        targets.append((n["node_id"], n["address"]))
    pm = PushManager(core, chunk_bytes=chunk_bytes,
                     max_inflight_bytes=max_inflight_bytes)
    by_addr = pm.broadcast(obj_hex, info["size"],
                           [a for _, a in targets], timeout=timeout)
    return {nid: by_addr.get(a, "error: missing")
            for nid, a in targets}
