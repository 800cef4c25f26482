"""Minimal TCP RPC: length-prefixed pickled messages, threaded server.

Counterpart of the reference's gRPC substrate (src/ray/rpc/).  grpcio is not
available in this environment, so the control plane speaks a tiny framed
protocol over TCP sockets:

    [1-byte kind][8-byte request id][4-byte len][pickle payload]

kind: 0 = request (expects response), 1 = response, 2 = one-way,
      3 = JSON request (payload is UTF-8 JSON; response is JSON too),
      5 = batch (payload is one pickle of [(kind, req_id, payload), ...]),
      6 = JSON batch (payload is a JSON array of [kind, req_id, msg]),
      7 = zero-copy envelope (pickle5 stream + out-of-band buffers,
          scatter-gathered onto the socket; see KIND_OOB below).

Kind 3 is the cross-language door (reference: the gRPC protos any
language can speak): non-Python frontends (cpp/ client) call the same
ops with JSON payloads and get `{"status": "ok"|"err", ...}` JSON back;
bytes values are transported as {"__bytes_b64__": ...}.

Kind 5/6 are the control-plane coalescing frames (reference: Ray's
batched worker↔raylet traffic): senders buffer while a write is on the
wire and flush whatever accumulated as ONE frame, so a burst of small
control messages costs a handful of sendalls instead of thousands.  The
receiver unpacks and dispatches sub-messages in order; semantics are
identical to having received each sub-frame individually.  Batches are
never nested, and the server only emits pickle batches to peers that
have themselves spoken pickle — JSON-only peers (the C++ client) keep
getting plain frames.  Set RAY_TPU_RPC_NO_BATCH=1 to disable coalescing
entirely and restore the one-frame-per-message protocol byte for byte.

Server: thread per connection, handler invoked per message; handler may
return a value (sent back as response) or None for one-way messages.
Clients are thread-safe; concurrent calls are matched by request id.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import pickle
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from ray_tpu_torch.core.log_once import warn_once

logger = logging.getLogger(__name__)

_FRAME = struct.Struct("<BQI")

KIND_REQUEST = 0
KIND_RESPONSE = 1
KIND_ONEWAY = 2
KIND_REQUEST_JSON = 3
# One-way server→client push encoded as JSON — for non-Python peers
# (the C++ worker's task delivery; cpp/include/ray_tpu/worker.h).
KIND_ONEWAY_JSON = 4
# Coalesced frame: payload pickles a list of (kind, req_id, payload)
# sub-frames, dispatched in order on the receiving side.
KIND_BATCH = 5
# Cross-language form: payload is a JSON array of [kind, req_id, msg]
# triples (kind 3 entries only; each gets its own KIND_RESPONSE).
KIND_BATCH_JSON = 6
# Zero-copy envelope: payload is [<B inner_kind><I pkl_len><I nbufs>
# <Q buf_len>*nbufs][pickle5 stream][buf0][buf1]... — large buffers
# (numpy arrays, inline object bytes) ride OUT-OF-BAND after the pickle
# stream and are scatter-gathered onto the socket with sendmsg, so a
# 64 MiB arg is never memcpy'd through the wire encoder.  Pickle-
# speaking peers only (the JSON path never emits it).
KIND_OOB = 7

_OOB_INDEX = struct.Struct("<BII")

_TRUTHY = ("1", "true", "yes", "on")


_ZC_MIN: int | None = None


def _zerocopy_min() -> int:
    """Payload size from which frames switch to scatter-gather writes
    and pickle5 buffers go out-of-band.  <= 0 disables the path
    (RAY_TPU_ZEROCOPY_MIN_BYTES; cached after first read)."""
    global _ZC_MIN
    v = _ZC_MIN
    if v is None:
        try:
            v = int(os.environ.get(
                "RAY_TPU_ZEROCOPY_MIN_BYTES", str(512 << 10)))
        except ValueError:
            v = 512 << 10
        if v <= 0:
            v = 1 << 62
        _ZC_MIN = v
    return v


def _sendmsg_all(sock: socket.socket, parts) -> None:
    """Write a scatter-gather list fully, advancing views on partial
    sends.  Equivalent to sendall(b"".join(parts)) without building the
    joined copy."""
    views = [memoryview(p).cast("B") for p in parts if len(p)]
    while views:
        n = sock.sendmsg(views)
        while n > 0 and views:
            head = views[0]
            if n >= len(head):
                n -= len(head)
                views.pop(0)
            else:
                views[0] = head[n:]
                n = 0


def _part_len(payload) -> int:
    """Wire length of a payload that is either bytes or a tuple of
    scatter-gather parts (KIND_OOB)."""
    if isinstance(payload, tuple):
        return sum(len(p) for p in payload)
    return len(payload)


def _wrap_big_bytes(msg, zc: int):
    """Shallow rewrite of a message dict: top-level bytes values (and
    bytes values one level down inside list-of-dict batches) at or over
    the zero-copy threshold are wrapped in PickleBuffer so the protocol-5
    encoder hands them to the buffer callback instead of copying them
    into the pickle stream.  Returns msg unchanged when nothing is big."""
    if not isinstance(msg, dict):
        return msg
    out = None
    for k, v in msg.items():
        if isinstance(v, (bytes, bytearray)) and len(v) >= zc:
            if out is None:
                out = dict(msg)
            out[k] = pickle.PickleBuffer(v)
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            new_list = None
            for i, item in enumerate(v):
                if not isinstance(item, dict):
                    continue
                rew = _wrap_big_bytes(item, zc)
                if rew is not item:
                    if new_list is None:
                        new_list = list(v)
                    new_list[i] = rew
            if new_list is not None:
                if out is None:
                    out = dict(msg)
                out[k] = new_list
    return msg if out is None else out


def _encode_payload(msg) -> tuple[int | None, "bytes | tuple"]:
    """Encode a message for the wire.  Returns (None, pickle_bytes)
    for ordinary messages, or (KIND_OOB, parts_tuple) when at least one
    buffer crossed the zero-copy threshold — the parts are
    (index, pickle_stream, buf0, ...) and the caller's frame kind is
    folded into the index as inner_kind at send time."""
    zc = _zerocopy_min()
    bufs: list[memoryview] = []

    def _cb(pb):
        raw = pb.raw()
        if raw.nbytes >= zc:
            bufs.append(raw.cast("B"))
            return False  # take out-of-band
        return True  # small buffers stay in the pickle stream

    pkl = pickle.dumps(_wrap_big_bytes(msg, zc), protocol=5,
                       buffer_callback=_cb)
    if not bufs:
        return None, pkl
    WIRE.on_zerocopy(sum(b.nbytes for b in bufs))
    return KIND_OOB, (pkl, *bufs)


def _oob_parts(inner_kind: int, parts: tuple) -> tuple:
    """Prefix the (pickle, bufs...) parts with the KIND_OOB index."""
    pkl = parts[0]
    bufs = parts[1:]
    index = _OOB_INDEX.pack(inner_kind, len(pkl), len(bufs))
    if bufs:
        index += struct.pack("<%dQ" % len(bufs),
                             *(len(b) for b in bufs))
    return (index, *parts)


def _decode_oob(payload) -> tuple[int, Any]:
    """Inverse of _encode_payload/_oob_parts: returns
    (inner_kind, message).  Out-of-band buffers are materialized as
    bytes sliced straight from the received payload (one copy, same as
    the in-band path) so downstream consumers keep bytes semantics."""
    mv = memoryview(payload)
    inner_kind, pkl_len, nbufs = _OOB_INDEX.unpack_from(mv, 0)
    off = _OOB_INDEX.size
    lens = ()
    if nbufs:
        lens = struct.unpack_from("<%dQ" % nbufs, mv, off)
        off += 8 * nbufs
    pkl = mv[off:off + pkl_len]
    off += pkl_len
    bufs = []
    for n in lens:
        bufs.append(bytes(mv[off:off + n]))
        off += n
    return inner_kind, pickle.loads(pkl, buffers=bufs)


def batching_enabled() -> bool:
    """Master switch for wire-level coalescing.  Checked at Client /
    Connection construction (not per send) so a process-wide
    RAY_TPU_RPC_NO_BATCH=1 restores the legacy protocol exactly."""
    return os.environ.get(
        "RAY_TPU_RPC_NO_BATCH", "").strip().lower() not in _TRUTHY


def _batch_caps() -> tuple[int, int]:
    """(max messages, max payload bytes) folded into one KIND_BATCH
    frame.  Oversized runs split into several frames within one drain
    round; a single message larger than the byte cap still goes out
    (as a plain frame) — the cap bounds coalescing, not message size."""
    try:
        msgs = int(os.environ.get("RAY_TPU_RPC_BATCH_MAX_MSGS", "512"))
    except ValueError:
        msgs = 512
    try:
        nbytes = int(os.environ.get(
            "RAY_TPU_RPC_BATCH_MAX_BYTES", str(4 << 20)))
    except ValueError:
        nbytes = 4 << 20
    return max(2, msgs), max(1 << 16, nbytes)


def _flush_us() -> int:
    """Microseconds the coalescing sender lingers before each flush.
    0 (default) keeps the first message on an idle link immediate;
    >0 trades that first-message latency for fuller batches when the
    traffic is a ping-pong request/ack chain whose turns would
    otherwise each ride their own frame."""
    try:
        return max(0, int(os.environ.get("RAY_TPU_RPC_FLUSH_US", "0")))
    except ValueError:
        return 0


def _to_jsonable(value: Any):
    if isinstance(value, (bytes, bytearray, memoryview)):
        return {"__bytes_b64__":
                base64.b64encode(bytes(value)).decode("ascii")}
    if isinstance(value, dict):
        return {str(k): _to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    return value


def _from_jsonable(value: Any):
    if isinstance(value, dict):
        if set(value) == {"__bytes_b64__"}:
            return base64.b64decode(value["__bytes_b64__"])
        return {k: _from_jsonable(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_from_jsonable(v) for v in value]
    return value


class RpcError(ConnectionError):
    pass


def pull_window() -> int:
    """In-flight fetch_chunk requests per pull (RAY_TPU_PULL_WINDOW,
    default 4).  1 restores the legacy one-chunk-at-a-time ping-pong
    byte for byte."""
    try:
        w = int(os.environ.get("RAY_TPU_PULL_WINDOW", "4"))
    except ValueError:
        w = 4
    return max(1, w)


def pull_object_chunked(client: "Client", obj_hex: str, size: int,
                        chunk: int, timeout: float = 60.0, *,
                        window: Optional[int] = None,
                        into=None) -> Optional[bytes]:
    """Pull an object's bytes via fetch_chunk requests (the cross-node
    object plane's one wire loop — shared by workers pulling from peer
    nodes and the head proxying for thin clients).

    Keeps up to `window` requests in flight, multiplexed on the
    client's request ids (reference ObjectManager chunked pull,
    object_buffer_pool.h): the peer serves chunk k+1 while chunk k is
    still on the wire, so the transfer runs at pipeline speed instead
    of one round trip per chunk.  Chunks land at fixed offsets, so
    out-of-window completion order never matters.  `into` (a writable
    buffer of at least `size` bytes — typically a pre-created arena
    segment) receives chunks directly as they arrive, skipping the
    full-size intermediate copy; the return value is then None.
    Raises on a short, oversized, or failed read."""
    chunk = max(1 << 20, chunk)
    if window is None:
        window = pull_window()
    window = max(1, int(window))
    dest = bytearray(size) if into is None else into
    inflight: deque = deque()  # (offset, length, pending call)
    next_off = 0
    try:
        while inflight or next_off < size:
            while next_off < size and len(inflight) < window:
                n = min(chunk, size - next_off)
                pending = client.call_async(
                    {"op": "fetch_chunk", "obj": obj_hex, "size": size,
                     "offset": next_off, "length": n})
                inflight.append((next_off, n, pending))
                next_off += n
            off, n, pending = inflight.popleft()
            part = pending.result(timeout=timeout)
            if not part:
                raise RpcError(f"peer no longer serves object {obj_hex}")
            if len(part) != n:
                # Offsets are fixed up front, so a short reply cannot be
                # re-requested mid-window; an oversized one must not
                # silently grow past the declared object size.  Both
                # mean the peer's copy is not the directory's object.
                raise RpcError(
                    f"peer returned {len(part)} bytes for a {n}-byte "
                    f"chunk of object {obj_hex}")
            dest[off:off + n] = part
    except BaseException:
        # Abandon outstanding requests: late responses for popped ids
        # are dropped by the recv loop instead of leaking table entries.
        for _, _, pending in inflight:
            pending.discard()
        raise
    return None if into is not None else bytes(dest)


class _RemoteTraceback(Exception):
    pass


def _send_frame(sock: socket.socket, kind: int, req_id: int, payload):
    """payload: bytes, or a tuple of scatter-gather parts (KIND_OOB /
    any frame whose payload crossed the zero-copy threshold).  Large
    payloads go out via sendmsg so the header+payload join — a full
    copy of the payload — never happens."""
    n = _part_len(payload)
    header = _FRAME.pack(kind, req_id, n)
    if isinstance(payload, tuple):
        _sendmsg_all(sock, (header, *payload))
    elif n >= _zerocopy_min():
        WIRE.on_zerocopy(n)
        _sendmsg_all(sock, (header, payload))
    else:
        sock.sendall(header + payload)
    WIRE.on_frame_sent(kind, len(header) + len(payload))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 4 << 20))
        if not chunk:
            raise RpcError("connection closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket):
    header = _recv_exact(sock, _FRAME.size)
    kind, req_id, length = _FRAME.unpack(header)
    payload = _recv_exact(sock, length) if length else b""
    return kind, req_id, payload


_KIND_NAMES = {
    KIND_REQUEST: "request", KIND_RESPONSE: "response",
    KIND_ONEWAY: "oneway", KIND_REQUEST_JSON: "request_json",
    KIND_ONEWAY_JSON: "oneway_json", KIND_BATCH: "batch",
    KIND_BATCH_JSON: "batch_json",
}

_flight = None  # lazily imported flight recorder module (or False)


def _flight_recorder():
    global _flight
    if _flight is None:
        try:
            from ray_tpu_torch.util import flight_recorder as fr

            _flight = fr
        except Exception:
            _flight = False
    return _flight


class _WireStats:
    """Process-wide wire telemetry, one lock update per FRAME (not per
    message): frames/messages/batches/bytes in both directions, per-kind
    sent counts, and a batch-size histogram whose le="1" bucket is the
    plain-frame count — coalesced-vs-plain ratio falls out of the same
    series.  Frames are syscall-bounded, so the lock is off the per-
    message hot path; exported through util/metrics.py via
    wire_metric_snapshots()."""

    BATCH_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                    256.0, 512.0)

    def __init__(self):
        self.lock = threading.Lock()
        self.frames_sent = 0
        self.msgs_sent = 0
        self.batches_sent = 0
        self.bytes_sent = 0
        self.frames_received = 0
        self.msgs_received = 0
        self.batches_received = 0
        self.bytes_received = 0
        self.sent_by_kind: dict[int, int] = {}
        self.batch_buckets = [0] * (len(self.BATCH_BOUNDS) + 1)
        self.batch_sum = 0.0
        self.batch_count = 0
        self.zerocopy_bytes = 0

    def _observe_size_locked(self, nmsgs: int):
        for i, b in enumerate(self.BATCH_BOUNDS):
            if nmsgs <= b:
                self.batch_buckets[i] += 1
                break
        else:
            self.batch_buckets[-1] += 1
        self.batch_sum += nmsgs
        self.batch_count += 1

    def on_frame_sent(self, kind: int, nbytes: int, nmsgs: int = 1):
        with self.lock:
            self.frames_sent += 1
            self.msgs_sent += nmsgs
            self.bytes_sent += nbytes
            self.sent_by_kind[kind] = self.sent_by_kind.get(kind, 0) + 1
            if nmsgs > 1:
                self.batches_sent += 1
            self._observe_size_locked(nmsgs)

    def on_frames_sent(self, entries):
        """Coalescing-sender drain round: one lock acquisition for the
        whole round's (kind, nmsgs, nbytes) frames."""
        with self.lock:
            for kind, nmsgs, nbytes in entries:
                self.frames_sent += 1
                self.msgs_sent += nmsgs
                self.bytes_sent += nbytes
                self.sent_by_kind[kind] = \
                    self.sent_by_kind.get(kind, 0) + 1
                if nmsgs > 1:
                    self.batches_sent += 1
                self._observe_size_locked(nmsgs)
        fr = _flight_recorder()
        if fr:
            for kind, nmsgs, nbytes in entries:
                if nmsgs > 1:
                    fr.record("wire", "batch_flush", msgs=nmsgs,
                              bytes=nbytes)

    def on_zerocopy(self, nbytes: int):
        """Payload bytes that reached the socket via scatter-gather
        (sendmsg) instead of being memcpy'd through the encoder."""
        with self.lock:
            self.zerocopy_bytes += nbytes

    def on_frame_received(self, kind: int, nbytes: int, nmsgs: int = 1):
        with self.lock:
            self.frames_received += 1
            self.msgs_received += nmsgs
            self.bytes_received += nbytes
            if kind in (KIND_BATCH, KIND_BATCH_JSON):
                self.batches_received += 1


WIRE = _WireStats()


def wire_metric_snapshots() -> list:
    """This process's wire counters as metric-snapshot dicts in the
    util/metrics.py exposition shape — merged into local_snapshots() so
    they publish/aggregate through the standard __metrics__/ KV path
    without rpc.py depending on the metrics registry."""
    w = WIRE
    with w.lock:
        directions = {
            "rpc_frames_total": (w.frames_sent, w.frames_received),
            "rpc_msgs_total": (w.msgs_sent, w.msgs_received),
            "rpc_batches_total": (w.batches_sent, w.batches_received),
            "rpc_bytes_total": (w.bytes_sent, w.bytes_received),
        }
        by_kind = dict(w.sent_by_kind)
        hist = [list(w.batch_buckets), w.batch_sum, w.batch_count]
        zc_bytes = w.zerocopy_bytes
    descs = {
        "rpc_frames_total": "Control-plane frames on the wire",
        "rpc_msgs_total": "Control-plane messages (batch entries count "
                          "individually)",
        "rpc_batches_total": "Coalesced KIND_BATCH frames",
        "rpc_bytes_total": "Control-plane payload bytes (incl. headers)",
    }
    snaps = []
    for name, (sent, received) in directions.items():
        snaps.append({
            "name": name, "kind": "counter", "description": descs[name],
            "series": {(("direction", "sent"),): float(sent),
                       (("direction", "received"),): float(received)},
        })
    kind_series = {
        (("direction", "sent"), ("kind", _KIND_NAMES.get(k, str(k)))):
            float(v)
        for k, v in by_kind.items() if v}
    if kind_series:
        snaps.append({
            "name": "rpc_frames_by_kind_total", "kind": "counter",
            "description": "Sent frames by wire kind",
            "series": kind_series,
        })
    snaps.append({
        "name": "ray_tpu_zerocopy_bytes_total", "kind": "counter",
        "description": "Payload bytes sent out-of-band via scatter-"
                       "gather (never copied through the wire encoder)",
        "series": {(): float(zc_bytes)},
    })
    snaps.append({
        "name": "rpc_batch_size", "kind": "histogram",
        "description": "Messages per sent frame (le=1 bucket = plain "
                       "frames; higher = coalesced)",
        "boundaries": list(_WireStats.BATCH_BOUNDS),
        "series": {(): hist},
    })
    return snaps


class _CoalescingSender:
    """Adaptive per-connection send coalescer — Nagle without the
    latency cliff.  The first message on an idle link is flushed
    IMMEDIATELY on the enqueuing thread (no timer, no added latency);
    messages arriving while that write is still on the wire pile into
    the buffer, and the draining thread flushes whatever accumulated as
    ONE KIND_BATCH frame when the in-flight sendall returns.  An
    uncontended link therefore produces byte-for-byte the unbatched
    protocol (single-entry rounds keep the plain frame encoding), while
    contended links amortize framing, syscalls, and lock handoffs.

    Payloads are pre-encoded by the caller, so per-entry size is known
    here and the receiver's sub-dispatch is identical to the plain
    path.  One instance guards one socket; `wire_lock` is the owner's
    existing socket write lock (JSON responses and legacy paths still
    write under it directly, so batched and direct frames never
    interleave mid-frame)."""

    def __init__(self, sock: socket.socket, wire_lock: threading.Lock):
        self._sock = sock
        self._wire_lock = wire_lock
        # RLock: appending can allocate → GC → __del__ hooks; a re-
        # entrant enqueue from the same thread must not deadlock.
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._buf: list[tuple[int, int, bytes]] = []
        self._sending = False
        self.max_msgs, self.max_bytes = _batch_caps()
        self.linger_s = _flush_us() / 1e6
        # Telemetry for tests and the RPC microbench probe.
        self.frames_sent = 0
        self.msgs_sent = 0
        self.batches_sent = 0

    def send(self, kind: int, req_id: int, payload: bytes,
             wait: bool = False):
        """Enqueue one message.  If no write is in flight the calling
        thread becomes the drainer (immediate flush); otherwise the
        message rides the next coalesced frame.  wait=True blocks until
        the message is on the socket — backpressure-sensitive paths
        (object-plane chunk streaming) opt in to keep their in-flight
        byte budget honest."""
        with self._lock:
            self._buf.append((kind, req_id, payload))
            self.msgs_sent += 1
            if self._sending:
                if wait:
                    while self._buf or self._sending:
                        self._cv.wait()
                return
            self._sending = True
        self._drain()

    def flush(self):
        """Block until every message enqueued before this call is on
        the socket.  Ordering fences (worker oversized-result handoff,
        shutdown) need the hard guarantee; on an idle link this returns
        immediately."""
        while True:
            with self._lock:
                if self._sending:
                    self._cv.wait()
                    continue
                if not self._buf:
                    return
                self._sending = True
            self._drain(linger=False)

    def _drain(self, linger: bool = True):
        """Flush loop run by whichever thread claimed `_sending`: swap
        the buffer out, encode, write, repeat until nothing new arrived
        during the write.  With RAY_TPU_RPC_FLUSH_US > 0 each round
        lingers that long before swapping so trailing messages from
        ping-pong peers ride the same frame; flush() fences skip the
        linger (linger=False) — a fence wants the bytes out now."""
        try:
            while True:
                with self._lock:
                    if not self._buf:
                        self._sending = False
                        self._cv.notify_all()
                        return
                    if linger and self.linger_s > 0.0:
                        # cv.wait drops the lock so enqueuers can pile
                        # into the buffer during the linger window.
                        self._cv.wait(timeout=self.linger_s)
                    batch, self._buf = self._buf, []
                for frame in self._encode(batch):
                    with self._wire_lock:
                        if isinstance(frame, tuple):
                            _sendmsg_all(self._sock, frame)
                        else:
                            self._sock.sendall(frame)
        except BaseException:
            with self._lock:
                self._sending = False
                self._cv.notify_all()
            raise

    def _encode(self, batch: list) -> list:
        frames = []  # bytes, or tuple of scatter-gather parts
        stats = []  # (kind, nmsgs, frame bytes) per frame, for WIRE
        i, n = 0, len(batch)
        while i < n:
            # Greedy size/count-capped run starting at i.  Multi-part
            # (KIND_OOB) payloads can't ride a pickled KIND_BATCH —
            # they always form solo frames, and break runs.
            run_bytes = _part_len(batch[i][2])
            j = i + 1
            if not isinstance(batch[i][2], tuple):
                while (j < n and j - i < self.max_msgs
                       and not isinstance(batch[j][2], tuple)
                       and run_bytes + len(batch[j][2])
                       <= self.max_bytes):
                    run_bytes += len(batch[j][2])
                    j += 1
            if j - i == 1:
                kind, req_id, payload = batch[i]
                plen = _part_len(payload)
                header = _FRAME.pack(kind, req_id, plen)
                if isinstance(payload, tuple):
                    frames.append((header, *payload))
                elif plen >= _zerocopy_min():
                    WIRE.on_zerocopy(plen)
                    frames.append((header, payload))
                else:
                    frames.append(header + payload)
                stats.append((kind, 1, _FRAME.size + plen))
            else:
                blob = pickle.dumps(batch[i:j], protocol=5)
                frames.append(_FRAME.pack(KIND_BATCH, 0, len(blob)) + blob)
                self.batches_sent += 1
                stats.append((KIND_BATCH, j - i, len(frames[-1])))
            self.frames_sent += 1
            i = j
        WIRE.on_frames_sent(stats)
        return frames


class Connection:
    """Server-side handle to a connected peer; supports pushing messages."""

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.send_lock = threading.Lock()
        self.meta: dict = {}
        self.alive = True
        # Flips True the first time the peer sends a pickle frame: only
        # peers that speak pickle can decode KIND_BATCH, so pushes and
        # responses to JSON-only peers (the C++ client) stay plain.
        self.peer_pickle = False
        self._sender = (_CoalescingSender(sock, self.send_lock)
                        if batching_enabled() else None)

    def _post(self, kind: int, req_id: int, payload: bytes):
        if self._sender is not None and self.peer_pickle:
            self._sender.send(kind, req_id, payload)
        else:
            with self.send_lock:
                _send_frame(self.sock, kind, req_id, payload)

    def push(self, msg: Any):
        """One-way server→client message."""
        oob, payload = _encode_payload(msg)
        if oob is not None:
            self._post(KIND_OOB, 0, _oob_parts(KIND_ONEWAY, payload))
        else:
            self._post(KIND_ONEWAY, 0, payload)

    def push_json(self, msg: Any):
        """One-way push a non-Python peer can parse (KIND_ONEWAY_JSON)."""
        payload = json.dumps(_to_jsonable(msg)).encode()
        with self.send_lock:
            _send_frame(self.sock, KIND_ONEWAY_JSON, 0, payload)

    def respond(self, req_id: int, msg: Any):
        oob, payload = _encode_payload(msg)
        if oob is not None:
            self._post(KIND_OOB, req_id, _oob_parts(KIND_RESPONSE, payload))
        else:
            self._post(KIND_RESPONSE, req_id, payload)

    def flush_sends(self):
        """Fence: block until buffered pushes/responses hit the socket."""
        if self._sender is not None:
            self._sender.flush()

    def close(self):
        self.alive = False
        if self._sender is not None:
            try:
                self._sender.flush()
            except (RpcError, OSError):
                pass
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class Deferred:
    """Deferred response for long-running ops (pickle-frame requests
    only): return one from a server handler to free the connection's
    serve loop immediately; call resolve()/reject() from any thread to
    send the reply. Resolution before bind() (handler still returning)
    is buffered; double-resolution is ignored."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conn: Optional[Connection] = None
        self._req_id: Optional[int] = None
        self._outcome = None  # ("ok", v) | ("err", e) buffered pre-bind

    def bind(self, conn: "Connection", req_id: int):
        with self._lock:
            outcome = self._outcome
            if outcome is None:
                self._conn, self._req_id = conn, req_id
                return
            self._outcome = None
        # Resolved before bind: reply now; conn is never stored, so a
        # concurrent second resolution can't double-send.
        try:
            conn.respond(req_id, outcome)
        except Exception as exc:
            # The caller never gets its reply — surface it (rate-limited)
            # so a hung client is diagnosable instead of a silent stall.
            warn_once(logger, "deferred-respond", exc,
                      "dropped deferred response req_id=%s (peer gone?)",
                      req_id)

    def resolve(self, value: Any):
        self._finish(("ok", value))

    def reject(self, error: BaseException):
        self._finish(("err", error))

    def _finish(self, outcome):
        with self._lock:
            if self._conn is None:
                if self._outcome is None:
                    self._outcome = outcome
                return
            conn, req_id = self._conn, self._req_id
            self._conn = None  # double-resolve becomes a no-op
        try:
            conn.respond(req_id, outcome)
        except Exception as exc:
            warn_once(logger, "deferred-respond", exc,
                      "dropped deferred response req_id=%s (peer gone?)",
                      req_id)


class Server:
    """Threaded RPC server.

    handler(conn, msg) -> response | None. Called on a per-connection thread;
    long handlers should offload (or return a Deferred).  on_disconnect(conn)
    fires when a peer drops — the raylet's worker-death detection hook.
    """

    def __init__(
        self,
        handler: Callable[[Connection, Any], Any],
        host: str = "127.0.0.1",
        port: int = 0,
        on_disconnect: Optional[Callable[[Connection], None]] = None,
        json_validator: Optional[Callable[[Any], None]] = None,
    ):
        self._handler = handler
        self._on_disconnect = on_disconnect
        # Schema check applied to KIND_REQUEST_JSON frames only — the
        # cross-language door accepts frames from non-Python peers, so
        # it validates against the typed contract (core/wire_schema.py)
        # before dispatch; pickle frames come from our own runtime.
        self._json_validator = json_validator
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(512)
        self.host, self.port = self._sock.getsockname()
        self._stopped = threading.Event()
        self._conns: list[Connection] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True
        )
        self._accept_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return
            if self._stopped.is_set():
                # Raced with stop(): this fd may already belong to a NEW
                # server (the kernel reuses fds); do not serve it here.
                try:
                    sock.close()
                except OSError:
                    pass
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = Connection(sock, addr)
            self._conns.append(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), name="rpc-conn", daemon=True
            ).start()

    def _serve_conn(self, conn: Connection):
        try:
            while not self._stopped.is_set():
                kind, req_id, payload = _recv_frame(conn.sock)
                nbytes = _FRAME.size + len(payload)
                if kind == KIND_BATCH:
                    conn.peer_pickle = True
                    entries = pickle.loads(payload)
                    WIRE.on_frame_received(kind, nbytes, len(entries))
                    for sub_kind, sub_id, sub_payload in entries:
                        if sub_kind in (KIND_BATCH, KIND_BATCH_JSON):
                            continue  # batches never nest
                        self._dispatch(conn, sub_kind, sub_id, sub_payload)
                elif kind == KIND_BATCH_JSON:
                    entries = json.loads(payload)
                    WIRE.on_frame_received(kind, nbytes, len(entries))
                    for entry in entries:
                        sub_kind, sub_id, raw = entry
                        if sub_kind != KIND_REQUEST_JSON:
                            continue
                        self._handle_json(conn, sub_id, raw)
                elif kind == KIND_OOB:
                    conn.peer_pickle = True
                    WIRE.on_frame_received(kind, nbytes)
                    inner_kind, msg = _decode_oob(payload)
                    self._dispatch(conn, inner_kind, req_id, None,
                                   msg=msg)
                else:
                    WIRE.on_frame_received(kind, nbytes)
                    self._dispatch(conn, kind, req_id, payload)
        except (RpcError, OSError, EOFError):
            pass
        finally:
            conn.alive = False
            try:
                self._conns.remove(conn)
            except ValueError:
                pass
            if self._on_disconnect is not None and not self._stopped.is_set():
                try:
                    self._on_disconnect(conn)
                except Exception as exc:
                    # A failing disconnect hook silently breaks worker-death
                    # detection (leases never revoked, actors never failed
                    # over) — that must never be invisible.
                    warn_once(logger, "disconnect-hook", exc,
                              "on_disconnect hook raised for peer %s",
                              getattr(conn, "peername", "?"))

    def _dispatch(self, conn: Connection, kind: int, req_id: int,
                  payload, msg=None):
        """Handle one (possibly batch-unpacked) frame.  Semantics match
        the pre-batching serve loop exactly — a failing sub-request in a
        batch responds ("err", e) like any failing request.  KIND_OOB
        frames arrive pre-decoded (payload None, msg set)."""
        if kind == KIND_REQUEST_JSON:
            self._handle_json(conn, req_id, payload)
            return
        conn.peer_pickle = True
        if payload is not None:
            msg = pickle.loads(payload)
        if kind == KIND_REQUEST:
            try:
                result = self._handler(conn, msg)
                if isinstance(result, Deferred):
                    # Long-running op: the handler parks the response;
                    # another thread resolves it later.  This
                    # connection's serve loop moves on so the client's
                    # other in-flight calls aren't head-of-line blocked.
                    result.bind(conn, req_id)
                    return
                conn.respond(req_id, ("ok", result))
            except Exception as e:  # noqa: BLE001
                conn.respond(req_id, ("err", e))
        else:
            try:
                self._handler(conn, msg)
            except Exception:
                import traceback

                traceback.print_exc()

    def _handle_json(self, conn: Connection, req_id: int, raw: Any):
        """One KIND_REQUEST_JSON message (standalone or from a JSON
        batch): validate against the wire schema, dispatch, respond with
        its own JSON KIND_RESPONSE frame.  `raw` is the undecoded
        payload bytes for standalone frames (malformed JSON must come
        back as an err response, not kill the connection) or the
        already-parsed document for batch entries."""
        try:
            if isinstance(raw, (bytes, bytearray)):
                raw = json.loads(raw)
            msg = _from_jsonable(raw)
            if self._json_validator is not None:
                self._json_validator(msg)
            result = self._handler(conn, msg)
            # allow_nan=False: bare NaN/Infinity tokens are invalid
            # JSON for non-Python peers.
            out = json.dumps({"status": "ok",
                              "result": _to_jsonable(result)},
                             allow_nan=False)
        except Exception as e:  # noqa: BLE001
            out = json.dumps({
                "status": "err",
                "error": f"{type(e).__name__}: {e}"})
        with conn.send_lock:
            _send_frame(conn.sock, KIND_RESPONSE, req_id, out.encode())

    def stop(self):
        self._stopped.set()
        # shutdown() (not just close()) wakes the blocking accept(); a bare
        # close() leaves the accept thread alive, and once the kernel reuses
        # the fd that stale thread would steal another server's connections.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        for conn in self._conns:
            conn.close()


class _PendingCall:
    """Handle to one in-flight request: result() blocks for the reply,
    discard() abandons it (a late reply for a forgotten id is dropped by
    the recv loop).  The unit of request pipelining — callers keep
    several outstanding on one connection (windowed object pulls)."""

    __slots__ = ("_client", "_req_id", "_ev")

    def __init__(self, client: "Client", req_id: int, ev: threading.Event):
        self._client = client
        self._req_id = req_id
        self._ev = ev

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._ev.wait(timeout):
            self.discard()
            raise TimeoutError(f"rpc call timed out after {timeout}s")
        self._client._pending.pop(self._req_id, None)
        status, result = self._client._results.pop(self._req_id)
        if status == "err":
            raise result
        return result

    def discard(self):
        self._client._pending.pop(self._req_id, None)
        self._client._results.pop(self._req_id, None)


class Client:
    """Thread-safe RPC client with request/response matching and push inbox."""

    def __init__(
        self,
        address: str,
        on_push: Optional[Callable[[Any], None]] = None,
        connect_timeout: float = 10.0,
        on_disconnect: Optional[Callable[[], None]] = None,
    ):
        self._on_disconnect = on_disconnect
        host, port = address.rsplit(":", 1)
        deadline = time.monotonic() + connect_timeout
        last_err: Exception | None = None
        while True:
            try:
                # raylint: allow-blocking(construction-time dial; op handlers build node/actor clients once and cache them)
                self._sock = socket.create_connection((host, int(port)), timeout=5.0)
                break
            except OSError as e:
                last_err = e
                if time.monotonic() >= deadline:
                    raise RpcError(f"cannot connect to {address}: {e}") from e
                # raylint: allow-blocking(bounded redial backoff during construction only)
                time.sleep(0.05)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.address = address
        self._on_push = on_push
        # Optional hook run before every synchronous call(): lets the
        # core runtime flush coalesced one-way sends so request/response
        # ops observe everything submitted before them (runtime.py).
        self._pre_call: Optional[Callable[[], None]] = None
        self._send_lock = threading.Lock()
        # Wire coalescing (KIND_BATCH): requests AND one-ways share one
        # FIFO buffer so total send order is preserved — the runtime
        # relies on a call() observing every send() issued before it.
        self._sender = (_CoalescingSender(self._sock, self._send_lock)
                        if batching_enabled() else None)
        # Legacy-path counters so frames_sent stays meaningful (and the
        # burst-regression test stays expressible) under NO_BATCH.
        self._plain_frames = 0
        self._pending: dict[int, threading.Event] = {}
        self._results: dict[int, Any] = {}
        self._next_id = 1
        self._id_lock = threading.Lock()
        self._closed = False
        self._recv_thread = threading.Thread(
            target=self._recv_loop, name="rpc-client-recv", daemon=True
        )
        self._recv_thread.start()

    def _recv_loop(self):
        try:
            while True:
                kind, req_id, payload = _recv_frame(self._sock)
                nbytes = _FRAME.size + len(payload)
                if kind == KIND_BATCH:
                    entries = pickle.loads(payload)
                    WIRE.on_frame_received(kind, nbytes, len(entries))
                    for sub_kind, sub_id, sub_payload in entries:
                        if sub_kind in (KIND_BATCH, KIND_BATCH_JSON):
                            continue  # batches never nest
                        self._on_frame(sub_kind, sub_id, sub_payload)
                elif kind == KIND_OOB:
                    WIRE.on_frame_received(kind, nbytes)
                    inner_kind, msg = _decode_oob(payload)
                    self._on_msg(inner_kind, req_id, msg)
                else:
                    WIRE.on_frame_received(kind, nbytes)
                    self._on_frame(kind, req_id, payload)
        except (RpcError, OSError, EOFError):
            was_closed = self._closed
            self._closed = True
            err = ("err", RpcError(f"connection to {self.address} lost"))
            for req_id, ev in list(self._pending.items()):
                self._results[req_id] = err
                ev.set()
            # Fire only on an UNEXPECTED loss (close() sets _closed
            # before shutting the socket down).
            if not was_closed and self._on_disconnect is not None:
                try:
                    self._on_disconnect()
                except Exception:
                    import traceback

                    traceback.print_exc()

    def _on_frame(self, kind: int, req_id: int, payload: bytes):
        self._on_msg(kind, req_id, pickle.loads(payload))

    def _on_msg(self, kind: int, req_id: int, msg: Any):
        if kind == KIND_RESPONSE:
            ev = self._pending.get(req_id)
            if ev is not None:
                self._results[req_id] = msg
                ev.set()
        elif kind == KIND_ONEWAY and self._on_push is not None:
            try:
                self._on_push(msg)
            except Exception:
                import traceback

                traceback.print_exc()

    def _post(self, kind: int, req_id: int, payload: bytes,
              wait: bool = False):
        if self._sender is not None:
            self._sender.send(kind, req_id, payload, wait=wait)
        else:
            with self._send_lock:
                _send_frame(self._sock, kind, req_id, payload)
                self._plain_frames += 1

    @property
    def frames_sent(self) -> int:
        """Control-plane frames written to this socket (telemetry for
        the burst-submission regression test and the RPC bench probe)."""
        s = self._sender
        return self._plain_frames if s is None else s.frames_sent

    @property
    def msgs_sent(self) -> int:
        s = self._sender
        return self._plain_frames if s is None else s.msgs_sent

    @property
    def batches_sent(self) -> int:
        s = self._sender
        return 0 if s is None else s.batches_sent

    def flush_sends(self):
        """Fence: block until every previously enqueued frame is on the
        socket.  No-op without coalescing (sends are then synchronous)."""
        if self._sender is not None:
            self._sender.flush()

    def call_async(self, msg: Any) -> _PendingCall:
        """Post a request and return a handle without waiting for the
        reply.  Multiple handles may be outstanding on one connection
        (responses match by request id) — the windowed object pull keeps
        a whole window of these in flight."""
        if self._closed:
            raise RpcError(f"connection to {self.address} closed")
        if self._pre_call is not None:
            self._pre_call()
        with self._id_lock:
            req_id = self._next_id
            self._next_id += 1
        ev = threading.Event()
        self._pending[req_id] = ev
        oob, payload = _encode_payload(msg)
        if oob is not None:
            self._post(KIND_OOB, req_id, _oob_parts(KIND_REQUEST, payload))
        else:
            self._post(KIND_REQUEST, req_id, payload)
        return _PendingCall(self, req_id, ev)

    def call(self, msg: Any, timeout: Optional[float] = None) -> Any:
        return self.call_async(msg).result(timeout)

    def send(self, msg: Any, wait: bool = False):
        """One-way message.  wait=True blocks until the bytes are on
        the socket — callers whose flow control assumes a blocking send
        (object-plane chunk streaming) keep their backpressure."""
        if self._closed:
            raise RpcError(f"connection to {self.address} closed")
        oob, payload = _encode_payload(msg)
        if oob is not None:
            self._post(KIND_OOB, 0, _oob_parts(KIND_ONEWAY, payload),
                       wait=wait)
        else:
            self._post(KIND_ONEWAY, 0, payload, wait=wait)

    def close(self):
        self._closed = True
        # Drain buffered frames before tearing the socket down: the
        # legacy (synchronous-send) protocol never lost tail messages
        # on a clean close, and final decref/task_done traffic matters.
        if self._sender is not None:
            try:
                self._sender.flush()
            except (RpcError, OSError):
                pass
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
