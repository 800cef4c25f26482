"""Request router: replica-set tracking + power-of-two-choices scheduling.

Counterpart of python/ray/serve/_private/router.py (Router :312,
assign_request :518) and the PowerOfTwoChoicesReplicaScheduler
(replica_scheduler/pow_2_scheduler.py:49): pick two random replicas and
send to the one with the smaller queue.  The base queue signal is the
router's own in-flight count per replica (no per-request probe RTT on
the hot path); on top of it ride the replicas' piggybacked load reports
— engine queue depth, free KV pages, loaded multiplex model ids —
published by the controller on the load:: long-poll key.  P2C scoring
adds the reported queue depth while the report is fresh and prefers
replicas that already hold the requested multiplexed model; a report
older than RAY_TPU_SERVE_FEEDBACK_STALE_S falls back to the blind
local-inflight signal (a wedged controller must not steer traffic with
fossil data).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.actor import ActorHandle
from ray_tpu_torch.util import flight_recorder

LISTEN_TIMEOUT_S = 10.0


def _stale_s() -> float:
    try:
        return float(os.environ.get(
            "RAY_TPU_SERVE_FEEDBACK_STALE_S", "") or 5.0)
    except ValueError:
        return 5.0


def _role_strict() -> bool:
    """Strict role pools: a phase-tagged request WAITS for a replica of
    its role instead of degrading to mixed routing when the pool is
    empty (default off — graceful degradation)."""
    return os.environ.get("RAY_TPU_SERVE_ROLE_STRICT", "0").lower() \
        in ("1", "true", "yes")


class _ReplicaSet:
    def __init__(self):
        self.entries: List[dict] = []
        self.handles: Dict[str, ActorHandle] = {}
        self.inflight: Dict[str, int] = {}
        # actor_hex -> latest load report; received_at (monotonic, local
        # to this process) drives the staleness fallback.
        self.reports: Dict[str, dict] = {}
        self.version = 0
        self.cv = threading.Condition()

    def update(self, entries: List[dict], version: int):
        with self.cv:
            self.entries = entries or []
            self.version = version
            live = {e["actor_hex"] for e in self.entries}
            for hex_id in list(self.handles):
                if hex_id not in live:
                    del self.handles[hex_id]
                    self.inflight.pop(hex_id, None)
                    self.reports.pop(hex_id, None)
            for e in self.entries:
                h = e["actor_hex"]
                if h not in self.handles:
                    self.handles[h] = ActorHandle(h, "Replica")
                    self.inflight.setdefault(h, 0)
            self.cv.notify_all()

    def update_reports(self, reports: Optional[Dict[str, dict]]):
        if not reports:
            return
        now = time.monotonic()
        with self.cv:
            for hex_id, rep in reports.items():
                if not isinstance(rep, dict):
                    continue
                rep = dict(rep)
                rep["received_at"] = now
                self.reports[hex_id] = rep
            self.cv.notify_all()


class Router:
    """One Router per (app, deployment) per process, shared by handles."""

    _hub_lock = threading.Lock()
    _hub: Dict[tuple, "Router"] = {}

    def __init__(self, app_name: str, deployment: str, controller):
        self.app_name = app_name
        self.deployment = deployment
        self._controller = controller
        self._set = _ReplicaSet()
        self._key = f"replicas::{app_name}::{deployment}"
        self._load_key = f"load::{app_name}::{deployment}"
        # seed synchronously so the first request doesn't always wait a
        # full long-poll round trip
        try:
            entries = ray_tpu_torch.get(
                controller.get_replicas.remote(app_name, deployment),
                timeout=10)
            self._set.update(entries, version=0)
        except Exception:
            pass
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._poll_loop, name=f"router-{deployment}", daemon=True)
        self._thread.start()

    @classmethod
    def get_or_create(cls, app_name: str, deployment: str,
                      controller) -> "Router":
        key = (app_name, deployment)
        with cls._hub_lock:
            r = cls._hub.get(key)
            if r is None:
                r = cls._hub[key] = Router(app_name, deployment, controller)
            return r

    @classmethod
    def reset_all(cls):
        with cls._hub_lock:
            for r in cls._hub.values():
                r._stop.set()
            cls._hub.clear()

    def _poll_loop(self):
        known = {self._key: 0, self._load_key: 0}
        while not self._stop.is_set():
            try:
                ref = self._controller.listen_for_change.remote(
                    known, LISTEN_TIMEOUT_S)
                changed = ray_tpu_torch.get(ref, timeout=LISTEN_TIMEOUT_S + 5)
            except Exception:
                if self._stop.is_set():
                    return
                time.sleep(0.5)  # raylint: allow-blocking(reconnect backoff on the router's own poll thread; no request rides it)
                continue
            for key, (version, value) in (changed or {}).items():
                if key == self._key:
                    known[key] = version
                    self._set.update(value, version)
                elif key == self._load_key:
                    known[key] = version
                    self._set.update_reports(value)

    # ------------------------------------------------------------------
    def _score(self, e: dict, now: float, stale_s: float,
               phase: str = "") -> tuple:
        """P2C score for one candidate: local in-flight plus the
        replica's reported engine queue depth while the report is fresh
        (stale reports are ignored — blind local signal only), with a
        penalty when the report says the KV pool is exhausted (every
        admission there would stall on pages).  Decode-phase requests
        additionally prefer KV-page headroom (a tiny tie-break bonus:
        the imported context + remaining generation must fit).  Returns
        (score, fresh)."""
        h = e["actor_hex"]
        score = float(self._set.inflight.get(h, 0))
        rep = self._set.reports.get(h)
        fresh = (rep is not None
                 and now - rep.get("received_at", 0.0) <= stale_s)
        if fresh:
            score += float(rep.get("queue_depth", 0))
            free = rep.get("free_kv_pages")
            if free is not None and free <= 0:
                score += 4.0
            elif phase == "decode" and free is not None:
                # < 0.5 total so headroom never outvotes a whole queued
                # request — it breaks ties between equally loaded
                # replicas.
                score -= min(float(free), 4096.0) * 1e-4
        return score, fresh

    def _prefix_match(self, e: dict, prefix_keys, now: float,
                      stale_s: float) -> int:
        """Longest-prefix match of the request's page-chain hint against
        the replica's advertised hot-prefix digest (stale digests are
        worthless — the cache has moved on)."""
        rep = self._set.reports.get(e["actor_hex"])
        if rep is None or now - rep.get("received_at", 0.0) > stale_s:
            return 0
        digest = rep.get("prefix_digest")
        if not isinstance(digest, dict) \
                or digest.get("op") != "serve_prefix_digest":
            return 0
        have = set(digest.get("keys") or ())
        n = 0
        for k in prefix_keys:
            if k not in have:
                break
            n += 1
        return n

    def _has_model(self, e: dict, model_id: str, now: float,
                   stale_s: float) -> bool:
        rep = self._set.reports.get(e["actor_hex"])
        if rep is None or now - rep.get("received_at", 0.0) > stale_s:
            return False
        return model_id in (rep.get("models") or ())

    def assign_replica(self, timeout_s: float = 30.0,
                       model_id: str = "", phase: str = "",
                       prefix_keys: Optional[List[str]] = None,
                       trace_id: str = "") -> tuple:
        """Pick a replica (pow-2 by local in-flight + fresh load
        feedback), respecting max_ongoing backpressure; returns
        (actor_hex, handle).  model_id biases the choice toward
        replicas that already hold that multiplexed model (skipping a
        cold load) unless none report it.

        Disaggregated serving: phase ("prefill"|"decode") restricts the
        pool to replicas of that role (mixed replicas always qualify),
        degrading to ALL candidates when the phase pool is empty unless
        RAY_TPU_SERVE_ROLE_STRICT.  prefix_keys (the request's
        page-chain hint) steers prefill to the replica whose hot-prefix
        digest longest-matches it — cached pages there mean less
        recompute — falling back to pure load scoring on no match."""
        s = self._set
        deadline = time.monotonic() + timeout_s
        stale_s = _stale_s()
        with s.cv:
            while True:
                candidates = []
                for e in s.entries:
                    h = e["actor_hex"]
                    if s.inflight.get(h, 0) < e.get("max_ongoing", 8):
                        candidates.append(e)
                degraded = False
                if phase and candidates:
                    rolepool = [e for e in candidates
                                if e.get("role", "mixed")
                                in (phase, "mixed")]
                    if rolepool:
                        candidates = rolepool
                    elif _role_strict():
                        candidates = []  # wait for the phase pool
                    else:
                        degraded = True  # graceful: mixed routing
                if candidates:
                    now = time.monotonic()
                    pool = candidates
                    affine = False
                    locality = 0
                    if model_id:
                        with_model = [e for e in candidates
                                      if self._has_model(
                                          e, model_id, now, stale_s)]
                        if with_model:
                            pool = with_model
                            affine = True
                    if phase == "prefill" and prefix_keys:
                        matches = [(self._prefix_match(
                            e, prefix_keys, now, stale_s), e)
                            for e in pool]
                        best = max(m for m, _ in matches)
                        if best > 0:
                            pool = [e for m, e in matches if m == best]
                            locality = best
                    if len(pool) >= 2:
                        a, b = random.sample(pool, 2)
                        sa, fa = self._score(a, now, stale_s, phase)
                        sb, fb = self._score(b, now, stale_s, phase)
                        pick, fresh = (a, fa) if sa <= sb else (b, fb)
                    else:
                        pick = pool[0]
                        _, fresh = self._score(pick, now, stale_s, phase)
                    hex_id = pick["actor_hex"]
                    s.inflight[hex_id] = s.inflight.get(hex_id, 0) + 1
                    flight_recorder.record(
                        "serve", "route", deployment=self.deployment,
                        replica=hex_id[:12], feedback=bool(fresh),
                        affinity=affine, phase=phase,
                        locality=locality, degraded=degraded,
                        inflight=s.inflight[hex_id],
                        # Request-journey correlation: the routing
                        # decision joins the trace's span timeline
                        # through the flight lane (empty = untraced).
                        trace=trace_id)
                    return hex_id, s.handles[hex_id]
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"no available replica for "
                        f"{self.app_name}/{self.deployment} "
                        f"within {timeout_s}s")
                s.cv.wait(timeout=min(remaining, 0.5))

    def release(self, actor_hex: str):
        s = self._set
        with s.cv:
            if actor_hex in s.inflight and s.inflight[actor_hex] > 0:
                s.inflight[actor_hex] -= 1
            s.cv.notify_all()

    def drop_replica(self, actor_hex: str):
        """Remove a replica the data plane found dead (controller will
        also notice via health checks)."""
        s = self._set
        with s.cv:
            s.entries = [e for e in s.entries
                         if e["actor_hex"] != actor_hex]
            s.handles.pop(actor_hex, None)
            s.inflight.pop(actor_hex, None)
