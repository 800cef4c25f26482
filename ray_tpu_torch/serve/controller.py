"""ServeController: the serve control plane actor.

Counterpart of python/ray/serve/_private/controller.py (ServeController :86)
plus the ApplicationState/DeploymentState reconcilers
(application_state.py, deployment_state.py:1226 — reconcile in update()):
a single named actor that holds target state (apps -> deployments ->
replica targets), runs a reconcile loop that starts/stops/heals replica
actors, evaluates queue-based autoscaling, and broadcasts routing tables to
routers/proxies over the long-poll host.
"""

from __future__ import annotations

import math
import os
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.serve.config import (
    ApplicationStatus,
    AutoscalingConfig,
    DeploymentStatus,
    ReplicaStatus,
    config_hash,
)
from ray_tpu_torch.serve.long_poll import LongPollHost

CONTROLLER_NAME = "SERVE_CONTROLLER"
SERVE_NAMESPACE = "serve"
RECONCILE_PERIOD_S = 0.1


def _pct(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(math.ceil(q * len(sorted_vals))) - 1))
    return float(sorted_vals[i])


@dataclass
class ReplicaInfo:
    replica_id: str
    handle: Any  # ActorHandle
    version: str
    state: str = "STARTING"  # STARTING|RUNNING|UNHEALTHY|STOPPING
    start_ref: Any = None
    health_ref: Any = None
    health_issued: float = 0.0
    last_health: float = 0.0
    drain_ref: Any = None
    drain_deadline: float = 0.0
    ongoing_ref: Any = None
    last_ongoing: int = 0
    # Load-report probe (router feedback): issued on the reconcile
    # cadence, published on the load:: long-poll key.
    load_ref: Any = None
    load_issued: float = 0.0
    last_load: Any = None


@dataclass
class DeploymentTarget:
    app_name: str
    name: str
    blob: bytes  # cloudpickle (func_or_class, init_args, init_kwargs)
    config: dict
    version: str
    autoscale: Optional[AutoscalingConfig] = None
    # autoscaling runtime state
    target_replicas: int = 1
    smoothed_ongoing: float = 0.0
    last_scale_up: float = 0.0
    last_scale_down: float = 0.0
    over_target_since: Optional[float] = None
    under_target_since: Optional[float] = None
    replicas: List[ReplicaInfo] = field(default_factory=list)
    next_replica_ord: int = 0
    message: str = ""


@dataclass
class AppTarget:
    name: str
    route_prefix: Optional[str]
    ingress: str  # ingress deployment name
    deployments: Dict[str, DeploymentTarget] = field(default_factory=dict)
    deleting: bool = False
    # Ingress speaks the ASGI contract (serve/asgi.py): the proxy
    # renders its streamed response events as raw HTTP.
    is_asgi: bool = False


class ServeController:
    """max_concurrency must be generous: long-polls park threads."""

    def __init__(self, http_host: str = "127.0.0.1", http_port: int = 8000):
        self._lock = threading.RLock()
        self._apps: Dict[str, AppTarget] = {}
        self._poll = LongPollHost()
        self._stopped = threading.Event()
        self._http = (http_host, http_port)
        self._proxy_handle = None
        # Per-deployment SLO state, fed by the samples replicas
        # piggyback on their load reports: (app, deployment) ->
        # {"samples": deque of per-request dicts, "engine":
        #  {replica_id: latest engine sampler snapshot}}.
        self._slo: Dict[tuple, Dict[str, Any]] = {}
        self._loop = threading.Thread(
            target=self._reconcile_loop, name="serve-reconcile", daemon=True)
        self._loop.start()

    # ------------------------------------------------------------------
    # Control API (called by serve.run / serve.delete / serve.status)
    def deploy_application(self, app_name: str,
                           route_prefix: Optional[str],
                           ingress_name: str,
                           deployments: List[dict],
                           is_asgi: bool = False) -> None:
        """deployments: [{name, blob, config(dict),
        autoscaling(dict|None)}]"""
        with self._lock:
            app = self._apps.get(app_name)
            if app is None or app.deleting:
                app = AppTarget(app_name, route_prefix, ingress_name)
                self._apps[app_name] = app
            app.route_prefix = route_prefix
            app.ingress = ingress_name
            app.is_asgi = is_asgi
            app.deleting = False
            new_names = set()
            for d in deployments:
                new_names.add(d["name"])
                auto = (AutoscalingConfig(**d["autoscaling"])
                        if d.get("autoscaling") else None)
                version = config_hash(
                    d["blob"].hex() if isinstance(d["blob"], bytes)
                    else repr(d["blob"]),
                    d["config"].get("user_config"),
                )
                prev = app.deployments.get(d["name"])
                if prev is not None:
                    same_ucfg_version = config_hash(
                        (prev.blob.hex() if isinstance(prev.blob, bytes)
                         else repr(prev.blob)), None)
                    # user_config-only change: reconfigure in place
                    if (config_hash(d["blob"].hex(), None) == same_ucfg_version
                            and version != prev.version):
                        self._reconfigure_in_place(prev, d, version)
                        continue
                    prev.blob = d["blob"]
                    prev.config = d["config"]
                    prev.version = version
                    prev.autoscale = auto
                    if auto is not None:
                        prev.target_replicas = min(
                            max(prev.target_replicas, auto.min_replicas),
                            auto.max_replicas)
                    else:
                        prev.target_replicas = d["config"].get(
                            "num_replicas", 1)
                else:
                    tgt = DeploymentTarget(
                        app_name=app_name, name=d["name"], blob=d["blob"],
                        config=d["config"], version=version, autoscale=auto)
                    tgt.target_replicas = (
                        auto.min_replicas if auto is not None
                        else d["config"].get("num_replicas", 1))
                    app.deployments[d["name"]] = tgt
            # deployments removed from the app config get torn down
            for name in list(app.deployments):
                if name not in new_names:
                    app.deployments[name].target_replicas = 0
                    app.deployments[name].message = "removed"
        self._publish_routes()

    def _reconfigure_in_place(self, tgt: DeploymentTarget, d: dict,
                              version: str):
        """Push new user_config to live replicas without restarts
        (reference deployment_state 'lightweight update' path)."""
        tgt.config = d["config"]
        tgt.version = version
        ucfg = d["config"].get("user_config")
        for r in tgt.replicas:
            if r.state == "RUNNING":
                r.version = version
                try:
                    r.handle.reconfigure.remote(ucfg)
                except Exception:
                    pass

    def delete_application(self, app_name: str) -> None:
        with self._lock:
            app = self._apps.get(app_name)
            if app is None:
                return
            app.deleting = True
            for tgt in app.deployments.values():
                tgt.target_replicas = 0
        self._publish_routes()

    def shutdown(self) -> None:
        with self._lock:
            for app in self._apps.values():
                app.deleting = True
                for tgt in app.deployments.values():
                    tgt.target_replicas = 0
        self._publish_routes()

    def ensure_proxy(self) -> None:
        """Start the HTTP proxy actor once (reference: per-node proxies
        started by the controller's proxy state manager)."""
        with self._lock:
            if self._proxy_handle is not None:
                return
            from ray_tpu_torch.serve.proxy import HTTPProxy

            host, port = self._http
            self._proxy_handle = ray_tpu_torch.remote(HTTPProxy).options(
                max_concurrency=4, num_cpus=0).remote(host, port)

    def proxy_address(self, timeout: float = 20.0) -> Optional[str]:
        with self._lock:
            proxy = self._proxy_handle
        if proxy is None:
            return None
        return ray_tpu_torch.get(proxy.address.remote(), timeout=timeout)

    def ensure_frame_proxy(self) -> None:
        """Start the frame-protocol ingress actor once (counterpart of
        the reference's gRPC proxy, started alongside HTTP)."""
        with self._lock:
            if getattr(self, "_frame_proxy_handle", None) is not None:
                return
            from ray_tpu_torch.serve.proxy import FrameProxy

            self._frame_proxy_handle = ray_tpu_torch.remote(FrameProxy).options(
                max_concurrency=4, num_cpus=0).remote(self._http[0], 0)

    def frame_proxy_address(self, timeout: float = 20.0) -> Optional[str]:
        with self._lock:
            proxy = getattr(self, "_frame_proxy_handle", None)
        if proxy is None:
            return None
        return ray_tpu_torch.get(proxy.address.remote(), timeout=timeout)

    def ensure_grpc_proxy(self) -> None:
        """Start the typed gRPC ingress actor once (reference gRPCProxy,
        serve/_private/proxy.py:540; contract in serve/protos/serve.proto)."""
        with self._lock:
            if getattr(self, "_grpc_proxy_handle", None) is not None:
                return
            from ray_tpu_torch.serve.grpc_proxy import GrpcProxy

            self._grpc_proxy_handle = ray_tpu_torch.remote(GrpcProxy).options(
                max_concurrency=8, num_cpus=0).remote(self._http[0], 0)

    def grpc_proxy_address(self, timeout: float = 20.0) -> Optional[str]:
        with self._lock:
            proxy = getattr(self, "_grpc_proxy_handle", None)
        if proxy is None:
            return None
        return ray_tpu_torch.get(proxy.address.remote(), timeout=timeout)

    # ------------------------------------------------------------------
    # Introspection (routers, proxies, serve.status)
    def listen_for_change(self, known: Dict[str, int],
                          timeout_s: float = 30.0):
        return self._poll.listen(known, timeout_s)

    def get_replicas(self, app_name: str, deployment: str) -> List[dict]:
        val = self._poll.get(f"replicas::{app_name}::{deployment}")
        return val or []

    def get_routes(self) -> Dict[str, Tuple[str, str]]:
        return self._poll.get("routes") or {}

    def get_ingress(self, app_name: str) -> Optional[str]:
        with self._lock:
            app = self._apps.get(app_name)
            return None if app is None else app.ingress

    def has_deployment(self, app_name: str, deployment: str) -> bool:
        with self._lock:
            app = self._apps.get(app_name)
            return app is not None and deployment in app.deployments

    def status(self) -> Dict[str, Any]:
        with self._lock:
            out = {}
            for app_name, app in self._apps.items():
                deps: Dict[str, DeploymentStatus] = {}
                all_healthy = True
                any_failed = False
                for name, tgt in app.deployments.items():
                    running = [r for r in tgt.replicas
                               if r.state == "RUNNING"
                               and r.version == tgt.version]
                    if len(running) >= tgt.target_replicas:
                        st = "HEALTHY"
                    else:
                        st = "UPDATING"
                        all_healthy = False
                    if tgt.message.startswith("failed"):
                        st = "UNHEALTHY"
                        any_failed = True
                    deps[name] = DeploymentStatus(
                        name=name, status=st,
                        replicas=[ReplicaStatus(
                            r.replica_id, r.state,
                            r.handle._actor_hex) for r in tgt.replicas],
                        message=tgt.message)
                if app.deleting:
                    status = "DELETING"
                elif any_failed:
                    status = "DEPLOY_FAILED"
                elif all_healthy:
                    status = "RUNNING"
                else:
                    status = "DEPLOYING"
                out[app_name] = ApplicationStatus(
                    name=app_name, status=status, deployments=deps)
            return out

    def ping(self) -> str:
        return "pong"

    # ------------------------------------------------------------------
    # Reconcile loop
    def _reconcile_loop(self):
        while not self._stopped.is_set():
            try:
                self._reconcile_once()
            except Exception:
                traceback.print_exc()
            self._stopped.wait(RECONCILE_PERIOD_S)

    def _reconcile_once(self):
        with self._lock:
            apps = list(self._apps.items())
        for app_name, app in apps:
            for tgt in list(app.deployments.values()):
                self._reconcile_deployment(app, tgt)
            with self._lock:
                # garbage-collect fully-deleted apps / removed deployments
                for name in list(app.deployments):
                    tgt = app.deployments[name]
                    if tgt.target_replicas == 0 and not tgt.replicas and (
                            app.deleting or tgt.message == "removed"):
                        del app.deployments[name]
                if app.deleting and not app.deployments:
                    del self._apps[app_name]

    def _reconcile_deployment(self, app: AppTarget, tgt: DeploymentTarget):
        now = time.monotonic()
        with self._lock:
            if not app.deleting:
                # A departure from the reference's reconcile (ray_tpu/
                # serve/controller.py): the autoscaler skips an app being
                # deleted.  There it lifts the deletion's target of 0
                # back to min_replicas, and the app's replicas keep
                # running.
                self._autoscale(tgt, now)
            self._advance_replica_states(tgt, now)
            self._probe_load_reports(tgt, now)
            current = [r for r in tgt.replicas
                       if r.state in ("STARTING", "RUNNING")
                       and r.version == tgt.version]
            n_missing = tgt.target_replicas - len(current)
            to_start = max(0, n_missing)
            # stale-version replicas stop once enough current-version
            # replicas are running (rolling update, start-new-first)
            stale = [r for r in tgt.replicas
                     if r.state in ("STARTING", "RUNNING")
                     and r.version != tgt.version]
            running_current = [r for r in current if r.state == "RUNNING"]
            excess = len(current) - tgt.target_replicas
            stop_now: List[ReplicaInfo] = []
            if stale and len(running_current) >= tgt.target_replicas:
                stop_now.extend(stale)
            elif stale and tgt.target_replicas == 0:
                stop_now.extend(stale)
            if excess > 0:
                # prefer stopping STARTING replicas, then highest ordinal
                victims = sorted(
                    current,
                    key=lambda r: (r.state == "RUNNING", r.replica_id))
                stop_now.extend(victims[:excess])
        for _ in range(to_start):
            self._start_replica(app, tgt)
        for r in stop_now:
            self._stop_replica(tgt, r)

    # -- replica lifecycle ---------------------------------------------
    def _start_replica(self, app: AppTarget, tgt: DeploymentTarget):
        from ray_tpu_torch.serve.replica import Replica

        with self._lock:
            rid = f"{tgt.name}#{tgt.next_replica_ord}"
            tgt.next_replica_ord += 1
        cfg = tgt.config
        actor_opts = dict(cfg.get("ray_actor_options") or {})
        actor_opts.setdefault("num_cpus", 1)
        # headroom so control calls (health/ongoing) don't starve behind
        # a full data-plane thread pool
        max_conc = int(cfg.get("max_ongoing_requests", 8)) + 2
        try:
            handle = ray_tpu_torch.remote(Replica).options(
                max_concurrency=max_conc, **actor_opts).remote(
                tgt.blob, app.name, tgt.name, rid,
                cfg.get("user_config"), cfg.get("role", "mixed"))
        except Exception as e:
            with self._lock:
                tgt.message = f"failed to create replica: {e}"
            return
        info = ReplicaInfo(replica_id=rid, handle=handle,
                           version=tgt.version)
        info.start_ref = handle.health_check.remote()
        info.health_issued = time.monotonic()
        with self._lock:
            tgt.replicas.append(info)

    def _stop_replica(self, tgt: DeploymentTarget, r: ReplicaInfo):
        with self._lock:
            if r.state == "STOPPING":
                return
            r.state = "STOPPING"
            r.drain_deadline = time.monotonic() + float(
                tgt.config.get("graceful_shutdown_timeout_s", 5.0))
        try:
            r.drain_ref = r.handle.drain.remote(
                float(tgt.config.get("graceful_shutdown_timeout_s", 5.0)))
        except Exception:
            r.drain_ref = None
        self._publish_replicas(tgt)

    def _advance_replica_states(self, tgt: DeploymentTarget, now: float):
        """Lock held. Drive STARTING->RUNNING, health checks, drains."""
        changed = False
        period = float(tgt.config.get("health_check_period_s", 2.0))
        hc_timeout = float(tgt.config.get("health_check_timeout_s", 10.0))
        for r in list(tgt.replicas):
            if r.state == "STARTING":
                done, _ = ray_tpu_torch.wait([r.start_ref], timeout=0)
                if done:
                    try:
                        ray_tpu_torch.get(r.start_ref, timeout=1)
                        r.state = "RUNNING"
                        r.last_health = now
                        changed = True
                    except Exception as e:
                        r.state = "UNHEALTHY"
                        tgt.message = f"failed to start: {e}"
                        changed = True
                elif now - r.health_issued > max(hc_timeout, 30.0):
                    r.state = "UNHEALTHY"
                    tgt.message = "replica start timed out"
                    changed = True
            elif r.state == "RUNNING":
                if r.health_ref is not None:
                    done, _ = ray_tpu_torch.wait([r.health_ref], timeout=0)
                    if done:
                        try:
                            ray_tpu_torch.get(r.health_ref, timeout=1)
                            r.last_health = now
                        except Exception:
                            r.state = "UNHEALTHY"
                            changed = True
                        r.health_ref = None
                    elif now - r.health_issued > hc_timeout:
                        r.state = "UNHEALTHY"
                        r.health_ref = None
                        changed = True
                elif now - r.last_health > period:
                    try:
                        r.health_ref = r.handle.health_check.remote()
                        r.health_issued = now
                    except Exception:
                        r.state = "UNHEALTHY"
                        changed = True
            elif r.state == "UNHEALTHY":
                self._kill_replica(r)
                tgt.replicas.remove(r)
                changed = True
            elif r.state == "STOPPING":
                drained = False
                if r.drain_ref is not None:
                    done, _ = ray_tpu_torch.wait([r.drain_ref], timeout=0)
                    drained = bool(done)
                if drained or now > r.drain_deadline:
                    self._kill_replica(r)
                    tgt.replicas.remove(r)
        if changed:
            self._publish_replicas(tgt)

    @staticmethod
    def _kill_replica(r: ReplicaInfo):
        try:
            ray_tpu_torch.kill(r.handle)
        except Exception:
            pass

    # -- autoscaling ----------------------------------------------------
    def _autoscale(self, tgt: DeploymentTarget, now: float):
        """Lock held. Queue-based policy: desired = ceil(total_ongoing /
        target_ongoing_requests) with up/downscale delays
        (reference autoscaling_policy.py)."""
        auto = tgt.autoscale
        if auto is None:
            return
        running = [r for r in tgt.replicas if r.state == "RUNNING"]
        # collect last pass's probes, reissue
        total = 0
        counted = 0
        for r in running:
            if r.ongoing_ref is not None:
                done, _ = ray_tpu_torch.wait([r.ongoing_ref], timeout=0)
                if done:
                    try:
                        r.last_ongoing = ray_tpu_torch.get(r.ongoing_ref, timeout=1)
                    except Exception:
                        pass
                    r.ongoing_ref = None
            if r.ongoing_ref is None:
                try:
                    r.ongoing_ref = r.handle.num_ongoing.remote()
                except Exception:
                    pass
            total += r.last_ongoing
            counted += 1
        if counted == 0:
            return
        a = auto.smoothing_factor
        tgt.smoothed_ongoing = a * total + (1 - a) * tgt.smoothed_ongoing
        import math

        desired = math.ceil(
            tgt.smoothed_ongoing / max(auto.target_ongoing_requests, 1e-9))
        desired = min(max(desired, auto.min_replicas), auto.max_replicas)
        cur = tgt.target_replicas
        if desired > cur:
            if tgt.over_target_since is None:
                tgt.over_target_since = now
            if now - tgt.over_target_since >= auto.upscale_delay_s:
                tgt.target_replicas = desired
                tgt.over_target_since = None
            tgt.under_target_since = None
        elif desired < cur:
            if tgt.under_target_since is None:
                tgt.under_target_since = now
            if now - tgt.under_target_since >= auto.downscale_delay_s:
                tgt.target_replicas = desired
                tgt.under_target_since = None
            tgt.over_target_since = None
        else:
            tgt.over_target_since = None
            tgt.under_target_since = None

    # -- load feedback ---------------------------------------------------
    def _probe_load_reports(self, tgt: DeploymentTarget, now: float):
        """Lock held.  Async-probe RUNNING replicas' load_report() on
        the reconcile cadence (same non-blocking ref pattern as the
        autoscaler's num_ongoing probes — the RPCs themselves ride the
        coalescing flusher with the health-check traffic) and publish
        the collected reports on the load:: long-poll key for routers.
        """
        try:
            period = float(os.environ.get(
                "RAY_TPU_SERVE_LOAD_REPORT_S", "") or 1.0)
        except ValueError:
            period = 1.0
        changed = False
        for r in tgt.replicas:
            if r.state != "RUNNING":
                continue
            if r.load_ref is not None:
                done, _ = ray_tpu_torch.wait([r.load_ref], timeout=0)
                if done:
                    try:
                        rep = ray_tpu_torch.get(r.load_ref, timeout=1)
                        if isinstance(rep, dict):
                            r.last_load = rep
                            self._fold_slo(tgt, rep)
                            changed = True
                    except Exception:  # raylint: allow-swallow(replica death is the health check's call; a failed probe leaves the old report to age out router-side)
                        pass
                    r.load_ref = None
            elif now - r.load_issued >= period:
                try:
                    r.load_ref = r.handle.load_report.remote()
                    r.load_issued = now
                except Exception:  # raylint: allow-swallow(probe reissues next reconcile; health check owns replica death)
                    pass
        if changed:
            reports = {
                r.handle._actor_hex: r.last_load
                for r in tgt.replicas
                if r.state == "RUNNING" and r.last_load is not None}
            self._poll.set(
                f"load::{tgt.app_name}::{tgt.name}", reports)

    def _fold_slo(self, tgt: DeploymentTarget, rep: dict):
        """Lock held.  Fold a load report's piggybacked per-request SLO
        samples into the deployment's sliding window and retain the
        latest engine sampler snapshot per replica — the aggregation
        side of /api/serve_slo, riding the existing probe (zero new
        transport)."""
        from collections import deque

        key = (tgt.app_name, tgt.name)
        st = self._slo.get(key)
        if st is None:
            st = self._slo[key] = {"samples": deque(maxlen=4096),
                                   "engine": {}}
        for s in rep.get("slo_samples") or ():
            if isinstance(s, dict):
                st["samples"].append(s)
        es = rep.get("engine_sample")
        if isinstance(es, dict):
            st["engine"][str(rep.get("replica_id", "?"))] = es

    def serve_slo(self) -> Dict[str, Any]:
        """Per-deployment SLO attribution: sliding-window percentiles
        (p50/p95/p99) of TTFT, TPOT and queue wait derived from the
        samples replicas piggyback on their load reports, plus each
        replica's latest engine sampler snapshot (batch occupancy,
        prefill token spend, free KV pages).  The window is
        RAY_TPU_SERVE_SLO_WINDOW_S seconds of wall clock."""
        try:
            window = float(os.environ.get(
                "RAY_TPU_SERVE_SLO_WINDOW_S", "") or 300.0)
        except ValueError:
            window = 300.0
        cutoff = time.time() - window
        out: Dict[str, Any] = {}
        with self._lock:
            for (app, dep), st in self._slo.items():
                samples = st["samples"]
                # Samples arrive roughly time-ordered (probe cadence);
                # age the window from the left.
                while samples and samples[0].get("ts", 0.0) < cutoff:
                    samples.popleft()
                entry: Dict[str, Any] = {
                    "window_s": window,
                    "completed": sum(1 for s in samples if "ttft" in s),
                    "shed": sum(1 for s in samples if "shed" in s),
                    "engine": dict(st["engine"]),
                }
                for metric in ("ttft", "tpot", "queue_wait"):
                    vals = sorted(s[metric] for s in samples
                                  if metric in s)
                    if vals:
                        entry[metric] = {
                            "p50": _pct(vals, 0.50),
                            "p95": _pct(vals, 0.95),
                            "p99": _pct(vals, 0.99),
                            "mean": sum(vals) / len(vals),
                            "count": len(vals)}
                out[f"{app}/{dep}"] = entry
        return out

    # -- publication ----------------------------------------------------
    def _publish_replicas(self, tgt: DeploymentTarget):
        entries = [
            {"replica_id": r.replica_id, "actor_hex": r.handle._actor_hex,
             "max_ongoing": int(tgt.config.get("max_ongoing_requests", 8)),
             "role": tgt.config.get("role", "mixed")}
            for r in tgt.replicas if r.state == "RUNNING"
        ]
        self._poll.set(f"replicas::{tgt.app_name}::{tgt.name}", entries)

    def _publish_routes(self):
        with self._lock:
            routes = {}
            for app in self._apps.values():
                if app.route_prefix and not app.deleting:
                    routes[app.route_prefix] = (app.name, app.ingress,
                                                app.is_asgi)
        self._poll.set("routes", routes)


def get_or_create_controller(http_host: str = "127.0.0.1",
                             http_port: int = 8000):
    """Get the singleton controller handle, creating it if needed."""
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    except ValueError:
        pass
    handle = ray_tpu_torch.remote(ServeController).options(
        name=CONTROLLER_NAME, namespace=SERVE_NAMESPACE,
        max_concurrency=32, max_restarts=3, num_cpus=0).remote(
        http_host, http_port)
    try:
        handle._wait_until_ready(timeout=30)
        return handle
    except ray_tpu_torch.ActorError:
        # lost the creation race; fetch the winner
        return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
