"""Head/driver runtime: starts the control plane in-process and connects.

Counterpart of ray.init()'s head path (python/ray/_private/worker.py:1225 +
node.py start_head_processes): here the control server runs as threads in
the driver process (one fewer process hop on a single host); worker
processes are spawned on demand by the scheduler.
"""

from __future__ import annotations

import atexit
import os
import time
import uuid
from typing import Optional

from ray_tpu_torch.core.config import (
    Config, get_config, reset_config, session_dir_for)
from ray_tpu_torch.core.gcs import ControlServer
from ray_tpu_torch.core.ids import ObjectID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.resources import ResourceSet, node_resources_from_env
from ray_tpu_torch.core.runtime import CoreClient, set_runtime


class DriverRuntime:
    def __init__(self, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[dict] = None,
                 _system_config: Optional[dict] = None,
                 namespace: str = "",
                 address: Optional[str] = None,
                 log_to_driver: bool = True,
                 thin: bool = False):
        """Head mode (default): start the control plane in-process.
        Connect mode (``address=``): attach this driver to an existing
        cluster's control server — counterpart of ray.init(address=...)
        joining a running GCS (worker.py:1225 connect-only path)."""
        reset_config()
        self.config: Config = get_config().apply_overrides(_system_config)
        if address:
            self.control = None
            control_addr = address
        else:
            session_id = uuid.uuid4().hex[:12]
            if self.config.gcs_store_path:
                # Restart path: adopt the journaled session so the shm
                # arena (still holding sealed objects) and session dir
                # are re-attached rather than recreated.
                from ray_tpu_torch.core.store_client import peek_journal_key

                prev = peek_journal_key(self.config.gcs_store_path,
                                        "__meta__/session_id")
                if prev:
                    session_id = prev
            self.session_dir = session_dir_for(session_id)
            os.makedirs(self.session_dir, exist_ok=True)
            node_res = node_resources_from_env(num_cpus, num_gpus, resources)
            self.control = ControlServer(
                session_id, self.config, node_res, self.session_dir,
                namespace=namespace)
            control_addr = self.control.address
        self.core = CoreClient(
            control_addr, WorkerID.from_random().hex(),
            kind="driver", config=self.config, thin=thin)
        if address:
            self.session_dir = self.core.session_dir
        self.namespace = namespace
        # Worker stdout/stderr → driver console (reference log_monitor.py
        # behavior; see core/log_monitor.py).
        self.log_monitor = None
        if log_to_driver:
            from ray_tpu_torch.core.log_monitor import LogMonitor
            self.log_monitor = LogMonitor(self.session_dir).start()
        self.is_initialized = True
        set_runtime(self)
        atexit.register(self._atexit)

    @property
    def address(self) -> str:
        return self.control.address if self.control is not None \
            else self.core.client.address

    def _atexit(self):
        try:
            self.shutdown()
        except Exception:
            pass

    # facade -----------------------------------------------------------
    def get(self, refs, timeout=None):
        return self.core.get(refs, timeout)

    def put(self, value):
        return self.core.put(value)

    def wait(self, refs, num_returns=1, timeout=None):
        return self.core.wait(refs, num_returns, timeout)

    def submit_task(self, *a, **kw):
        return self.core.submit_task(*a, **kw)

    def create_actor(self, *a, **kw):
        if not kw.get("namespace"):
            kw["namespace"] = self.namespace
        return self.core.create_actor(*a, **kw)

    def submit_actor_task(self, *a, **kw):
        return self.core.submit_actor_task(*a, **kw)

    def kill_actor(self, *a, **kw):
        return self.core.kill_actor(*a, **kw)

    def get_named_actor(self, name: str, namespace: str = ""):
        return self.core.get_named_actor(name, namespace or self.namespace)

    def subscribe_actor(self, *a, **kw):
        return self.core.subscribe_actor(*a, **kw)

    def wait_actor_alive(self, *a, **kw):
        return self.core.wait_actor_alive(*a, **kw)

    def on_ref_deleted(self, object_id: ObjectID):
        self.core.on_ref_deleted(object_id)

    def as_future(self, ref: ObjectRef):
        import concurrent.futures

        out: concurrent.futures.Future = concurrent.futures.Future()
        inner = self.core.object_future(ref.hex())

        def _chain(f):
            try:
                out.set_result(self.core._load_object(ref.hex(), f.result()))
            except BaseException as e:  # noqa: BLE001
                out.set_exception(e)

        inner.add_done_callback(_chain)
        return out

    def kv(self):
        return self.core.client

    # cluster info ------------------------------------------------------
    def cluster_resources(self):
        return self.core.client.call({"op": "cluster_resources"})

    def available_resources(self):
        return self.core.client.call({"op": "available_resources"})

    def state_list(self, kind: str):
        return self.core.client.call({"op": f"list_{kind}"})

    def shutdown(self):
        if not getattr(self, "is_initialized", False):
            return
        self.is_initialized = False
        set_runtime(None)
        if self.log_monitor is not None:
            try:
                self.log_monitor.stop()
            except Exception:
                pass
        try:
            from ray_tpu_torch.util.usage_stats import write_usage_report
            write_usage_report(self.session_dir)
        except Exception:
            pass
        try:
            self.core.close()
        except Exception:
            pass
        if self.control is not None:
            self.control.stop()
