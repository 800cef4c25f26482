"""Typed wire contract for the control-plane frame protocol.

Counterpart of the reference's proto IDL tier (src/ray/protobuf/*.proto
— the typed schemas every language speaks).  The framed RPC layer
(core/rpc.py) carries pickled dicts between Python peers and JSON dicts
for the cross-language door; this module is the SCHEMA for those
messages: one declarative table of every public op, its required and
optional fields with types, machine-checkable on both ends.

`validate(msg)` is cheap enough for ingress paths that accept untrusted
frames (the JSON door, the serve frame ingress); Python-internal paths
trust their own senders and skip it, exactly like generated proto
bindings trusting in-process construction.  `export_schema()` dumps the
contract as JSON for non-Python client generators (the C++ client's
hand-built frames can be checked against it in CI —
tests/test_cpp_client.py).

Field types: "str", "int", "float", "bool", "bytes", "list", "dict",
"any".  A trailing "?" marks the field optional.
"""

from __future__ import annotations

from typing import Any, Dict

# op -> {field: type_spec}
SCHEMA: Dict[str, Dict[str, str]] = {
    # -- registration / lifecycle --------------------------------------
    "register": {"worker_hex": "str", "pid": "int", "kind": "str",
                 "address": "str?", "env_key": "str?", "node_id": "str?"},
    "register_node": {"node_id": "str?", "resources": "dict",
                      "address": "str", "labels": "dict?",
                      "store_key": "str?", "shm_dir": "str?"},
    "worker_online": {},
    "ping": {},
    # -- objects -------------------------------------------------------
    "put_object": {"obj": "str", "size": "int", "inline": "bytes?",
                   "in_shm": "bool?", "is_error": "bool?"},
    "put_object_batch": {"items": "list"},
    "subscribe_objects": {"objs": "list", "grace": "bool?"},
    "subscribe_object": {"obj": "str", "grace": "bool?"},
    "fetch_object": {"obj": "str", "with_meta": "bool?"},
    "fetch_chunk": {"obj": "str", "size": "int", "offset": "int",
                    "length": "int"},
    # Node-to-node object plane (node_manager._handle): pull probe +
    # push-broadcast stream (core/object_plane.py PushManager).
    "has_object": {"obj": "str"},
    # Worker -> local node manager: single-flight a remote fetch into
    # this node's shared arena ({addr: ""} means the head's store).
    "pull_object": {"obj": "str", "size": "int", "addr": "str?"},
    "push_begin": {"obj": "str", "size": "int"},
    "push_chunk": {"obj": "str", "offset": "int", "data": "bytes"},
    "push_end": {"obj": "str"},
    "incref": {"obj": "str", "n": "int?"},
    "incref_batch": {"objs": "list"},
    "decref": {"obj": "str", "n": "int?"},
    "decref_batch": {"objs": "list"},
    # Coalesced net ref-count vector: {obj_hex: delta} with positive
    # deltas increfs and negative deltas decrefs (control-plane
    # micro-batching; runtime._head_frames → gcs._op_refcount_delta).
    "refcount_delta": {"deltas": "dict"},
    "free_objects": {"objs": "list"},
    "forget_object": {"obj": "str"},
    "object_replica": {"obj": "str"},
    "object_shm_info": {"obj": "str"},
    "report_object_lost": {"obj": "str"},
    # -- tasks ---------------------------------------------------------
    "submit_task": {"spec": "any"},
    "submit_task_batch": {"specs": "list"},
    "submit_named_task": {"name": "str", "args": "list?",
                          "num_cpus": "float?", "num_tpus": "float?",
                          "max_retries": "int?"},
    "task_done": {"task_id": "str", "failed": "bool?", "puts": "list?",
                  "decrefs": "list?"},
    "get_object_json": {"obj": "str"},
    "cancel_object": {"obj": "str", "force": "bool?"},
    "cancel_task": {"task": "str", "force": "bool?"},
    # -- C++-defined tasks/actors (cpp/include/ray_tpu/worker.h) -------
    "register_cpp_functions": {"functions": "list?",
                               "actor_classes": "list?"},
    "cpp_task_done": {"return": "str", "result": "any?", "error": "str?"},
    "create_cpp_actor": {"actor_class": "str", "args": "list?"},
    "list_cpp_functions": {},
    "submit_cpp_actor_task": {"instance": "str", "method": "str",
                              "args": "list?"},
    # -- worker leases (owner-direct task path) ------------------------
    "request_lease": {"token": "int?", "resources": "dict?",
                      "runtime_env": "dict?", "count": "int?"},
    "release_lease": {"workers": "list"},
    "kill_worker": {"worker": "str"},
    "task_events": {"events": "list"},
    # -- observability: span harvest / profiling / watchdog ------------
    # Head→worker pull of the worker's bounded span ring, cursor-based
    # and capped per reply (gcs._op_harvest_spans ↔ runtime._on_push).
    "collect_spans": {"token": "str", "cursor": "int", "limit": "int"},
    "collect_spans_result": {"token": "str", "cursor": "int",
                             "rows": "list", "missed": "int?",
                             "pid": "int?", "worker": "str?"},
    # Client→head: harvest every worker's ring (incremental, merged by
    # trace_id on the head) and return matching spans.
    "harvest_spans": {"trace_id": "str?", "max_spans": "int?",
                      "timeout_s": "float?", "since": "float?",
                      "poll": "bool?"},
    # Worker→head resource sample; rides the coalescing flusher
    # (runtime._head_frames collapses a run to the newest sample).
    "profile_report": {"sample": "dict"},
    "get_profile": {"samples": "bool?"},
    # Client→head: retune/toggle every worker's sampler at runtime
    # (bench_profiling.py's A/B switch).
    "set_profile_config": {"enabled": "bool?", "interval_s": "float?"},
    # One-way announce that a PullManager leader started pulling an
    # object to this node (locality tie-break credit in gcs._pick_node).
    "object_pull_started": {"obj": "str"},
    # -- functions -----------------------------------------------------
    "put_func": {"func_id": "str", "blob": "bytes"},
    "get_func": {"func_id": "str"},
    # -- actors --------------------------------------------------------
    "create_actor": {"spec": "any"},
    "subscribe_actor": {"actor": "str"},
    "actor_ready": {"actor": "str", "address": "str"},
    "actor_creation_failed": {"actor": "str", "reason": "str?"},
    "kill_actor": {"actor": "str", "no_restart": "bool?"},
    "get_named_actor": {"name": "str", "namespace": "str?"},
    "list_named_actors": {"namespace": "str?"},
    "register_objects": {"objs": "list", "actor": "str?"},
    # -- KV ------------------------------------------------------------
    # value: bytes from Python peers; the JSON door also takes plain
    # strings (the C++ client's convenience form, utf-8 at rest).
    "kv_put": {"key": "str", "value": "bytes|str", "overwrite": "bool?"},
    "kv_get": {"key": "str"},
    "kv_del": {"key": "str"},
    "kv_keys": {"prefix": "str?"},
    "kv_exists": {"key": "str"},
    # -- cluster / state -----------------------------------------------
    "cluster_resources": {},
    "available_resources": {},
    "list_tasks": {}, "list_actors": {}, "list_objects": {},
    "list_workers": {}, "list_nodes": {},
    "list_placement_groups": {},
    "add_node": {"resources": "dict", "node_id": "str?", "labels": "dict?"},
    "remove_node": {"node_id": "str"},
    # -- graceful drain (reference DrainRaylet / autoscaler DrainNode) --
    "drain_node": {"node_id": "str", "reason": "str?"},
    "drain_status": {"node_id": "str"},
    "objects_migrated": {"node_id": "str", "dest_node": "str",
                         "results": "dict"},
    "shutdown_cluster": {},
    "get_load": {},
    # -- placement groups ----------------------------------------------
    "create_pg": {"bundles": "list", "strategy": "str?", "name": "str?"},
    "remove_pg": {"pg": "str"},
    "pg_state": {"pg": "str"},
    # -- serve frame ingress (proxy.py FrameIngress) -------------------
    "serve_request": {"route": "str", "payload": "any?", "headers": "dict?"},
    # -- serve disaggregation (llm.py / llm_engine.py handoff) ---------
    # Prefill→decode KV handoff: the exported page bundle (k/v are
    # [L, n_ctx, page, KD] tensors; "done" short-circuits requests that
    # finished at prefill), the object-plane pointer it rides as, and
    # the hot-prefix digest replicas advertise for locality routing.
    # "trace" is the request-journey linkage [trace_id, span_id]: the
    # decode leg parents its spans under the prefill leg's replica
    # span, so a disaggregated request renders as ONE connected trace.
    "serve_kv_export": {"req": "int", "prompt": "list",
                        "generated": "list", "context_len": "int",
                        "page_size": "int", "num_layers": "int",
                        "kd": "int", "dtype": "str",
                        "chain_keys": "list?", "done": "list?",
                        "k": "any?", "v": "any?", "trace": "list?"},
    "serve_kv_import": {"obj": "str", "size": "int",
                        "trace": "list?"},
    "serve_prefix_digest": {"keys": "list"},
    # -- push / dispatch ops (head→client, head→node, owner→worker) ----
    # These ride Python-internal pickled frames, so runtime ingress
    # never validates them — but they are part of the wire contract all
    # the same, and raylint's conformance pass requires every op a
    # dispatch site handles to be declared here (and vice versa).
    # Task execution pushed to workers (worker._handle_direct /
    # runtime dispatch).
    "execute_task": {"spec": "any"},
    "pool_task": {"spec": "any"},
    "pool_task_batch": {"specs": "list"},
    "actor_task": {"spec": "any"},
    "actor_task_batch": {"specs": "list"},
    "cancel_pool_task": {"task": "str"},
    "create_actor_instance": {"spec": "any"},
    "exit": {},
    # Owner-direct result return (worker → submitting owner).
    "direct_result": {"obj": "str", "data": "bytes?", "is_error": "bool?"},
    "direct_result_batch": {"results": "list"},
    "direct_result_remote": {"obj": "str"},
    # Head→client object/actor/cluster notifications.
    "object_ready": {"obj": "str", "size": "int?", "inline": "bytes?",
                     "in_shm": "bool?", "is_error": "bool?",
                     "node": "str?", "addr": "str?"},
    "actor_update": {"actor": "str", "state": "str?", "address": "str?",
                     "reason": "str?", "max_task_retries": "int?"},
    "resource_view": {"seq": "int", "epoch": "str", "nodes": "any"},
    "cluster_view": {},
    "node_stats": {"stats": "dict"},
    # Head→owner lease protocol (the grant/revoke side of
    # request_lease/release_lease above).
    "lease_granted": {"token": "int", "workers": "list",
                      "denied": "bool?", "error": "str?"},
    "lease_revoked": {"worker": "str", "reason": "str?"},
    # Head→node worker lifecycle.
    "spawn_worker": {"worker_hex": "str", "kind": "str",
                     "env_key": "str?", "namespace": "str?",
                     "runtime_env": "dict?"},
    "worker_alive": {"worker_hex": "str"},
    "worker_spawn_failed": {"worker_hex": "str", "error": "str?"},
    "worker_setup_failed": {"env_key": "str", "error": "str?"},
    "get_runtime_env": {"env_key": "str"},
    # Object plane maintenance (head→node).
    "delete_object": {"obj": "str"},
    "object_info": {"obj": "str"},
    "migrate_objects": {"objects": "list", "dest": "str?",
                        "dest_node": "str?"},
    # Streaming generator consumer→head backpressure/free credit.
    "free_stream": {"task": "str", "from_index": "int",
                    "eos_consumed": "bool?", "count": "int?"},
    # Profiling / diagnostics.
    "profile": {"kind": "str", "token": "str?", "duration_s": "float?"},
    "profile_worker": {"worker_hex": "str", "kind": "str?",
                       "duration_s": "float?", "timeout_s": "float?"},
    "profile_result": {"token": "str", "data": "any?"},
    "profile_config": {"enabled": "bool?", "interval_s": "float?"},
    "flight_recorder": {"last": "int?", "since": "float?"},
}

_TYPES = {
    "str": str, "int": int, "float": (int, float), "bool": bool,
    "bytes": (bytes, bytearray), "list": (list, tuple), "dict": dict,
}


class SchemaError(ValueError):
    pass


def validate(msg: Any) -> None:
    """Raise SchemaError if msg is not a well-formed frame for its op.

    Unknown ops fail closed — an ingress accepting untrusted frames
    must not forward ops the contract doesn't name."""
    if not isinstance(msg, dict):
        raise SchemaError(f"frame must be a dict, got {type(msg).__name__}")
    op = msg.get("op")
    if not isinstance(op, str):
        raise SchemaError("frame missing string 'op'")
    fields = SCHEMA.get(op)
    if fields is None:
        raise SchemaError(f"unknown op {op!r}")
    for name, spec in fields.items():
        optional = spec.endswith("?")
        tname = spec.rstrip("?")
        if name not in msg or msg[name] is None:
            if optional:
                continue
            raise SchemaError(f"op {op!r} missing required field {name!r}")
        if tname == "any":
            continue
        expected = tuple(
            t for alt in tname.split("|")
            for t in (_TYPES[alt] if isinstance(_TYPES[alt], tuple)
                      else (_TYPES[alt],)))
        if not isinstance(msg[name], expected):
            raise SchemaError(
                f"op {op!r} field {name!r}: expected {tname}, got "
                f"{type(msg[name]).__name__}")
    extra = set(msg) - set(fields) - {"op"}
    if extra:
        raise SchemaError(f"op {op!r} has undeclared fields {sorted(extra)}")


def export_schema() -> Dict[str, Any]:
    """The contract as plain JSON (for non-Python client generators)."""
    return {"version": 1, "ops": SCHEMA}
