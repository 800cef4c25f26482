"""The port's wire contract against the reference's, on the CPU.

The port's core/wire_schema.py is the JAX package's contract carried over
unchanged (one contract for both packages, pinned by the committed
WIRE_CONFORMANCE.json): it equals the reference's op for op and field for
field, the golden frames replay through the port's ingress validation
(decoded by the port's own rpc._from_jsonable) with the reference's
verdicts, and the cases of tests/test_wire_schema.py hold for it.
"""

import importlib
import json
import pathlib

import pytest

from ray_tpu.core import rpc as ref_rpc
from ray_tpu.core import wire_schema as ref_ws

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
ws = importlib.import_module(f"{PORT}.core.wire_schema")
rpc = importlib.import_module(f"{PORT}.core.rpc")

_DOC = pathlib.Path(__file__).resolve().parent.parent / "WIRE_CONFORMANCE.json"


def _load():
    with open(_DOC) as f:
        return json.load(f)


def test_schema_equals_the_reference_op_for_op():
    assert list(ws.SCHEMA) == list(ref_ws.SCHEMA)
    for op, fields in ref_ws.SCHEMA.items():
        assert ws.SCHEMA[op] == fields, op
    assert ws.export_schema() == ref_ws.export_schema()
    assert ws._TYPES == ref_ws._TYPES


def test_schema_matches_the_committed_corpus():
    committed = _load()["schema"]
    assert committed == json.loads(json.dumps(ws.export_schema()))


def test_golden_frames_replay_through_port_ingress_validation():
    """tests/test_wire_conformance.py's replay, through the port: each
    golden frame decodes as the reference's JSON door decodes it and
    validates, or fails validation, as recorded."""
    doc = _load()
    n_valid = n_invalid = 0
    for case in doc["golden"]:
        frame = rpc._from_jsonable(case["frame"])
        assert frame == ref_rpc._from_jsonable(case["frame"]), case["case"]
        if case["valid"]:
            ws.validate(frame)  # must not raise
            n_valid += 1
        else:
            with pytest.raises(ws.SchemaError):
                ws.validate(frame)
            n_invalid += 1
    assert n_valid >= 90 and n_invalid >= 150


def test_every_schema_op_has_golden_coverage():
    covered = {g["op"] for g in _load()["golden"] if g["valid"]}
    assert set(ws.SCHEMA) <= covered


# -- tests/test_wire_schema.py, case for case ---------------------------------


def test_validate_accepts_wellformed_frames():
    ws.validate({"op": "put_object", "obj": "ab" * 14, "size": 3,
                 "inline": b"xyz"})
    ws.validate({"op": "kv_put", "key": "k", "value": b"v",
                 "overwrite": True})
    ws.validate({"op": "serve_request", "route": "/app",
                 "payload": {"x": 1}})
    ws.validate({"op": "register", "worker_hex": "ff" * 14, "pid": 1,
                 "kind": "driver"})


def test_validate_rejects_malformed_frames():
    with pytest.raises(ws.SchemaError, match="unknown op"):
        ws.validate({"op": "no_such_op"})
    with pytest.raises(ws.SchemaError, match="missing required"):
        ws.validate({"op": "put_object", "size": 3})
    with pytest.raises(ws.SchemaError, match="expected int"):
        ws.validate({"op": "put_object", "obj": "ab", "size": "big"})
    with pytest.raises(ws.SchemaError, match="undeclared"):
        ws.validate({"op": "kv_get", "key": "k", "sneaky": 1})
    with pytest.raises(ws.SchemaError, match="dict"):
        ws.validate(["op", "ping"])


def test_export_schema_is_json_serializable():
    blob = json.dumps(ws.export_schema())
    assert json.loads(blob)["ops"]["submit_task"] == {"spec": "any"}


def test_cpp_client_frames_conform():
    """The frames the C++ client builds by hand (cpp/) pass the port's
    validation too; the named-task frame keeps the contract's accelerator
    field name (`num_tpus`), which the port's head counts as GPUs."""
    cpp_frames = [
        {"op": "register", "worker_hex": "aa" * 14, "pid": 42,
         "kind": "cpp"},
        {"op": "ping"},
        {"op": "kv_put", "key": "k", "value": b"v", "overwrite": True},
        {"op": "kv_get", "key": "k"},
        {"op": "submit_named_task", "name": "f", "args": [1, 2],
         "num_cpus": 1.0},
        {"op": "submit_named_task", "name": "f", "num_tpus": 1.0},
        {"op": "get_object_json", "obj": "ab" * 14},
        {"op": "list_nodes"},
        {"op": "cluster_resources"},
    ]
    for frame in cpp_frames:
        ws.validate(frame)


def test_schema_covers_hot_control_ops():
    for op in ("submit_task", "submit_task_batch", "task_done",
               "put_object", "subscribe_objects", "incref", "decref",
               "incref_batch", "register_objects", "create_actor",
               "actor_ready", "kill_actor"):
        assert op in ws.SCHEMA, op
