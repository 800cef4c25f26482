"""The port's observability plane against the JAX package's, on the CPU.

Leaf modules (util/metrics, util/tracing, util/flight_recorder,
util/journal) are copies: the same operations give the same snapshots,
Prometheus text, span rows and events, and journal segments written by
either package replay in the other.  The engine's hooks mirror
tests/test_serve_slo.py and tests/test_device_stats.py on the port's
engine (device="cpu"), and then the same requests go through a classic
JAX engine and the port's classic and pipelined engines on bridged
weights: SLO samples, phase spans, flight-recorder events and the step
sampler's host fields must agree.
"""

import contextvars
import dataclasses
import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine
from ray_tpu.util import flight_recorder as jfr
from ray_tpu.util import journal as jjournal
from ray_tpu.util import metrics as jmetrics
from ray_tpu.util import tracing as jtracing

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
ttf = importlib.import_module(f"{PORT}.models.transformer")
tse = importlib.import_module(f"{PORT}.serve.llm_engine")
tfr = importlib.import_module(f"{PORT}.util.flight_recorder")
tjournal = importlib.import_module(f"{PORT}.util.journal")
tmetrics = importlib.import_module(f"{PORT}.util.metrics")
ttracing = importlib.import_module(f"{PORT}.util.tracing")
tds = importlib.import_module(f"{PORT}.util.device_stats")
tdec = importlib.import_module(f"{PORT}.models.decoding")

KW = dict(page_size=4, num_pages=64, max_batch=4, queue_timeout_s=0)
TRACE = ("cd" * 8, "ee" * 8)


# ---------------------------------------------------------------------------
# Leaf modules: copies that behave alike
# ---------------------------------------------------------------------------

def _metric_ops(m, tag):
    """One sequence of metric operations on a metrics module; returns
    its metrics' snapshots."""
    c = m.Counter(f"obs_parity_{tag}_total", "Requests, by route.",
                  tag_keys=("route",))
    g = m.Gauge(f"obs_parity_{tag}_depth", "Queue depth.")
    h = m.Histogram(f"obs_parity_{tag}_seconds", "Latency.",
                    boundaries=(0.01, 0.1, 1.0), tag_keys=("outcome",))
    c.inc(tags={"route": "a"})
    c.inc(2.5, tags={"route": 'b"q\\n'})
    c.set_default_tags({"route": "d"}).inc()
    g.set(3)
    g.set(7.25)
    for v, o in ((0.005, "ok"), (0.05, "ok"), (5.0, "ok"), (0.5, "shed")):
        h.observe(v, tags={"outcome": o})
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        g.set(1, tags={"nope": "x"})
    return [c.snapshot(), g.snapshot(), h.snapshot()]


def test_metrics_snapshots_and_prometheus_text_match():
    tag = f"{time.monotonic_ns()}"
    ref, port = _metric_ops(jmetrics, tag), _metric_ops(tmetrics, tag)
    assert port == ref
    assert tmetrics.snapshots_to_prometheus_text(port) == \
        jmetrics.snapshots_to_prometheus_text(ref)
    # Merging two processes' snapshots, and the journal (JSON) form.
    twice = port + [dict(s) for s in port]
    assert tmetrics.merge_snapshots(twice) == \
        jmetrics.merge_snapshots(ref + [dict(s) for s in ref])
    safe = tmetrics.snapshots_json_safe(port)
    assert safe == jmetrics.snapshots_json_safe(ref)
    assert tmetrics.snapshots_from_json(safe) == \
        jmetrics.snapshots_from_json(safe)
    # The process-local builtins the port carries over.
    names = {s["name"] for s in tmetrics.local_snapshots()}
    assert {"ray_tpu_trace_dropped_spans_total",
            "ray_tpu_flight_recorder_events",
            "ray_tpu_flight_recorder_capacity",
            "ray_tpu_flight_recorder_dropped_total"} <= names


def _span_ops(tr):
    """The same span operations on a tracing module, in a fresh
    contextvars context (no task context an earlier test left behind)."""
    return contextvars.Context().run(_span_ops_in_context, tr)


def _span_ops_in_context(tr):
    was = tr.is_tracing_enabled()
    tr.clear_spans()
    tr.enable_tracing()
    try:
        tr.record_span("root", 10.0, 12.5, attributes={"a": 1},
                       parent_id="p" * 16, trace_id="t" * 16,
                       span_id="s" * 16)
        with tr.trace_span("outer", {"k": "v"}) as outer:
            with tr.trace_span("inner"):
                pass
        tr.record_span("forced", 1.0, 2.0, trace_id="u" * 16,
                       span_id="f" * 16, force=True)
        cursor = tr.collect_spans_since(0, max_spans=2)
        spans = tr.get_spans()
    finally:
        if not was:
            tr.disable_tracing()
    return spans, outer, cursor


def test_tracing_span_rows_match():
    ref, ref_outer, ref_cur = _span_ops(jtracing)
    port, port_outer, port_cur = _span_ops(ttracing)
    assert [s["name"] for s in port] == [s["name"] for s in ref] == \
        ["root", "inner", "outer", "forced"]
    for r, p in zip(ref, port):
        assert set(p) == set(r)
        assert (p["name"], p["attributes"]) == (r["name"], r["attributes"])
        if r["name"] in ("root", "forced"):
            assert p == r  # fixed ids and times: the same row
        else:
            assert p["end"] >= p["start"]
    # Minted ids differ between the packages; the nesting holds.
    assert port[1]["parent_id"] == port_outer
    assert ref[1]["parent_id"] == ref_outer
    assert port[2]["parent_id"] is None and ref[2]["parent_id"] is None
    assert [ttracing.span_row_to_dict(r) for r in port_cur["rows"]][0] \
        == [jtracing.span_row_to_dict(r) for r in ref_cur["rows"]][0]
    assert port_cur["cursor"] == ref_cur["cursor"] == 2
    assert ttracing.spans_to_chrome_events(port[:1]) == \
        jtracing.spans_to_chrome_events(ref[:1])
    for header in ("ab" * 8, "ab" * 8 + ":" + "cd" * 8, "zz", ""):
        assert ttracing.parse_serve_trace(header) == \
            jtracing.parse_serve_trace(header)


def test_export_chrome_trace_writes_spans(tmp_path):
    _span_ops(ttracing)
    n = ttracing.export_chrome_trace(str(tmp_path / "t.json"))
    assert n == 4 + 2  # four spans and the lane's two metadata events


def _flight_ops(fr):
    fr.configure(capacity=16, enable=True)
    fr.clear()
    for i in range(20):  # past capacity: the oldest four are dropped
        fr.record("serve", "shed", req_id=i, reason="deadline")
    fr.record("serve", "kv_export", req_id=99, pages=3, bytes=4096)
    events = fr.dump()
    stats = fr.stats()
    last = fr.dump(last=2)
    fr.configure()
    fr.clear()
    return events, stats, last


def test_flight_recorder_dump_matches():
    ref, ref_stats, ref_last = _flight_ops(jfr)
    port, port_stats, port_last = _flight_ops(tfr)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"}  # noqa: E731
                         for e in evs]
    assert strip(port) == strip(ref) and len(port) == 16
    assert strip(port_last) == strip(ref_last)
    assert port_stats == ref_stats == {"events": 16, "capacity": 16,
                                       "dropped": 5, "enabled": True}


def _write_segment(journal_mod, directory, records):
    j = journal_mod.Journal(str(directory), "flight")
    for r in records:
        j.append(r)
    assert j.flush(timeout=10)
    j.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_replays_across_packages(tmp_path, writer):
    """Segments each package writes replay in the other, record for
    record, with the same envelope (t, p, d)."""
    records = [{"category": "serve", "event": "shed", "req_id": i,
                "nested": {"x": [i, i * 0.5]}} for i in range(5)]
    mods = {"port": tjournal, "reference": jjournal}
    other = "reference" if writer == "port" else "port"
    _write_segment(mods[writer], tmp_path, records)
    got = mods[other].replay(str(tmp_path), "flight")
    mine = mods[writer].replay(str(tmp_path), "flight")
    assert [e["d"] for e in got] == records
    assert got == mine
    assert mods[other].list_segments(str(tmp_path), "flight") == \
        mods[writer].list_segments(str(tmp_path), "flight")


def test_metrics_journal_round_trip(tmp_path, monkeypatch):
    """The port's metrics journal record replays through the reference
    into the same Prometheus text."""
    monkeypatch.setenv("RAY_TPU_OPS_JOURNAL_DIR", str(tmp_path))
    tjournal.reset()
    try:
        snaps = _metric_ops(tmetrics, f"j{time.monotonic_ns()}")
        tmetrics._journal_snapshots(snaps)
        tjournal.flush_all(timeout=10)
    finally:
        tjournal.reset()
    (env,) = jjournal.replay(str(tmp_path), "metrics")
    back = jmetrics.snapshots_from_json(env["d"]["snapshots"])
    assert jmetrics.snapshots_to_prometheus_text(back) == \
        tmetrics.snapshots_to_prometheus_text(snaps)


# ---------------------------------------------------------------------------
# The engine's hooks: mirrors of test_serve_slo.py / test_device_stats.py
# ---------------------------------------------------------------------------

def _engine(**over):
    return tse.LLMEngine(ttf.TransformerConfig.tiny(), device="cpu",
                         **{**KW, **over})


def _drain(eng):
    done = {}
    while eng.has_work():
        done.update(eng.step())
    return done


def _hist_counts(name):
    for s in tmetrics.local_snapshots():
        if s["name"] == name:
            return {k: v[2] for k, v in s["series"].items()}
    return {}


_ADMITTED = (("outcome", "admitted"),)
_SHED = (("outcome", "shed"),)


def _serve_spans():
    return [ttracing.span_row_to_dict(r)
            for r in ttracing.collect_spans_since(0)["rows"]
            if r[3].startswith("serve.")]


@pytest.mark.parametrize("multi_step", [1, 4])
def test_queue_wait_observed_on_admit_and_shed(multi_step):
    """test_serve_slo.py test_queue_wait_observed_on_admit_and_shed."""
    before = _hist_counts("ray_tpu_serve_queue_wait_seconds")
    eng = _engine(multi_step=multi_step)
    eng.add_request([1, 2, 3, 4, 5], 4)
    _drain(eng)
    mid = _hist_counts("ray_tpu_serve_queue_wait_seconds")
    assert mid.get(_ADMITTED, 0) == before.get(_ADMITTED, 0) + 1
    eng.add_request([6, 7, 8], 4, deadline_s=0.001)
    time.sleep(0.05)
    eng.step()
    after = _hist_counts("ray_tpu_serve_queue_wait_seconds")
    assert after.get(_SHED, 0) == mid.get(_SHED, 0) + 1
    assert after.get(_ADMITTED, 0) == mid.get(_ADMITTED, 0)
    shed = [s for s in eng.slo_samples if "shed" in s]
    assert shed and shed[-1]["queue_wait"] > 0


@pytest.mark.parametrize("multi_step", [1, 4])
def test_engine_phase_spans_and_slo_sample(multi_step):
    """test_serve_slo.py test_engine_phase_spans_and_slo_sample, on the
    classic and the pipelined engine (a wave's first token is stamped at
    its reconcile)."""
    ttracing.clear_spans()
    t_before = _hist_counts("ray_tpu_serve_ttft_seconds")
    eng = _engine(multi_step=multi_step)
    eng.add_request([1, 2, 3, 4, 5, 6], 4, trace_ctx=TRACE)
    _drain(eng)
    journey = {s["name"]: s for s in _serve_spans()}
    assert {"serve.queue", "serve.prefill", "serve.decode"} <= set(journey)
    for s in journey.values():
        assert (s["trace_id"], s["parent_id"]) == TRACE
        assert s["start"] <= s["end"]
    assert journey["serve.queue"]["end"] == \
        journey["serve.prefill"]["start"]
    assert journey["serve.prefill"]["end"] == \
        journey["serve.decode"]["start"]
    assert journey["serve.decode"]["attributes"]["tokens"] == 4
    assert "clock_off" in journey["serve.queue"]["attributes"]
    sample = eng.slo_samples[-1]
    assert sample["tokens"] == 4 and sample["ttft"] > 0
    assert sample["tpot"] >= 0 and "queue_wait" in sample
    t_after = _hist_counts("ray_tpu_serve_ttft_seconds")
    assert t_after.get((), 0) == t_before.get((), 0) + 1


def test_untraced_request_records_no_spans():
    """test_serve_slo.py test_untraced_request_records_no_spans."""
    ttracing.clear_spans()
    eng = _engine()
    eng.add_request([1, 2, 3, 4], 4)
    _drain(eng)
    assert not _serve_spans()
    assert eng.slo_samples and eng.slo_samples[-1]["tokens"] == 4


def test_engine_step_sampler(monkeypatch):
    """test_serve_slo.py test_engine_step_sampler."""
    monkeypatch.setenv("RAY_TPU_SERVE_STEP_SAMPLE_EVERY", "1")
    eng = _engine()
    eng.add_request([1, 2, 3, 4, 5], 4)
    _drain(eng)
    s = eng.engine_sample
    assert s is not None and s["step"] >= 1
    for key in ("ts", "active", "waiting", "free_pages",
                "inflight_chunks", "prefill_tokens", "completed"):
        assert key in s, s
    assert s["completed"] >= 0 and s["free_pages"] > 0
    monkeypatch.setenv("RAY_TPU_SERVE_STEP_SAMPLE_EVERY", "0")
    eng2 = _engine()
    eng2.add_request([1, 2, 3], 4)
    _drain(eng2)
    assert eng2.engine_sample is None


def test_engine_settings_from_environment(monkeypatch):
    """Admission settings left None come from the reference's variables;
    the SLO ring's bound is read at construction."""
    monkeypatch.setenv("RAY_TPU_SERVE_MAX_QUEUE", "2")
    monkeypatch.setenv("RAY_TPU_SERVE_QUEUE_TIMEOUT_S", "7.5")
    monkeypatch.setenv("RAY_TPU_SERVE_PREFILL_BUDGET", "64")
    monkeypatch.setenv("RAY_TPU_SERVE_SLO_SAMPLES", "3")
    eng = tse.LLMEngine(ttf.TransformerConfig.tiny(), device="cpu",
                        page_size=4, num_pages=64, max_batch=4)
    assert (eng.max_queue, eng.queue_timeout_s, eng.prefill_budget) == \
        (2, 7.5, 64)
    assert eng.slo_samples.maxlen == 3
    eng.add_request([1, 2], 2)
    eng.add_request([3, 4], 2)
    with pytest.raises(tse.QueueFull):
        eng.add_request([5, 6], 2)
    explicit = tse.LLMEngine(ttf.TransformerConfig.tiny(), device="cpu",
                             page_size=4, num_pages=64, max_batch=4,
                             max_queue=0, queue_timeout_s=0,
                             prefill_budget=0)
    assert (explicit.max_queue, explicit.queue_timeout_s,
            explicit.prefill_budget) == (0, 0.0, 0)


@pytest.mark.parametrize("multi_step", [1, 4])
def test_engine_step_sampler_device_fields(monkeypatch, multi_step):
    """test_device_stats.py test_engine_step_sampler_device_fields: the
    sampler's device fields, the ledger's two pools and the decoding
    entry points' compile accounting.  No peak is known on the CPU, so
    the fraction is 0.0 until the overrides name one."""
    monkeypatch.setenv("RAY_TPU_SERVE_STEP_SAMPLE_EVERY", "2")
    tds.reset()
    tds.set_enabled(True)
    # Forget the signatures earlier tests in this process have seen.
    for name in dir(tdec):
        fn = getattr(tdec, name)
        if isinstance(fn, tds._CompileTracked):
            monkeypatch.setattr(fn, "_seen_sigs", set())
    c = ttf.TransformerConfig.tiny()
    runs = []
    for override in (False, True):
        if override:
            monkeypatch.setenv("RAY_TPU_DEVICE_HBM_GBPS", "1")
            monkeypatch.setenv("RAY_TPU_DEVICE_PEAK_TFLOPS", "0.001")
        eng = tse.LLMEngine(c, device="cpu", page_size=4, num_pages=64,
                            max_batch=4, multi_step=multi_step)
        rng = np.random.default_rng(0)
        for _ in range(4):
            eng.add_request(rng.integers(1, c.vocab_size, 8).tolist(),
                            max_new_tokens=8)
        samples = []
        while eng.has_work():
            eng.step()
            if eng.engine_sample is not None and (
                    not samples or eng.engine_sample is not samples[-1]):
                samples.append(eng.engine_sample)
        for sample in samples[1:]:  # the first one opens the window
            for key in ("tokens_per_s", "roofline_fraction", "mfu",
                        "modeled_bytes_per_token"):
                assert key in sample, sample
        runs.append([s for s in samples if s.get("tokens_per_s", 0) > 0])
    off, on = runs
    assert off and on
    assert all(s["roofline_fraction"] == s["mfu"] == 0.0 for s in off)
    assert all(0 < s["roofline_fraction"] <= 1 and s["mfu"] > 0
               for s in on)
    comps = tds.ledger()["components"]
    weights = sum(p.numel() * p.element_size()
                  for p in _leaves(eng.params))
    assert comps["weights"] == weights
    itemsize = torch.empty((), dtype=c.dtype).element_size()
    assert comps["kv_pages"] == 2 * c.num_layers * 64 * 4 * \
        c.num_kv_heads * c.head_dim_ * itemsize
    counts = tds.compile_counts()
    assert ("decoding.prefill" if multi_step == 1
            else "decoding.packed_prefill_admit") in counts, counts
    ls = tds.last_step()
    assert ls is not None and ls["plane"] == "serve"
    tds.reset()


def test_tied_head_counted_once():
    """A tensor two names share (a head tied to the embedding) is
    attributed to the ledger once."""
    c = ttf.TransformerConfig.tiny()
    params = ttf.init_params(c, seed=0, device="cpu", dtype=c.dtype)
    params["lm_head_alias"] = params["tok_embed"]
    tds.reset()
    eng = tse.LLMEngine(c, params, device="cpu", page_size=4, num_pages=8,
                        max_batch=2)
    once = sum(p.numel() * p.element_size() for k, p in
               _items(eng.params) if k != "lm_head_alias")
    assert tds.ledger()["components"]["weights"] == once
    tds.reset()


def _leaves(tree):
    return [p for _, p in _items(tree)]


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, k)
        else:
            yield k, v


# ---------------------------------------------------------------------------
# Engine against engine: the JAX classic engine and the port's engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jc = jtf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64,
        dtype=jnp.float32, use_flash=False)
    kw = {f.name: getattr(jc, f.name)
          for f in dataclasses.fields(jtf.TransformerConfig)}
    tc = ttf.TransformerConfig(**{**kw, "dtype": torch.float32,
                                  "param_dtype": torch.float32})
    jp = jtf.init_params(jc, jax.random.key(0))
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                               device="cpu")
    return jc, jp, tc, tp


def _both(setup, **kw):
    """A classic JAX engine, and the port's classic and pipelined ones."""
    jc, jp, tc, tp = setup
    return [("jax", JaxEngine(jc, jp, **{**KW, **kw})),
            ("classic", tse.LLMEngine(tc, tp, device="cpu",
                                      **{**KW, **kw})),
            ("pipelined", tse.LLMEngine(tc, tp, device="cpu", multi_step=4,
                                        **{**KW, **kw}))]


def _prompts(seed, *lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=n).tolist() for n in lens]


def test_slo_samples_and_spans_match_jax(setup, monkeypatch):
    """Six requests (budgets distinct, every other one traced): the same
    SLO-sample keys and tokens per request, the same serve.* span names
    and attribute keys per traced request, and, on the classic engines,
    the sampler's host fields step for step."""
    monkeypatch.setenv("RAY_TPU_SERVE_STEP_SAMPLE_EVERY", "1")
    prompts = _prompts(3, 5, 9, 3, 12, 7, 4)
    budgets = [3, 9, 5, 7, 4, 6]
    got = {}
    for name, eng in _both(setup):
        trace = jtracing if name == "jax" else ttracing
        trace.clear_spans()
        ids = [eng.add_request(p, n, trace_ctx=TRACE if i % 2 else None)
               for i, (p, n) in enumerate(zip(prompts, budgets))]
        samples, streams = [], {}
        while eng.has_work():
            streams.update(eng.step())
            samples.append({k: eng.engine_sample[k] for k in (
                "step", "active", "waiting", "free_pages",
                "prefill_tokens", "completed")})
        spans = {}
        for s in trace.get_spans():
            if s["name"].startswith("serve."):
                spans.setdefault(s["attributes"]["req"], {})[s["name"]] = \
                    sorted(s["attributes"])
        got[name] = dict(
            streams=[streams[i] for i in ids],
            slo=sorted((s["tokens"], sorted(s)) for s in eng.slo_samples),
            spans=spans, samples=samples)
    ref = got["jax"]
    assert [len(s) for s in ref["streams"]] == budgets
    assert sorted(ref["spans"]) == [1, 3, 5]
    for name in ("classic", "pipelined"):
        assert got[name]["streams"] == ref["streams"], name
        assert got[name]["slo"] == ref["slo"], name
        assert got[name]["spans"] == ref["spans"], name
    assert got["classic"]["samples"] == ref["samples"]


def test_flight_recorder_events_match_jax(setup):
    """A run with a full queue, a deadline shed, a KV export, an abort
    and the import of the exported bundle records the same events, in
    the same order and with the same fields, on each engine."""
    p = _prompts(9, 6, 7, 5, 4)
    got = {}
    for name, eng in _both(setup, max_batch=2, max_queue=3):
        fr = jfr if name == "jax" else tfr
        fr.clear()
        a = eng.add_request(p[0], 8)
        eng.add_request(p[1], 8)
        eng.add_request(p[2], 8, deadline_s=0.001)
        with pytest.raises(RuntimeError, match="queue full"):
            eng.add_request(p[3], 8)
        time.sleep(0.02)
        eng.step()  # sheds the third, admits the first two
        bundle = eng.export_kv(a)
        assert eng.abort(a)
        eng.import_kv(bundle, 8)
        _drain(eng)
        got[name] = [(e["category"], e["event"], sorted(e))
                     for e in fr.dump()]
        fr.clear()
    events = [e[1] for e in got["jax"]]
    assert events == ["queue_full", "shed", "kv_export", "abort",
                      "kv_import"]
    assert got["classic"] == got["jax"]
    assert got["pipelined"] == got["jax"]
