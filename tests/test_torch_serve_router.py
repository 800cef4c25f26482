"""The port's serve router and multiplex model cache, on the CPU, no cluster.

The router cases of tests/test_serve_admission.py (load-feedback P2C,
staleness) and of tests/test_serve_disagg.py (role pools, prefix
locality, decode KV tie-break), the model-cache cases of
test_serve_admission.py, and a differential test: the port's Router and
the JAX package's make the same choices on the same replica entries,
load reports and random seed.
"""

import importlib
import random
import threading
import time

import pytest

from ray_tpu.serve import router as jrouter

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
trouter = importlib.import_module(f"{PORT}.serve.router")
tmultiplex = importlib.import_module(f"{PORT}.serve.multiplex")

_HEX_A = "a" * 32
_HEX_B = "b" * 32
_HEX_P = "a" * 32
_HEX_D = "b" * 32
_HEX_M = "c" * 32


def _mk_router(entries=None, mod=trouter):
    """A Router wired to an injected replica set: no controller, no poll
    thread, no cluster; exactly the state assign_replica reads."""
    r = mod.Router.__new__(mod.Router)
    r.app_name = "app"
    r.deployment = "dep"
    r._set = mod._ReplicaSet()
    s = r._set
    with s.cv:
        s.entries = entries if entries is not None else [
            {"actor_hex": _HEX_A, "max_ongoing": 8},
            {"actor_hex": _HEX_B, "max_ongoing": 8}]
        for e in s.entries:
            s.handles[e["actor_hex"]] = object()
            s.inflight.setdefault(e["actor_hex"], 0)
    return r


def _roles3():
    return [{"actor_hex": _HEX_P, "max_ongoing": 8, "role": "prefill"},
            {"actor_hex": _HEX_D, "max_ongoing": 8, "role": "decode"},
            {"actor_hex": _HEX_M, "max_ongoing": 8, "role": "mixed"}]


# -- tests/test_serve_admission.py: load-feedback routing ---------------------


def test_router_fresh_feedback_steers_to_shallow_queue():
    r = _mk_router()
    r._set.update_reports({
        _HEX_A: {"queue_depth": 0, "free_kv_pages": 10},
        _HEX_B: {"queue_depth": 50, "free_kv_pages": 10},
    })
    for _ in range(10):
        hex_id, _ = r.assign_replica(timeout_s=1)
        assert hex_id == _HEX_A  # P2C always sees both; A's score wins
        r.release(hex_id)


def test_router_kv_exhaustion_penalty():
    r = _mk_router()
    r._set.update_reports({
        _HEX_A: {"queue_depth": 0, "free_kv_pages": 0},
        _HEX_B: {"queue_depth": 2, "free_kv_pages": 64},
    })
    now = time.monotonic()
    a, b = r._set.entries
    assert r._score(a, now, 5.0) == (4.0, True)
    assert r._score(b, now, 5.0) == (2.0, True)
    hex_id, _ = r.assign_replica(timeout_s=1)
    assert hex_id == _HEX_B


def test_router_stale_feedback_falls_back_to_local_signal():
    r = _mk_router()
    r._set.update_reports({_HEX_B: {"queue_depth": 100}})
    r._set.reports[_HEX_B]["received_at"] -= 60.0  # age past staleness
    r._set.inflight[_HEX_A] = 5
    now = time.monotonic()
    b = r._set.entries[1]
    score, fresh = r._score(b, now, 5.0)
    assert (score, fresh) == (0.0, False)  # depth-100 report ignored
    hex_id, _ = r.assign_replica(timeout_s=1)
    assert hex_id == _HEX_B


def test_router_model_affinity_prefers_loaded_replica():
    r = _mk_router()
    r._set.update_reports({
        _HEX_A: {"queue_depth": 0, "models": []},
        _HEX_B: {"queue_depth": 3, "models": ["m1"]},
    })
    r._set.inflight[_HEX_B] = 3
    hex_id, _ = r.assign_replica(timeout_s=1, model_id="m1")
    assert hex_id == _HEX_B  # affinity beats the load gap
    r.release(hex_id)

    now = time.monotonic()
    b = r._set.entries[1]
    assert r._has_model(b, "m1", now, 5.0)
    r._set.reports[_HEX_B]["received_at"] -= 60.0
    assert not r._has_model(b, "m1", now, 5.0)


def test_router_staleness_knob(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SERVE_FEEDBACK_STALE_S", "2.5")
    assert trouter._stale_s() == 2.5
    monkeypatch.setenv("RAY_TPU_SERVE_FEEDBACK_STALE_S", "bogus")
    assert trouter._stale_s() == 5.0


# -- tests/test_serve_admission.py: the multiplex model cache ----------------


def test_model_cache_single_flight_concurrent_loads():
    loads = []

    def loader(mid):
        loads.append(mid)
        time.sleep(0.2)  # wide window for racers to pile in
        return {"id": mid}

    cache = tmultiplex._ModelCache(loader, capacity=2)
    out = []
    lock = threading.Lock()

    def hit():
        m = cache.get(None, "m1")
        with lock:
            out.append(m)

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(out) == 8
    assert cache.load_count == 1 and loads == ["m1"]
    assert all(m is out[0] for m in out)  # one object, shared


def test_model_cache_never_evicts_pinned_model():
    class Model:
        def __init__(self):
            self.unloaded = False

        def unload(self):
            self.unloaded = True

    cache = tmultiplex._ModelCache(lambda mid: Model(), capacity=1)
    m1 = cache.get(None, "m1")  # pinned by the get
    m2 = cache.get(None, "m2")  # over capacity, but m1 is in use
    assert set(cache.loaded_ids()) == {"m1", "m2"}  # overflow, no evict
    assert not m1.unloaded
    cache.unpin("m1")  # request finished -> deferred eviction runs
    assert cache.loaded_ids() == ["m2"]
    assert m1.unloaded and not m2.unloaded
    assert cache.pinned_ids() == ["m2"]


def test_model_cache_failed_load_retries_fresh():
    calls = {"n": 0}

    def loader(mid):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("flaky checkpoint")
        return mid.upper()

    cache = tmultiplex._ModelCache(loader, capacity=2)
    with pytest.raises(ValueError, match="flaky checkpoint"):
        cache.get(None, "m")
    assert cache.get(None, "m") == "M"  # no poisoned loading marker


# -- tests/test_serve_disagg.py: role pools, prefix locality ------------------


def test_router_phase_restricts_to_role_pool():
    r = _mk_router(_roles3())
    for _ in range(20):
        hex_id, _ = r.assign_replica(timeout_s=1, phase="prefill")
        assert hex_id in (_HEX_P, _HEX_M)  # never the decode replica
        r.release(hex_id)
        hex_id, _ = r.assign_replica(timeout_s=1, phase="decode")
        assert hex_id in (_HEX_D, _HEX_M)
        r.release(hex_id)


def test_router_empty_pool_degrades_to_mixed_routing():
    r = _mk_router([{"actor_hex": _HEX_D, "max_ongoing": 8,
                     "role": "decode"}])
    hex_id, _ = r.assign_replica(timeout_s=1, phase="prefill")
    assert hex_id == _HEX_D
    r.release(hex_id)


def test_router_strict_mode_waits_for_role_pool(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SERVE_ROLE_STRICT", "1")
    r = _mk_router([{"actor_hex": _HEX_D, "max_ongoing": 8,
                     "role": "decode"}])
    with pytest.raises(TimeoutError):
        r.assign_replica(timeout_s=0.3, phase="prefill")


def test_router_entries_without_role_behave_as_mixed():
    r = _mk_router([{"actor_hex": _HEX_M, "max_ongoing": 8}])
    for phase in ("", "prefill", "decode"):
        hex_id, _ = r.assign_replica(timeout_s=1, phase=phase)
        assert hex_id == _HEX_M
        r.release(hex_id)


def test_router_prefix_locality_steers_prefill():
    r = _mk_router(_roles3()[:2] + [
        {"actor_hex": _HEX_M, "max_ongoing": 8, "role": "prefill"}])
    hint = ["k1", "k2", "k3"]
    r._set.update_reports({
        _HEX_P: {"queue_depth": 2,
                 "prefix_digest": {"op": "serve_prefix_digest",
                                   "keys": ["k1", "k2"]}},
        _HEX_M: {"queue_depth": 0,
                 "prefix_digest": {"op": "serve_prefix_digest",
                                   "keys": ["zz"]}},
    })
    for _ in range(10):
        hex_id, _ = r.assign_replica(timeout_s=1, phase="prefill",
                                     prefix_keys=hint)
        assert hex_id == _HEX_P
        r.release(hex_id)
    # locality only biases PREFILL: decode ignores the hint
    hex_id, _ = r.assign_replica(timeout_s=1, phase="decode",
                                 prefix_keys=hint)
    assert hex_id in (_HEX_D,)
    r.release(hex_id)


def test_router_stale_digest_ignored():
    r = _mk_router(_roles3())
    r._set.update_reports({
        _HEX_P: {"prefix_digest": {"op": "serve_prefix_digest",
                                   "keys": ["k1"]}}})
    e = r._set.entries[0]
    now = time.monotonic()
    assert r._prefix_match(e, ["k1"], now, 5.0) == 1
    r._set.reports[_HEX_P]["received_at"] -= 60.0
    assert r._prefix_match(e, ["k1"], now, 5.0) == 0


def test_router_decode_free_kv_tiebreak():
    r = _mk_router(_roles3()[:2] + [
        {"actor_hex": _HEX_M, "max_ongoing": 8, "role": "decode"}])
    r._set.update_reports({
        _HEX_D: {"queue_depth": 0, "free_kv_pages": 2},
        _HEX_M: {"queue_depth": 0, "free_kv_pages": 500},
    })
    for _ in range(10):
        hex_id, _ = r.assign_replica(timeout_s=1, phase="decode")
        assert hex_id == _HEX_M
        r.release(hex_id)
    now = time.monotonic()
    d, m = r._set.entries[1], r._set.entries[2]
    assert r._score(d, now, 5.0) == (0.0, True)
    sd, _ = r._score(d, now, 5.0, "decode")
    sm, _ = r._score(m, now, 5.0, "decode")
    assert sm < sd < 0.5  # bonus magnitude stays sub-request


# -- the port against the JAX package ----------------------------------------


def _choices(mod, seed):
    """A fixed mix of requests over five replicas of three roles with
    load reports, prefix digests and models: the replica each request
    is sent to, with releases interleaved."""
    hexes = [c * 32 for c in "abcde"]
    roles = ["prefill", "decode", "mixed", "decode", "prefill"]
    entries = [{"actor_hex": h, "max_ongoing": 3, "role": role}
               for h, role in zip(hexes, roles)]
    r = _mk_router(entries, mod)
    r._set.update_reports({
        hexes[0]: {"queue_depth": 1, "free_kv_pages": 40,
                   "prefix_digest": {"op": "serve_prefix_digest",
                                     "keys": ["k1", "k2"]}},
        hexes[1]: {"queue_depth": 0, "free_kv_pages": 300,
                   "models": ["m1"]},
        hexes[2]: {"queue_depth": 2, "free_kv_pages": 0},
        hexes[3]: {"queue_depth": 1, "free_kv_pages": 128,
                   "models": ["m2"]},
        hexes[4]: {"queue_depth": 0, "free_kv_pages": 64,
                   "prefix_digest": {"op": "serve_prefix_digest",
                                     "keys": ["k1"]}},
    })
    rng = random.Random(seed)
    random.seed(seed)
    out, held = [], []
    for i in range(200):
        phase = rng.choice(["", "prefill", "decode"])
        model = rng.choice(["", "", "m1", "m2"])
        keys = rng.choice([None, ["k1"], ["k1", "k2", "k3"]])
        hex_id, _ = r.assign_replica(timeout_s=1, model_id=model,
                                     phase=phase, prefix_keys=keys)
        out.append(hex_id)
        held.append(hex_id)
        if len(held) > 4 or i % 3 == 0:
            r.release(held.pop(rng.randrange(len(held))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_choices_equal_the_reference(seed):
    """On the same entries, reports and seed, the port's Router sends
    every request of a mixed sequence to the replica the JAX package's
    Router picks."""
    want = _choices(jrouter, seed)
    got = _choices(trouter, seed)
    assert got == want
    assert len(set(want)) >= 4  # the sequence exercises most replicas
