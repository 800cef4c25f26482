"""The port's device_stats (util/device_stats.py) on the CPU.

Mirrors of tests/test_device_stats.py's module-level cases, with the
CUDA side faked where the reference fakes JAX's: the compile hook and
its kill switch, the HBM ledger over faked torch.cuda.memory_stats, the
roofline/MFU step hook and its overrides, the CPU fallbacks.  Beyond the
reference: the probe never initializes CUDA, the peak table is keyed on
torch's device name and leaves unknown cards at 0.0, and the call
signature never formats a tensor (a repr of a CUDA tensor copies it to
the host).
"""

import importlib
import logging

import numpy as np
import pytest
import torch

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
ds = importlib.import_module(f"{PORT}.util.device_stats")
tmetrics = importlib.import_module(f"{PORT}.util.metrics")
log_once = importlib.import_module(f"{PORT}.core.log_once")

GB = 1024 ** 3


@pytest.fixture(autouse=True)
def _fresh_device_state():
    ds.reset()
    ds.set_enabled(True)
    yield
    ds.reset()
    ds.set_enabled(True)


def _fake_card(monkeypatch, name="NVIDIA H100 80GB HBM3", stats=None,
               total=80 * GB):
    """torch.cuda as an initialized card named `name` whose allocator
    reports `stats`."""
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cuda, "get_device_name", lambda device=None: name)
    monkeypatch.setattr(cuda, "memory_stats",
                        lambda device=None: dict(stats or {}))

    class Props:
        total_memory = total

    monkeypatch.setattr(cuda, "get_device_properties",
                        lambda device=None: Props())


def _snap(name):
    return next(s for s in tmetrics.local_snapshots() if s["name"] == name)


# ---------------------------------------------------------------------------
# Backend probe and CPU fallback
# ---------------------------------------------------------------------------

def test_device_sample_null_on_cpu():
    """test_device_stats.py test_device_sample_null_on_cpu: no card, no
    device fields, and the ledger keeps its full shape."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert not ds.has_accelerator()
    assert ds.device_sample() is None
    fields = ds.profile_fields()
    assert "device" in fields and fields["device"] is None
    led = ds.ledger()
    assert led["backend"] == "unloaded"
    for key in ("capacity_bytes", "used_bytes", "watermark_fraction",
                "components", "workspace_bytes"):
        assert key in led, led
    # A forced probe on a host without a card reads as the reference's
    # CPU host does.
    assert ds.ledger(probe=True)["backend"] == "cpu"
    assert ds.memory_stats() is None


def test_probe_does_not_initialize_cuda():
    """backend_info, memory_stats, ledger, device_sample and note_step
    never create a CUDA context on a process's behalf."""
    if torch.cuda.is_initialized():
        pytest.skip("CUDA already initialized in this process")
    assert ds.backend_info() == {"backend": "unloaded", "device_kind": "",
                                 "num_devices": 0}
    ds.ledger()
    ds.device_sample()
    ds.profile_fields()
    ds.note_step(tokens_per_s=1.0, bytes_per_token=1.0, flops_per_token=1.0)
    assert ds.memory_stats() is None
    assert not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# Compile-event hook
# ---------------------------------------------------------------------------

def test_compile_hook_counts_shape_churn(monkeypatch):
    """test_device_stats.py test_compile_hook_counts_shape_churn: first
    calls per signature count, repeats do not."""
    monkeypatch.setattr(ds, "_warmup", 1)

    def double(x):
        return x * 2

    double.marker = "forwarded"
    f = ds.count_compiles(double, "churn_local")
    for n in (2, 3, 4, 2):  # three distinct shapes, one repeat
        f(torch.ones(n))
    tbl = ds.compile_counts()["churn_local"]
    assert tbl["count"] == 3
    assert tbl["after_warmup"] == 2  # warmup allowance of 1
    assert tbl["last_wall_s"] >= 0.0
    assert tbl["last_shapes"] == [[[4], "torch.float32"]]
    assert ds.recompiles_after_warmup() == {"churn_local": 2}
    snap = _snap("ray_tpu_recompiles_total")
    assert snap["series"][(("function", "churn_local"),)] >= 2.0
    # The wrapper is transparent.
    assert f.__wrapped__ is double and f.marker == "forwarded"


def test_compile_hook_disabled_is_passthrough():
    f = ds.count_compiles(lambda x: x + 1, "disabled_fn")
    ds.set_enabled(False)
    assert torch.equal(f(torch.ones(3)), torch.full((3,), 2.0))
    assert "disabled_fn" not in ds.compile_counts()


class _NoRepr(torch.Tensor):
    """A tensor whose repr raises: formatting a CUDA tensor's values
    copies it to the host, so the signature must never do it."""

    def __repr__(self):
        raise AssertionError("repr of a tensor in a call signature")

    __str__ = __repr__


def test_signature_never_formats_a_tensor():
    """The signature reads shapes, dtypes, container lengths and plain
    numbers: a dict of tensors (the params, the cache) costs nothing,
    and an int argument (a step count) is part of the key."""
    seen = []
    f = ds.count_compiles(lambda *a, **k: seen.append(1), "sig_fn")

    def t(*shape):
        return torch.zeros(shape).as_subclass(_NoRepr)

    params = {"w": t(4, 4), "b": t(4)}
    cache = {"k": t(2, 3), "v": t(2, 3)}
    f(params, t(2, 8), cache, 16, seg_len=32)
    f(params, t(2, 8), cache, 16, seg_len=32)
    f(params, t(2, 8), cache, 8, seg_len=32)
    f(params, t(4, 8), cache, 8, seg_len=32)
    f(params, t(4, 8), cache, 8, seg_len=64)
    assert len(seen) == 5
    assert ds.compile_counts()["sig_fn"]["count"] == 4


# ---------------------------------------------------------------------------
# HBM ledger
# ---------------------------------------------------------------------------

def test_hbm_ledger_with_fake_memory_stats(monkeypatch):
    """test_device_stats.py test_hbm_ledger_with_fake_memory_stats, the
    allocator's counters faked: the reference's keys are read from
    allocated_bytes.all.{current,peak} and the card's total memory."""
    stats = {"allocated_bytes.all.current": 9 * GB,
             "allocated_bytes.all.peak": 12 * GB,
             "reserved_bytes.all.current": 10 * GB}
    _fake_card(monkeypatch, stats=stats, total=16 * GB)
    assert ds.memory_stats() == {"bytes_in_use": 9 * GB,
                                 "peak_bytes_in_use": 12 * GB,
                                 "bytes_limit": 16 * GB}
    ds.attribute("weights", 6 * GB)
    ds.attribute("kv_pages", 2 * GB)
    led = ds.ledger()
    assert led["backend"] == "cuda"
    assert led["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert led["capacity_bytes"] == 16 * GB
    assert led["used_bytes"] == 9 * GB
    assert led["components"] == {"weights": 6 * GB, "kv_pages": 2 * GB}
    assert led["workspace_bytes"] == 1 * GB
    assert led["watermark_bytes"] == 12 * GB
    assert led["watermark_fraction"] == pytest.approx(0.75)
    # High-watermark: a later, lower peak never lowers it.
    stats["allocated_bytes.all.peak"] = 8 * GB
    led2 = ds.ledger()
    assert led2["watermark_bytes"] == 12 * GB
    assert led2["watermark_fraction"] == pytest.approx(0.75)
    samp = ds.device_sample()
    assert samp is not None
    assert samp["watermark_fraction"] == pytest.approx(0.75)
    assert samp["components"]["weights"] == 6 * GB
    assert ds.profile_fields()["hbm_watermark_fraction"] == \
        pytest.approx(0.75)
    snap = _snap("ray_tpu_device_hbm_watermark_fraction")
    assert snap["series"][()] == pytest.approx(0.75)


# ---------------------------------------------------------------------------
# Roofline / MFU step hook and the peak table
# ---------------------------------------------------------------------------

def test_note_step_gauges_and_overrides(monkeypatch):
    """test_device_stats.py test_note_step_gauges_and_overrides."""
    monkeypatch.setenv("RAY_TPU_DEVICE_HBM_GBPS", "100")
    monkeypatch.setenv("RAY_TPU_DEVICE_PEAK_TFLOPS", "1")
    frac, mfu = ds.note_step(tokens_per_s=1000.0, bytes_per_token=1e7,
                             flops_per_token=1e8, plane="serve")
    assert frac == pytest.approx(0.1)   # 1e10 B/s over 1e11 B/s
    assert mfu == pytest.approx(0.1)    # 1e11 F/s over 1e12 F/s
    ls = ds.last_step()
    assert ls["plane"] == "serve"
    assert ls["roofline_fraction"] == pytest.approx(0.1)
    fields = ds.profile_fields()
    assert fields["roofline_fraction"] == pytest.approx(0.1)
    assert fields["mfu"] == pytest.approx(0.1)
    assert fields["tokens_per_s"] == pytest.approx(1000.0)
    for name in ("ray_tpu_device_roofline_fraction", "ray_tpu_device_mfu"):
        assert _snap(name)["series"], name
    ds.set_enabled(False)
    assert ds.note_step(tokens_per_s=1.0, bytes_per_token=1.0,
                        flops_per_token=1.0) == (0.0, 0.0)


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (3.35e12, 989e12)),
    ("NVIDIA H100 PCIe", (2.0e12, 756e12)),
    ("NVIDIA H200", (4.8e12, 989e12)),
    ("NVIDIA A100-SXM4-80GB", (0.0, 0.0)),
])
def test_peak_table_by_device_name(monkeypatch, caplog, name, peaks):
    """The card's peaks come from its name, longest key first; a card
    the table does not know gets no made-up peak: note_step returns 0.0
    and warns."""
    _fake_card(monkeypatch, name=name)
    monkeypatch.delenv("RAY_TPU_DEVICE_HBM_GBPS", raising=False)
    monkeypatch.delenv("RAY_TPU_DEVICE_PEAK_TFLOPS", raising=False)
    assert ds.peak_specs() == peaks
    log_once.reset()
    with caplog.at_level(logging.WARNING, logger=ds.logger.name):
        frac, mfu = ds.note_step(tokens_per_s=100.0, bytes_per_token=1e10,
                                 flops_per_token=1e12)
    if peaks[0]:
        assert frac == pytest.approx(1e12 / peaks[0])
        assert mfu == pytest.approx(1e14 / peaks[1])
        assert not caplog.records
    else:
        assert (frac, mfu) == (0.0, 0.0)
        assert "no peak rates known" in caplog.text
        # The override names an unknown card's rates.
        monkeypatch.setenv("RAY_TPU_DEVICE_HBM_GBPS", "2000")
        monkeypatch.setenv("RAY_TPU_DEVICE_PEAK_TFLOPS", "312")
        assert ds.peak_specs() == (2e12, 312e12)


def test_profile_fields_carry_recompiles(monkeypatch):
    monkeypatch.setattr(ds, "_warmup", 0)
    ds.note_compile("decode_graph.decode_multi_step", 0.5, [[16, 8], 16])
    fields = ds.profile_fields()
    assert fields["recompiles"] == {"decode_graph.decode_multi_step": 1}
    ent = ds.compile_counts()["decode_graph.decode_multi_step"]
    assert ent["total_wall_s"] == pytest.approx(0.5)
    assert np.isfinite(ent["first_ts"])
