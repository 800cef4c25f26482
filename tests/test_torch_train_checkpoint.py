"""The port's train checkpoints against the JAX package's, on the CPU.

`StorageContext` lays out a run's checkpoints as the reference's does
(directory names, `.metadata.json` keys, numbering, `num_to_keep`);
`save_pytree` names its step directory `step_<n>` as the reference's;
a train state saved and loaded by the reference (orbax) and carried
over with `state_from_numpy` equals the port's own torch round trip of
that state; `save_pytree_async` snapshots every tensor before it
returns and re-raises its writer's error; `load_pytree` reads tensors
only (`torch.load(weights_only=True)`), refusing a pickled object
without running it.  No cluster.
"""

import importlib
import json
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel.mesh import build_mesh
from ray_tpu.train import checkpoint as jck
from ray_tpu.train import train_state as jts

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
tck = importlib.import_module(f"{PORT}.train.checkpoint")
tts = importlib.import_module(f"{PORT}.train.train_state")
ttf = importlib.import_module(f"{PORT}.models.transformer")
toptim = importlib.import_module(f"{PORT}.train.optim")


def _layout(root):
    out = {}
    for d in sorted(os.listdir(root)):
        meta = os.path.join(root, d, ".metadata.json")
        keys = sorted(json.load(open(meta))) if os.path.exists(meta) else None
        out[d] = (sorted(os.listdir(os.path.join(root, d))), keys)
    return out


@pytest.mark.parametrize("num_to_keep", [None, 2])
def test_storage_context_layout_matches_reference(tmp_path, num_to_keep):
    """The same persist sequence, a restart (a new context on the same
    run) and more persists give the same directories, files and metadata
    keys in both packages."""
    src = tmp_path / "local"
    src.mkdir()
    (src / "s.txt").write_text("x")
    layouts = []
    for pkg, mod in (("ref", jck), ("port", tck)):
        root = tmp_path / pkg
        s = mod.StorageContext(str(root), "run", num_to_keep=num_to_keep)
        paths = [s.persist_checkpoint(str(src), {"step": i}).path
                 for i in range(3)]
        s = mod.StorageContext(str(root), "run", num_to_keep=num_to_keep)
        paths += [s.persist_checkpoint(str(src), None).path]
        latest = s.latest_checkpoint()
        layouts.append((_layout(str(root / "run")),
                        [os.path.relpath(p, str(root)) for p in paths],
                        os.path.relpath(latest.path, str(root)),
                        latest.get_metadata()))
    assert layouts[0] == layouts[1]
    kept = layouts[1][0]
    assert len(kept) == (num_to_keep or 4)
    assert sorted(kept)[-1] == "checkpoint_000003"


def test_storage_context_paths_are_the_ports_own(monkeypatch, tmp_path):
    """The default storage path and run name: the port's own directory
    under the temp dir, never the reference's results directory."""
    monkeypatch.setattr(tck.tempfile, "tempdir", str(tmp_path))
    s = tck.StorageContext(None, None)
    assert s.storage_path == os.path.join(str(tmp_path), PORT, "results")
    assert s.name.startswith("run_") and s.name[4:].isdigit()
    ref = jck.StorageContext(None, s.name)
    assert ref.storage_path == os.path.join(str(tmp_path),
                                            "ray_tpu" "_results")
    assert ref.run_dir != s.run_dir


def test_save_pytree_step_naming_matches_reference(tmp_path):
    jpath = jck.save_pytree({"w": jnp.arange(4.0)}, str(tmp_path / "j"),
                            step=3)
    tpath = tck.save_pytree({"w": torch.arange(4.0)}, str(tmp_path / "t"),
                            step=3)
    assert os.path.basename(jpath) == os.path.basename(tpath) == "step_3"
    assert sorted(os.listdir(tpath)) == [tck.TENSORS, tck.STRUCTURE]
    assert tck.save_pytree({"w": torch.zeros(1)}, str(tmp_path / "n")) \
        == os.path.abspath(str(tmp_path / "n"))


def _tiny_jax():
    return jtf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64,
        dtype=jnp.float32, fused_ce=True, use_flash=False)


def _port_config(jcfg):
    import dataclasses

    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jtf.TransformerConfig)}
    kw["dtype"] = torch.float32
    kw["param_dtype"] = torch.float32
    return ttf.TransformerConfig(**kw)


def _leaves(tree, path=""):
    """(path, value) of every leaf, NamedTuples by type name."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    if isinstance(tree, tuple):
        return [(path, type(tree).__name__)] + [
            x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, p
            assert torch.equal(x, y), p
        else:
            assert x == y, p


@pytest.mark.parametrize("lean", [False, True])
def test_reference_checkpoint_equals_port_round_trip(tmp_path, lean):
    """A train state after two steps (Adam and schedule counts 2; bf16
    moments when lean), saved and loaded by the reference's orbax
    functions and carried over with state_from_numpy, equals the port's
    save_pytree / load_pytree round trip of that state, bit for bit and
    NamedTuple for NamedTuple."""
    jcfg = _tiny_jax()
    mesh = build_mesh(axes={"fsdp": 1}, devices=jax.devices()[:1])
    kw = dict(mu_dtype=jnp.bfloat16, nu_dtype=jnp.bfloat16) if lean else {}
    jstep = jts.ShardedTrainStep(jcfg, mesh, optimizer=jts.default_optimizer(
        learning_rate=1e-2, warmup_steps=2, total_steps=6, **kw))
    jstate = jstep.init(jax.random.key(3))
    rng = np.random.default_rng(0)
    for _ in range(2):
        jstate, _ = jstep.step(jstate, {"tokens": jnp.asarray(
            rng.integers(0, 64, (2, 33)).astype(np.int32))})
    tcfg = _port_config(jcfg)
    jpath = jck.save_pytree(jstate, str(tmp_path / "ref"), step=2)
    jback = jck.load_pytree(jpath, target=jstate)
    via_ref = tts.state_from_numpy(jax.tree.map(np.asarray, jback), tcfg,
                                   device="cpu")
    state = tts.state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                 device="cpu")
    assert via_ref["step"] == state["step"] == 2
    tpath = tck.save_pytree(state, str(tmp_path / "port"), step=2)
    back = tck.load_pytree(tpath)
    _assert_same_state(back, via_ref)
    _assert_same_state(tck.load_pytree(tpath, target=state), via_ref)
    adam = back["opt_state"][1][0]
    assert type(adam) is toptim.ScaleByAdamState and adam.count == 2
    assert adam.mu["tok_embed"].dtype == (
        torch.bfloat16 if lean else torch.float32)


def test_save_pytree_async_snapshots_before_returning(tmp_path):
    """Tensors changed in place after the call (CPU tensors, a view, a
    nested NamedTuple) do not reach the file."""
    big = torch.arange(12.0).reshape(3, 4)
    tree = {"w": torch.ones(256, 256), "view": big[1],
            "opt": toptim.ScaleByAdamState(5, {"m": torch.zeros(3)},
                                           {"v": torch.full((3,), 2.0)}),
            "step": 7}
    want = {"w": tree["w"].clone(), "view": big[1].clone()}
    h = tck.save_pytree_async(tree, str(tmp_path), step=7)
    tree["w"].add_(1.0)
    big.zero_()
    tree["opt"].mu["m"].fill_(9.0)
    path = h.wait()
    assert h.durable_at is not None and h.wait() == path
    back = tck.load_pytree(path)
    assert torch.equal(back["w"], want["w"])
    assert torch.equal(back["view"], want["view"])
    assert back["view"].untyped_storage().nbytes() == 4 * 4  # the row only
    assert torch.equal(back["opt"].mu["m"], torch.zeros(3))
    assert back["opt"].count == 5 and back["step"] == 7


def test_save_pytree_async_wait_reraises_writer_error(tmp_path, monkeypatch):
    def broken(obj, f, *a, **kw):
        raise OSError("disk full")

    h_ok = tck.save_pytree_async({"a": torch.zeros(2)}, str(tmp_path / "ok"))
    h_ok.wait()
    monkeypatch.setattr(torch, "save", broken)
    h = tck.save_pytree_async({"a": torch.zeros(2)}, str(tmp_path), step=1)
    with pytest.raises(OSError, match="disk full"):
        h.wait()
    with pytest.raises(OSError, match="disk full"):
        h.wait()
    assert not os.path.exists(h.path)  # nothing half-written in place


def test_save_refuses_existing_without_force(tmp_path):
    tck.save_pytree({"a": torch.zeros(1)}, str(tmp_path), step=1)
    with pytest.raises(FileExistsError):
        tck.save_pytree({"a": torch.ones(1)}, str(tmp_path), step=1,
                        force=False)
    with pytest.raises(FileExistsError):
        tck.save_pytree_async({"a": torch.ones(1)}, str(tmp_path), step=1,
                              force=False)
    tck.save_pytree({"a": torch.ones(1)}, str(tmp_path), step=1)
    assert torch.equal(tck.load_pytree(str(tmp_path / "step_1"))["a"],
                       torch.ones(1))


class _Payload:
    """Unpickling this would create a directory: a stand-in for code a
    checkpoint must never run."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (os.mkdir, (self.marker,))


def test_load_pytree_refuses_pickled_objects(tmp_path):
    path = tck.save_pytree({"w": torch.ones(2)}, str(tmp_path / "ck"))
    marker = str(tmp_path / "ran")
    torch.save({"w": torch.ones(2), "x": _Payload(marker)},
               os.path.join(path, tck.TENSORS))
    with pytest.raises(pickle.UnpicklingError):
        tck.load_pytree(path)
    assert not os.path.exists(marker)


def test_load_pytree_structure_and_shardings(tmp_path):
    from typing import NamedTuple

    class Custom(NamedTuple):
        a: torch.Tensor

    path = tck.save_pytree({"c": Custom(torch.ones(1)), "n": None,
                            "x": np.arange(3), "f": np.float32(1.5)},
                           str(tmp_path))
    with pytest.raises(ValueError, match="Custom"):
        tck.load_pytree(path)  # no target: only the optimizer states
    back = tck.load_pytree(path, target={"c": Custom(torch.zeros(1)),
                                         "n": None, "x": None, "f": None})
    assert type(back["c"]) is Custom and back["n"] is None
    np.testing.assert_array_equal(back["x"], np.arange(3))
    assert back["f"] == np.float32(1.5) and back["f"].dtype == np.float32
    with pytest.raises(ValueError, match="structure"):
        tck.load_pytree(path, target={"c": Custom(torch.zeros(1))})
    with pytest.raises(ValueError, match="structure at 'n'"):
        tck.load_pytree(path, shardings={"c": Custom(None)})
    with pytest.raises(TypeError, match="keys"):
        tck.save_pytree({"a/b": torch.zeros(1)}, str(tmp_path / "bad"))


def test_async_checkpoint_overlaps_and_roundtrips(tmp_path):
    """tests/test_train_jaxtrainer.py's case on the port: the call
    returns before the write is durable, wait() makes it durable, and the
    restore matches."""
    tree = {"w": torch.arange(1_000_000, dtype=torch.float32).reshape(
        1000, 1000), "step": torch.tensor(3)}
    tck.save_pytree_async(tree, str(tmp_path / "warm")).wait()

    t0 = time.perf_counter()
    h = tck.save_pytree_async(tree, str(tmp_path / "ck"), step=3)
    submit_s = time.perf_counter() - t0
    path = h.wait()
    total_s = time.perf_counter() - t0
    if total_s > 0.25:
        assert submit_s < total_s / 2, (submit_s, total_s)
    back = tck.load_pytree(path)
    np.testing.assert_array_equal(back["w"].numpy(), tree["w"].numpy())
    assert int(back["step"]) == 3
