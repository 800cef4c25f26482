"""The port's sharded checkpoint restore, `load_pytree(shardings=...)`,
against `ShardedTrainStep.shard_state` of the whole tree and against the
JAX package's own sharded restore, on the CPU, in this process.

A train state after two steps of the reference (tests/
test_torch_train_checkpoint.py builds it the same way), carried across
with `state_from_numpy` and saved whole by the port's `save_pytree`, is
restored on every rank of {fsdp: 2}, {fsdp: 2, tensor: 2} and
{data: 2, fsdp: 2} (ranks laid out in this process with
`Mesh(..., rank=r)`, no process group: a restore is a local read), with
the layout tree `ShardedTrainStep.state_shardings` gives.  Held: every
leaf bit-equal to `shard_state(load_pytree(path))`, NamedTuple for
NamedTuple; each device's shard of the reference's `load_pytree(
shardings=...)` of the same state (its orbax save, restored onto
`jax.sharding.NamedSharding`s of the same specs on the 8 virtual
devices) equal to the port's block for the rank at that device's place
in the mesh; tensors.pt opened with `torch.load(mmap=True)` and each
block in a storage of its own bytes; and the error cases (a dim that
does not split, a layout tree whose structure differs, named by its
first differing key).  Continuity of a training run through a sharded
restore on two gloo ranks is held in tests/test_torch_sharded_train.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train import checkpoint as jck
from ray_tpu.train import train_state as jts

PORT = "ray_tpu" "_torch"
pmesh = importlib.import_module(f"{PORT}.parallel.mesh")
psh = importlib.import_module(f"{PORT}.parallel.sharding")
ttf = importlib.import_module(f"{PORT}.models.transformer")
tts = importlib.import_module(f"{PORT}.train.train_state")
tck = importlib.import_module(f"{PORT}.train.checkpoint")
toptim = importlib.import_module(f"{PORT}.train.optim")

MESHES = {"fsdp2": {"fsdp": 2}, "fsdp2_tensor2": {"fsdp": 2, "tensor": 2},
          "data2_fsdp2": {"data": 2, "fsdp": 2}}


def _jcfg():
    return jtf.TransformerConfig.tiny(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64,
        dtype=jnp.float32, fused_ce=True, use_flash=False)


def _tcfg(jcfg):
    import dataclasses

    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jtf.TransformerConfig)}
    kw["dtype"] = kw["param_dtype"] = torch.float32
    return ttf.TransformerConfig(**kw)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The reference's state after two steps (bf16 moments): saved by the
    reference (orbax) and, carried across, by the port."""
    jcfg = _jcfg()
    mesh = jmesh.build_mesh(axes={"fsdp": 1}, devices=jax.devices()[:1])
    jstep = jts.ShardedTrainStep(jcfg, mesh, optimizer=jts.default_optimizer(
        learning_rate=1e-2, warmup_steps=2, total_steps=6,
        mu_dtype=jnp.bfloat16, nu_dtype=jnp.bfloat16))
    jstate = jstep.init(jax.random.key(3))
    rng = np.random.default_rng(0)
    for _ in range(2):
        jstate, _ = jstep.step(jstate, {"tokens": jnp.asarray(
            rng.integers(0, 64, (2, 33)).astype(np.int32))})
    root = tmp_path_factory.mktemp("sharded_restore")
    tcfg = _tcfg(jcfg)
    state = tts.state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                 device="cpu")
    return dict(
        tcfg=tcfg, state=state,
        port=tck.save_pytree(state, str(root / "port"), step=2),
        ref=jck.save_pytree(jstate, str(root / "ref"), step=2))


def _ranks(axes):
    """(the port's mesh as seen from each rank, the reference's mesh over
    as many virtual devices)."""
    n = int(np.prod(list(axes.values())))
    pm = pmesh.build_mesh(axes=axes, devices=list(range(n)))
    jm = jmesh.build_mesh(axes=axes, devices=jax.devices()[:n])
    return [pmesh.Mesh(pm.shape, pm.ranks, rank=r) for r in range(n)], jm


def _tensors(tree):
    """{path: tensor} of every tensor and numpy leaf."""
    return tck.flatten_pytree(tree)[1]


def _assert_same(a, b):
    (sa, ta), (sb, tb) = tck.flatten_pytree(a), tck.flatten_pytree(b)
    assert sa == sb  # containers, NamedTuples by name, scalar leaves
    assert ta.keys() == tb.keys()
    for p, x in ta.items():
        y = tb[p]
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x, y), p


@pytest.mark.parametrize("name", list(MESHES))
def test_restore_equals_shard_state_of_the_whole(saved, name):
    """Every rank's restore equals shard_state of the whole tree, leaf for
    leaf and bit for bit, and holds less than the whole where anything
    splits."""
    meshes, _ = _ranks(MESHES[name])
    whole = tck.load_pytree(saved["port"])
    total = sum(t.nbytes for t in _tensors(whole).values())
    for mesh in meshes:
        step = tts.ShardedTrainStep(saved["tcfg"], mesh, device="cpu")
        back = tck.load_pytree(saved["port"],
                               shardings=step.state_shardings(whole))
        _assert_same(back, step.shard_state(whole))
        assert type(back["opt_state"][1][0]) is toptim.ScaleByAdamState
        held = sum(t.nbytes for t in _tensors(back).values())
        assert held < total * 0.6, (held, total)


def _saved_form(tree, leaf, path=""):
    """{path: leaf(x)} over a tree in the containers orbax restores
    without an item: NamedTuples as dicts of their fields, tuples as
    lists."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _saved_form(v, leaf, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_saved_form(v, leaf, f"{path}/{i}")
                for i, v in enumerate(tree)]
    return leaf(path, tree)


@pytest.mark.parametrize("name", list(MESHES))
def test_restore_equals_the_reference_shards(saved, name):
    """The reference restores its own save of the state onto NamedShardings
    of the specs the port's layout tree holds (replicated for the counts
    and the step); each device's shard equals the port's block for the
    rank at that device's place in the mesh."""
    meshes, jm = _ranks(MESHES[name])
    layouts = [tts.ShardedTrainStep(saved["tcfg"], m,
                                    device="cpu").state_shardings(
        saved["state"]) for m in meshes]
    jback = jck.load_pytree(saved["ref"], shardings=_saved_form(
        layouts[0], lambda _, s: JNamedSharding(
            jm, P(*(s.spec if s is not None else ())))))
    mine = []
    for lay in layouts:
        flat = {}
        _saved_form(tck.load_pytree(saved["port"], shardings=lay),
                    lambda p, x: flat.__setitem__(p, x))
        mine.append(flat)
    devices = list(jm.devices.flat)
    got = {"".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                   for k in path): arr
           for path, arr in jax.tree_util.tree_leaves_with_path(jback)}
    assert set(got) == {k for k, v in mine[0].items() if v is not None}
    split = 0
    for key, arr in got.items():
        split += not arr.sharding.is_fully_replicated
        for shard in arr.addressable_shards:
            block = mine[devices.index(shard.device)][key]
            ref = np.asarray(shard.data)
            if not isinstance(block, torch.Tensor):  # counts and the step
                assert block == int(ref), key
                continue
            assert tuple(block.shape) == ref.shape, key
            np.testing.assert_array_equal(
                block.float().numpy(), ref.astype(np.float32), err_msg=key)
    assert split > 0


def test_restore_reads_blocks_from_a_mapping(saved, monkeypatch):
    """torch.load opens tensors.pt (mmap=True, weights_only=True, on the
    CPU); each leaf's block is read through a mapping of that leaf's
    bytes alone, closed before the restore returns; every split block
    sits in a storage of its own bytes."""
    import mmap

    meshes, _ = _ranks({"fsdp": 2, "tensor": 2})
    whole = tck.load_pytree(saved["port"])
    load, calls, maps = torch.load, [], []

    def spy(*a, **kw):
        calls.append(kw)
        return load(*a, **kw)

    class Mapping(mmap.mmap):
        def __init__(self, *a, **kw):
            maps.append((self, len(self)))

    monkeypatch.setattr(torch, "load", spy)
    monkeypatch.setattr(tck.mmap, "mmap", Mapping)
    step = tts.ShardedTrainStep(saved["tcfg"], meshes[3], device="cpu")
    back = tck.load_pytree(saved["port"],
                           shardings=step.state_shardings(whole))
    assert calls == [dict(mmap=True, map_location="cpu", weights_only=True)]
    leaves = list(_tensors(whole).values())
    assert len(maps) == len(leaves) and all(m.closed for m, _ in maps)
    assert max(n for _, n in maps) == pytest.approx(
        max(t.nbytes for t in leaves), abs=mmap.ALLOCATIONGRANULARITY)
    for t in _tensors(back).values():
        assert t.is_contiguous()
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    wq = back["params"]["blocks"]["wq"]
    assert tuple(wq.shape) == (2, 16, 16)  # [L, embed / fsdp, heads / tensor]


def test_restore_error_cases(saved, tmp_path):
    """A dim that does not split raises shard_shape's ValueError; a layout
    tree whose structure differs from the checkpoint's raises ValueError
    naming the first key that differs; with target, NamedTuples take
    target's types; a zero-byte tensor saved first restores, and so do
    the blocks after it."""
    from typing import NamedTuple

    class Pair(NamedTuple):
        a: torch.Tensor
        b: int

    meshes, _ = _ranks({"fsdp": 4})
    mesh = meshes[1]
    lay = psh.NamedSharding(mesh, ("fsdp",))
    path = tck.save_pytree({"w": torch.arange(6.0), "p": Pair(
        torch.arange(8.0), 3), "l": [torch.ones(4)], "s": 5}, str(tmp_path))
    ok = {"w": None, "p": Pair(lay, None), "l": [lay], "s": None}
    with pytest.raises(ValueError, match="target"):
        tck.load_pytree(path, shardings=ok)  # Pair is no optimizer state
    back = tck.load_pytree(path, shardings=ok, target={
        "w": None, "p": Pair(None, None), "l": [None], "s": None})
    assert type(back["p"]) is Pair and back["s"] == 5 and back["p"].b == 3
    assert torch.equal(back["p"].a, torch.tensor([2.0, 3.0]))
    assert torch.equal(back["l"][0], torch.ones(1))
    assert torch.equal(back["w"], torch.arange(6.0))
    with pytest.raises(ValueError, match="does not split"):
        tck.load_pytree(path, shardings={**ok, "w": lay})
    # A zero-byte tensor saved first: its record holds no bytes to map.
    first = tck.save_pytree({"e": torch.zeros(0, 4), "x": torch.arange(8.0)},
                            str(tmp_path / "empty_first"))
    back = tck.load_pytree(first, shardings={"e": lay, "x": lay})
    assert tuple(back["e"].shape) == (0, 4)
    assert torch.equal(back["x"], torch.tensor([2.0, 3.0]))
    bad = [({k: v for k, v in ok.items() if k != "p"}, "'p'"),
           ({**ok, "x": None}, "'x'"),
           ({**ok, "p": (lay, None)}, "'p'"),
           ({**ok, "l": [lay, lay]}, "'l/1'"),
           ({**ok, "l": [None], "s": lay}, "'s'"),
           ({**ok, "w": "fsdp"}, "'w'")]
    for shardings, key in bad:
        with pytest.raises(ValueError, match=f"structure at {key}"):
            tck.load_pytree(path, shardings=shardings)
