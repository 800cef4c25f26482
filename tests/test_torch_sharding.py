"""The port's logical-axis sharding rules against the JAX package's, on
the CPU, in this process.

The cases of tests/test_parallel_mesh.py:37-69 (`spec_from_logical`
respects the mesh, a mesh axis used once, `shard_tree` places params,
`data_sharding` splits the batch), each against the JAX function on the
same inputs: specs equal entry for entry, and each rank's block equal
to the shard that JAX puts on the device at the rank's place in the
mesh (port meshes of 4 or 8 ranks are laid out in this process with
`build_mesh(devices=...)` and `Mesh(..., rank=r)`, no process group:
nothing here communicates).  Also `infer_logical_axes`, `tree_shardings`
and the model's `logical_axes` (tiny, MoE, scan_layers=False) against
the reference's trees; tests/test_7b_partition.py:31 on `meta` tensors
(Llama-2-7B widths under {fsdp: 8}, per-rank bytes of params and
moments under a quarter of the whole, each leaf's block the shape of
the reference's shard; nothing is allocated); the step's layouts on
tensor meshes (the compute layout without fsdp, gathers over chosen
axes) and `Mesh.get_group` over several axes; and the raises of what
the port does not place: expert and stage of more than one rank,
tensor with seq and fsdp with seq.  (`load_pytree(shardings=...)` is
held in tests/test_torch_sharded_restore.py.)
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsh
from ray_tpu.train import train_state as jts

PORT = "ray_tpu" "_torch"
pmesh = importlib.import_module(f"{PORT}.parallel.mesh")
psh = importlib.import_module(f"{PORT}.parallel.sharding")
ttf = importlib.import_module(f"{PORT}.models.transformer")
tts = importlib.import_module(f"{PORT}.train.train_state")


def _meshes(axes, n):
    """(the reference's mesh over n virtual devices, the port's mesh of
    n ranks as seen from each rank)."""
    jm = jmesh.build_mesh(axes=axes, devices=jax.devices()[:n])
    pm = pmesh.build_mesh(axes=axes, devices=list(range(n)))
    return jm, [pmesh.Mesh(pm.shape, pm.ranks, rank=r) for r in range(n)]


def _blocks_match(jarr, jm, layouts, whole):
    """Each port rank's block of `whole` equals the shard JAX placed on
    the device at that rank's place in the mesh."""
    devices = list(jm.devices.flat)
    for shard in jarr.addressable_shards:
        rank = devices.index(shard.device)
        got = layouts[rank].shard(whole)
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


# -- tests/test_parallel_mesh.py:37-69 ----------------------------------------


def test_spec_from_logical_respects_mesh():
    jm, pms = _meshes({"data": 2, "tensor": 4}, 8)
    logical = ("batch", "seq", "heads")
    spec = psh.spec_from_logical(logical, mesh=pms[0])
    assert tuple(spec) == tuple(jsh.spec_from_logical(logical, mesh=jm))
    assert tuple(spec) == tuple(P(("data", "fsdp"), "seq", "tensor"))


def test_mesh_axis_used_once():
    jm, pms = _meshes({"fsdp": 8}, 8)
    spec = psh.spec_from_logical(("embed", "embed"), mesh=pms[0])
    assert tuple(spec) == tuple(jsh.spec_from_logical(("embed", "embed"),
                                                      mesh=jm))
    assert tuple(spec) == ("fsdp", None)


def test_shard_tree_places_params():
    """The reference's case: wq placed on {fsdp: 4, tensor: 2}, split
    (rows over fsdp, columns over tensor); each port rank's block is the
    shard JAX puts on its device.  Then {fsdp: 4}, rows only."""
    rng = np.random.default_rng(0)
    params = {"wq": rng.standard_normal((64, 128)).astype(np.float32),
              "bias": rng.standard_normal((128,)).astype(np.float32)}
    whole = {k: torch.from_numpy(v) for k, v in params.items()}
    logical = psh.infer_logical_axes(whole)
    for axes, n, shape in (({"fsdp": 4, "tensor": 2}, 8, (16, 64)),
                           ({"fsdp": 4}, 4, (16, 128))):
        jm, pms = _meshes(axes, n)
        jout = jsh.shard_tree(jax.tree.map(jnp.asarray, params), jm)
        assert not jout["wq"].sharding.is_fully_replicated
        for pm in pms:
            out = psh.shard_tree(whole, pm)
            assert tuple(out["wq"].shape) == shape
            assert out["bias"] is whole["bias"]  # 1-d: replicated
        for name in params:
            layouts = [psh.named_sharding(pm, logical[name]) for pm in pms]
            assert tuple(layouts[0].spec) == tuple(jout[name].sharding.spec)
            assert layouts[0].is_fully_replicated == \
                jout[name].sharding.is_fully_replicated
            _blocks_match(jout[name], jm, layouts, whole[name])


def test_data_sharding_batch_axis():
    jm, pms = _meshes({"data": 4, "fsdp": 2}, 8)
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    y = jax.device_put(jnp.asarray(x), jsh.data_sharding(jm))
    assert {s.data.shape for s in y.addressable_shards} == {(1, 16)}
    layouts = [psh.data_sharding(pm) for pm in pms]
    assert tuple(layouts[0].spec) == tuple(jsh.data_sharding(jm).spec)
    assert {tuple(lay.shard(torch.from_numpy(x)).shape)
            for lay in layouts} == {(1, 16)}
    _blocks_match(y, jm, layouts, torch.from_numpy(x))


@pytest.mark.parametrize("axes,n", [({"data": 2}, 2), ({"fsdp": 2}, 2),
                                    ({"data": 2, "fsdp": 2}, 4)])
def test_data_and_replicated_specs_match_reference(axes, n):
    jm, pms = _meshes(axes, n)
    assert tuple(psh.data_sharding(pms[0]).spec) == \
        tuple(jsh.data_sharding(jm).spec)
    assert tuple(psh.replicated(pms[0]).spec) == \
        tuple(jsh.replicated(jm).spec)
    assert psh.replicated(pms[0]).is_fully_replicated


# -- trees: inferred axes, shardings, the model's logical axes ----------------


def _jparams(cfg):
    return jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.key(0)))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _as_plain(tree):
    """A logical tree (or sharding tree's specs) as nested dicts of
    tuples."""
    if isinstance(tree, dict):
        return {k: _as_plain(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("kw", [{}, {"num_experts": 4}])
def test_infer_logical_axes_matches_reference(kw):
    cfg = jtf.TransformerConfig.tiny(**kw)
    params = _jparams(cfg)
    params["extra"] = {"lm_head": np.zeros((8, 4), np.float32),
                       "misc": np.zeros((3, 5, 2), np.float32),
                       "tie": np.zeros((6, 6), np.float32),
                       "scalar": np.zeros((), np.float32)}
    want = jsh.infer_logical_axes(params)
    got = psh.infer_logical_axes(_torch_tree(params))
    assert _as_plain(got) == _as_plain(want)


@pytest.mark.parametrize("kw", [{}, {"num_experts": 4},
                                {"scan_layers": False}])
def test_logical_axes_match_reference(kw):
    jcfg = jtf.TransformerConfig.tiny(**kw)
    tcfg = ttf.TransformerConfig.tiny(**kw)
    assert ttf.logical_axes(tcfg) == jtf.logical_axes(jcfg)


@pytest.mark.parametrize("axes,n", [({"fsdp": 4}, 4),
                                    ({"data": 2, "fsdp": 4}, 8),
                                    ({"data": 2, "seq": 2}, 4),
                                    ({"fsdp": 4, "tensor": 2}, 8),
                                    ({"data": 2, "fsdp": 2, "tensor": 2}, 8)])
def test_tree_shardings_match_reference(axes, n):
    """The model's tree of layouts: specs equal to the reference's
    NamedShardings', and each rank's block of each tiny param the shard
    JAX places on its device."""
    cfg = jtf.TransformerConfig.tiny(hidden_size=64)
    jm, pms = _meshes(axes, n)
    logical = jtf.logical_axes(cfg)
    want = jsh.tree_shardings(jm, logical)
    got = [psh.tree_shardings(pm, ttf.logical_axes(
        ttf.TransformerConfig.tiny(hidden_size=64))) for pm in pms]
    assert _as_plain(jax.tree.map(lambda s: s.spec, want)) == \
        _as_plain(jax.tree.map(lambda s: s.spec, got[0],
                               is_leaf=lambda s: isinstance(
                                   s, psh.NamedSharding)))
    params = _jparams(cfg)
    placed = jax.device_put(jax.tree.map(jnp.asarray, params), want)
    for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
        keys = [p.key for p in path]
        layouts = []
        for g in got:
            node = g
            for k in keys:
                node = node[k]
            layouts.append(node)
        whole = params
        for k in keys:
            whole = whole[k]
        _blocks_match(leaf, jm, layouts, torch.from_numpy(whole))


# -- tests/test_7b_partition.py:31, on meta tensors ---------------------------


def test_7b_param_and_opt_state_split_under_fsdp8():
    """Llama-2-7B widths under {fsdp: 8}, the port's step from one
    rank's view: its blocks of the params and of Adam's moments (mu in
    bf16, as the reference's case) come to under a quarter of the whole,
    and each block has the shape of the reference's shard.  Meta tensors:
    shapes and dtypes only, nothing allocated."""
    config = ttf.TransformerConfig.llama2_7b()
    assert ttf.num_params(config) > 6.5e9
    mesh = pmesh.build_mesh(axes={"fsdp": 8}, devices=list(range(8)))
    ts = tts.ShardedTrainStep(
        config, mesh, device="cpu",
        optimizer=tts.default_optimizer(mu_dtype=torch.bfloat16))

    def meta(shapes):
        if isinstance(shapes, dict):
            return {k: meta(v) for k, v in shapes.items()}
        return torch.empty(shapes, dtype=config.param_dtype, device="meta")

    whole = meta(ttf.param_shapes(config))
    whole_opt = ts.optimizer.init(whole)
    blocks = ts.shard(whole)
    opt = ts.optimizer.init(blocks)
    assert all(t.device.type == "meta" for t in tts.optim.tree_leaves(blocks))

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in _tensor_leaves(tree))

    total = nbytes(whole) + nbytes(whole_opt)
    per_rank = nbytes(blocks) + nbytes(opt)
    gb = 1024 ** 3
    print(f"7B fsdp:8 - whole {total / gb:.1f} GiB, per rank "
          f"{per_rank / gb:.1f} GiB")
    assert per_rank < total / 4, (per_rank, total)

    # Each block has the shape of the reference's shard of that leaf.
    jcfg = jtf.TransformerConfig.llama2_7b()
    jm = jmesh.build_mesh(axes={"fsdp": 8}, devices=jax.devices()[:8])
    jstep = jts.ShardedTrainStep(jcfg, jm, optimizer=jts.default_optimizer(
        mu_dtype=jnp.bfloat16))
    shapes = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                    jax.random.key(0)))
    want = jax.tree.map(lambda sd, sh: sh.shard_shape(sd.shape), shapes,
                        jstep.param_shardings)
    got = jax.tree.map(lambda t: tuple(t.shape), blocks)
    assert _as_plain(got) == _as_plain(want)


def _tensor_leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)


# -- what this slice does not port --------------------------------------------


@pytest.mark.parametrize("axes,match", [
    ({"tensor": 2, "seq": 2}, "6b, tensor with seq"), ({"expert": 2}, "6d"),
    ({"stage": 2}, "6c")])
def test_later_axes_raise_naming_their_items(axes, match):
    """Placing a tree, a step, on a mesh with expert or stage of more
    than one rank, or with tensor and seq both, raises
    NotImplementedError naming its item."""
    mesh = pmesh.build_mesh(axes=axes,
                            devices=list(range(math.prod(axes.values()))))
    with pytest.raises(NotImplementedError, match=match):
        psh.shard_tree({"w": torch.zeros(4, 4)}, mesh)
    with pytest.raises(NotImplementedError, match=match):
        psh.data_sharding(mesh)
    with pytest.raises(NotImplementedError, match=match):
        tts.ShardedTrainStep(ttf.TransformerConfig.tiny(), mesh,
                             device="cpu")
    # A spec alone is no placement.
    assert tuple(psh.spec_from_logical(("heads",), mesh=mesh)) == \
        ("tensor",)


def test_fsdp_with_seq_raises():
    mesh = pmesh.build_mesh(axes={"fsdp": 2, "seq": 2},
                            devices=list(range(4)))
    with pytest.raises(NotImplementedError, match="6b, fsdp with seq"):
        tts.ShardedTrainStep(ttf.TransformerConfig.tiny(), mesh,
                             device="cpu")


def test_params_split_over_fsdp_only():
    """Rules that split a param over another axis than fsdp and tensor
    raise."""
    mesh = pmesh.build_mesh(axes={"data": 2}, devices=[0, 1])
    with pytest.raises(ValueError, match="fsdp and tensor only"):
        tts.ShardedTrainStep(ttf.TransformerConfig.tiny(), mesh,
                             device="cpu", rules=(("embed", "data"),))


def test_uneven_dim_raises():
    mesh = pmesh.build_mesh(axes={"fsdp": 4}, devices=list(range(4)))
    with pytest.raises(ValueError, match="does not split"):
        psh.NamedSharding(mesh, ("fsdp",)).shard(torch.zeros(6))


# -- the step's layouts on a tensor mesh --------------------------------------


def test_step_layouts_on_a_tensor_mesh():
    """On {fsdp: 2, tensor: 2} (4 ranks laid out in this process): each
    leaf's layout at rest is the rules' (heads, mlp and vocab over
    tensor, embed over fsdp), the compute layout is it without fsdp, and
    each rank's block at rest is the block at its fsdp coordinate of its
    compute block; gathering a dim split over (fsdp, tensor) over fsdp
    alone raises (no contiguous block)."""
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32)
    pm = pmesh.build_mesh(axes={"fsdp": 2, "tensor": 2},
                          devices=list(range(4)))
    whole = ttf.init_params(cfg, 0, device="cpu")
    logical = ttf.logical_axes(cfg)
    for r in range(4):
        mesh = pmesh.Mesh(pm.shape, pm.ranks, rank=r)
        f, t = divmod(r, 2)
        ts = tts.ShardedTrainStep(cfg, mesh, device="cpu")
        assert ts.sharded
        for path in (("tok_embed",), ("blocks", "wq"), ("blocks", "wo"),
                     ("blocks", "w_down"), ("blocks", "attn_norm")):
            rest, comp, axes, w = (ts.param_shardings, ts.compute_shardings,
                                   logical, whole)
            for k in path:
                rest, comp, axes, w = rest[k], comp[k], axes[k], w[k]
            assert tuple(comp.spec) == tuple(
                None if a == "fsdp" else a for a in rest.spec)
            block, cblock = rest.shard(w), comp.shard(w)
            for d, name in enumerate(axes):
                if name in ("heads", "mlp", "vocab"):
                    n = w.shape[d] // 2
                    assert torch.equal(cblock, w.narrow(d, t * n, n))
                if name == "embed":
                    n = cblock.shape[d] // 2
                    assert torch.equal(block, cblock.narrow(d, f * n, n))
            if "embed" not in axes:
                assert block is w and cblock is w
    mesh = pmesh.Mesh(pm.shape, pm.ranks, rank=0)
    with pytest.raises(ValueError, match="no contiguous block"):
        psh.NamedSharding(mesh, (("fsdp", "tensor"),)).gather(
            torch.zeros(2), ("fsdp",))
    assert mesh.get_group(("fsdp", "tensor")) is None  # no process group
    assert mesh.axes_but("tensor") == ("data", "stage", "fsdp", "seq",
                                       "expert")


@pytest.mark.parametrize("rules", [
    (("heads", "tensor"),),
    (("heads", "tensor"), ("mlp", "tensor")),
    (("embed", "tensor"), ("heads", "tensor"), ("mlp", "tensor"),
     ("vocab", "tensor"))], ids=["mlp_vocab_whole", "vocab_whole",
                                 "embed_over_tensor"])
def test_tensor_rules_must_split_heads_mlp_and_vocab(rules):
    """On {tensor: 2}, rules that leave a heads, mlp or vocab dim whole,
    or split another dim over tensor, raise when the step is made, and
    the model raises on the blocks they cut (it would sum a whole MLP
    twice, or take the log-sum-exp of two whole vocabularies)."""
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32)
    pm = pmesh.build_mesh(axes={"tensor": 2}, devices=[0, 1])
    with pytest.raises(ValueError, match="tensor-parallel model"):
        tts.ShardedTrainStep(cfg, pm, device="cpu", rules=rules)
    mesh = pmesh.Mesh(pm.shape, pm.ranks, rank=0)
    params = psh.shard_tree(ttf.init_params(cfg, 0, device="cpu"), mesh,
                            rules, ttf.logical_axes(cfg))
    with mesh, pytest.raises(ValueError, match="tensor-parallel model"):
        ttf.loss_fn(params, {"tokens": torch.zeros((2, 9),
                                                   dtype=torch.long)}, cfg)
