"""The port's meshes against the JAX package's, on the CPU.

`MeshConfig` sizes, aliases and bad shapes mirror
tests/test_parallel_mesh.py; the hybrid DCN layouts of the port (rank
numbers) equal the reference's (device ids of the 8 virtual CPU
devices) for the same config.  A process without a process group is a
mesh with every axis 1.  Four gloo ranks in TorchTrainer workers build
a {data: 2, seq: 2} mesh: each axis's process group holds the ranks the
layout says, and a shift along `seq` reaches the ring's next rank.

One cluster for the file (num_cpus=4, num_gpus=0), one fit; the pytest
process never joins a process group.  Loops are defined inside the
tests and name the port through `PORT`.
"""

import importlib

import numpy as np
import pytest
from torch_ranks import PORT, fit_ranks

from ray_tpu.parallel import mesh as jmesh

rt = importlib.import_module(PORT)
pmesh = importlib.import_module(f"{PORT}.parallel.mesh")


@pytest.fixture(scope="module")
def cluster():
    drv = rt.init(num_cpus=4, num_gpus=0, log_to_driver=False)
    try:
        yield drv
    finally:
        rt.shutdown()


# -- tests/test_parallel_mesh.py:14-35 ---------------------------------------


def test_build_mesh_wildcard():
    m = pmesh.build_mesh(axes={"data": -1}, devices=list(range(8)))
    assert m.shape["data"] == 8
    assert m.shape["tensor"] == 1


def test_build_mesh_explicit():
    m = pmesh.build_mesh(axes={"dp": 2, "tp": 4}, devices=list(range(8)))
    assert m.shape["data"] == 2 and m.shape["tensor"] == 4


def test_mesh_bad_shape_raises():
    with pytest.raises(ValueError):
        pmesh.build_mesh(axes={"data": 3, "tensor": 3},
                         devices=list(range(8)))
    with pytest.raises(ValueError):
        pmesh.MeshConfig.from_dict({"data": -1, "seq": -1}).sizes(8)


def test_axis_aliases():
    assert pmesh.canonical_axis("sp") == "seq"
    assert pmesh.canonical_axis("zero") == "fsdp"
    with pytest.raises(ValueError):
        pmesh.canonical_axis("bogus")
    assert pmesh._AXIS_ALIASES == jmesh._AXIS_ALIASES
    assert pmesh.AXIS_ORDER == jmesh.AXIS_ORDER


@pytest.mark.parametrize("axes,n", [
    ({"data": -1}, 8), ({"seq": 2}, 8), ({"fsdp": -1, "tensor": 2}, 8),
    ({"cp": 4, "dp": 2}, 8), ({"pp": 2, "ep": 2}, 8)])
def test_mesh_config_sizes_match_reference(axes, n):
    assert pmesh.MeshConfig.from_dict(axes).sizes(n) == \
        jmesh.MeshConfig.from_dict(axes).sizes(n)


# -- tests/test_parallel_mesh.py:71-110: the hybrid DCN layouts -------------


@pytest.mark.parametrize("axes,dcn", [
    ({"data": 2, "fsdp": 4}, ("data",)),
    ({"data": 2, "seq": 2, "tensor": 2}, ("data",)),
    ({"fsdp": 2, "seq": 4}, ("fsdp",)),
    ({"data": 2, "fsdp": 2, "seq": 2}, ("data", "fsdp")),
])
def test_hybrid_layout_equals_reference(axes, dcn):
    n_slices = int(np.prod([axes[a] for a in dcn]))
    ref = jmesh.build_mesh(axes=axes, dcn_axes=dcn, n_slices=n_slices)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    got = pmesh.build_mesh(axes=axes, dcn_axes=dcn, n_slices=n_slices,
                           devices=list(range(8)))
    np.testing.assert_array_equal(got.ranks, ids)
    assert got.shape == dict(zip(ref.axis_names, ref.devices.shape))
    # slice_ids (a host per rank) give the same layout as n_slices
    per = 8 // n_slices
    by_host = pmesh.build_mesh(axes=axes, dcn_axes=dcn,
                               slice_ids=[r // per for r in range(8)],
                               devices=list(range(8)))
    np.testing.assert_array_equal(by_host.ranks, ids)


def test_hybrid_mesh_virtual_slices_groups():
    """tests/test_parallel_mesh.py::test_hybrid_dcn_mesh_virtual_slices:
    each dcn coordinate addresses one slice group."""
    m = pmesh.build_mesh(axes={"data": 2, "fsdp": 4}, dcn_axes=("data",),
                         n_slices=2, devices=list(range(8)))
    assert set(m.ranks[0].flatten()) == {0, 1, 2, 3}
    assert set(m.ranks[1].flatten()) == {4, 5, 6, 7}


def test_hybrid_mesh_shape_errors():
    for kw in (dict(axes={"data": 4, "fsdp": 2}, dcn_axes=("data",),
                    n_slices=2),):
        with pytest.raises(ValueError):
            jmesh.build_mesh(**kw)
        with pytest.raises(ValueError):
            pmesh.build_mesh(devices=list(range(8)), **kw)


def test_one_process_mesh():
    """No process group: every axis 1, no groups, this process rank 0;
    `with mesh:` makes it the ambient mesh, nested meshes stack."""
    m = pmesh.build_mesh()
    assert m.shape == {a: 1 for a in pmesh.AXIS_ORDER}
    assert m.size == 1 and m.device_mesh is None
    assert m.get_group() is None and m.get_group("seq") is None
    assert m.axis_index("seq") == 0 and m.axis_ranks("data") == [0]
    assert pmesh.current_mesh() is None
    inner = pmesh.one_process_mesh({"fsdp": 1})
    with m:
        assert pmesh.current_mesh() is m
        with inner:
            assert pmesh.current_mesh() is inner
        assert pmesh.current_mesh() is m
    assert pmesh.current_mesh() is None
    assert pmesh.local_mesh_info(m)["n_devices"] == 1
    with pytest.raises(ValueError):
        pmesh.one_process_mesh({"data": 2})
    assert pmesh.single_axis_mesh("seq").shape["seq"] == 1


def test_four_rank_mesh_groups_hold_the_layouts_ranks(cluster, tmp_path):
    port = PORT

    def loop(config):
        import os
        import pickle

        import torch
        import torch.distributed as dist

        mesh_mod = importlib.import_module(f"{port}.parallel.mesh")
        comm = importlib.import_module(f"{port}.parallel.comm")
        torch.set_num_threads(1)
        mesh = mesh_mod.build_mesh(axes={"data": 2, "seq": 2})
        rank = dist.get_rank()
        seq = mesh.axis_ranks("seq")
        me = mesh.axis_index("seq")
        got = comm.shift((torch.full((3,), float(rank)),),
                         seq[(me + 1) % 2], seq[(me - 1) % 2],
                         mesh.get_group("seq"))[0]
        out = {
            "rank": rank, "ranks": mesh.ranks.copy(), "shape": mesh.shape,
            "coord": {a: mesh.axis_index(a) for a in mesh.axis_names},
            "seq": seq, "data": mesh.axis_ranks("data"),
            "seq_group": dist.get_process_group_ranks(mesh.get_group("seq")),
            "data_group": dist.get_process_group_ranks(
                mesh.get_group("data")),
            "shifted": got.tolist(),
            "dm_names": tuple(mesh.device_mesh.mesh_dim_names),
        }
        with open(os.path.join(config["out"], f"rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)

    res = fit_ranks(loop, 4, tmp_path / "mesh4")
    layout = np.arange(4).reshape(2, 1, 1, 2, 1, 1)
    for r, out in enumerate(res):
        assert out["rank"] == r
        np.testing.assert_array_equal(out["ranks"], layout)
        assert out["shape"] == {"data": 2, "stage": 1, "fsdp": 1, "seq": 2,
                                "tensor": 1, "expert": 1}
        d, s = divmod(r, 2)
        assert out["coord"] == {"data": d, "stage": 0, "fsdp": 0, "seq": s,
                                "tensor": 0, "expert": 0}
        assert out["seq"] == [2 * d, 2 * d + 1] == sorted(out["seq_group"])
        assert out["data"] == [s, s + 2] == sorted(out["data_group"])
        assert out["shifted"] == [float(2 * d + 1 - s)] * 3
        assert out["dm_names"] == pmesh.AXIS_ORDER
