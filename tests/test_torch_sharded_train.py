"""The port's ShardedTrainStep on data and seq ranks against the JAX
package's, on the CPU.

The reference runs `ray_tpu.train.train_state.ShardedTrainStep` in this
process on the 8 virtual CPU devices, on meshes {seq: 2}, {data: 2} and
{data: 2, seq: 2}; the port runs the same config (`TransformerConfig.tiny`
in fp32, flash attention: its plain version on the CPU) on 2 or 4 gloo
ranks in TorchTrainer workers, from the reference's initial state
carried across with `state_from_numpy`, with
`default_optimizer(learning_rate=1e-2, warmup_steps=1)` on both sides so
that 3 steps move the params.  Every rank passes the same global batch.

Held, per mesh, with and without a mask, under full remat and "dots",
with the unfused cross-entropy, and with the fused one without a mask
(the fused CE rounds x and dlogits to bf16, and Adam carries a flipped
rounding of a masked run's small gradients into its update whole:
tests/test_torch_train.py::test_moe_train_step_matches_jax):
- loss and grad_norm of each step to rtol 2e-5 and 1e-4 (the port's
  global mean over ranks sums in another order than XLA's);
- each final param to 1e-4 of its largest magnitude (see
  tests/test_torch_train.py: Adam's per-element division carries a
  small gradient's rounding into its update);
- the ranks' params bit for bit (digest and arrays), and their metrics
  equal; "dots" equal to full remat bit for bit.
Also: `forward` under a seq mesh equals the reference's dense forward
(tests/test_ring_pipeline.py:120-147); `get_mesh`, `prepare_pytree` and
`shard_batch` on a 2-rank mesh; NotImplementedError for fsdp, tensor,
expert and stage of more than one rank and for MoE on a mesh.

One cluster for the file (num_cpus=4, num_gpus=0) and one fit per mesh
shape in a test run, behind module-scoped fixtures whose result the
xdist workers share (torch_ranks.shared_result); each case asserts in
its own test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ranks import PORT, fit_ranks, shared_result

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel.mesh import build_mesh
from ray_tpu.train import train_state as jts

rt = importlib.import_module(PORT)
ttf = importlib.import_module(f"{PORT}.models.transformer")
tts = importlib.import_module(f"{PORT}.train.train_state")

MESHES = {"seq2": {"seq": 2}, "data2": {"data": 2},
          "data2_seq2": {"data": 2, "seq": 2}}
STEPS = 3
# (mask, remat policy, fused CE); "dots" is checked against "full" too.
CASES = [(False, "full", False), (True, "full", False),
         (False, "dots", False), (True, "dots", False),
         (False, "full", True)]
LOSS_RTOL, NORM_RTOL, PARAM_TOL = 2e-5, 1e-4, 1e-4


def _jcfg(**kw):
    return jtf.TransformerConfig.tiny(**{**dict(
        num_layers=2, num_heads=4, num_kv_heads=2, hidden_size=32,
        intermediate_size=64, vocab_size=64, max_seq_len=64,
        dtype=jnp.float32, use_flash=True, fused_ce=False), **kw})


def _tcfg_kw(jcfg):
    """The port's config as keyword arguments (picklable for the ranks)."""
    import dataclasses

    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jtf.TransformerConfig)}
    kw["dtype"] = kw["param_dtype"] = "float32"
    return kw


def _batch(mask):
    rng = np.random.default_rng(11)
    out = {"tokens": rng.integers(0, 64, size=(4, 33)).astype(np.int32)}
    if mask:
        m = (rng.random((4, 33)) < 0.7).astype(np.float32)
        m[1, 1:] = 0.0  # one row with no target counted
        out["mask"] = m
    return out


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _reference(axes, mask, fused):
    """The reference's initial state (numpy), and its metrics and final
    params after STEPS steps on `axes`."""
    n = int(np.prod(list(axes.values())))
    mesh = build_mesh(axes=axes, devices=jax.devices()[:n])
    step = jts.ShardedTrainStep(_jcfg(fused_ce=fused), mesh,
                                optimizer=jts.default_optimizer(
        learning_rate=1e-2, warmup_steps=1))
    state = step.init(jax.random.key(5))
    start = jax.tree.map(np.asarray, state)
    batch = {k: jnp.asarray(v) for k, v in _batch(mask).items()}
    metrics = []
    for _ in range(STEPS):
        state, m = step.step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return start, metrics, _flat(state["params"])


@pytest.fixture(scope="module")
def cluster():
    drv = rt.init(num_cpus=4, num_gpus=0, log_to_driver=False)
    try:
        yield drv
    finally:
        rt.shutdown()


def _run_mesh(tmp_path_factory, name):
    port = PORT
    axes = MESHES[name]
    n = int(np.prod(list(axes.values())))
    refs = {(mask, fused): _reference(axes, mask, fused)
            for mask, fused in ((False, False), (True, False), (False, True))}

    def loop(config):
        import os
        import pickle

        import numpy as np
        import torch
        import torch.distributed as dist

        tfm = importlib.import_module(f"{port}.models.transformer")
        ts = importlib.import_module(f"{port}.train.train_state")
        mesh_mod = importlib.import_module(f"{port}.parallel.mesh")
        comm = importlib.import_module(f"{port}.parallel.comm")
        tr = importlib.import_module(f"{port}.train")
        torch.set_num_threads(1)
        kw = dict(config["cfg"], dtype=torch.float32,
                  param_dtype=torch.float32)
        mesh = mesh_mod.build_mesh(axes=config["axes"])
        res = {"rank": dist.get_rank()}

        def flat(tree, prefix=""):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out.update(flat(v, f"{prefix}{k}/"))
                else:
                    out[f"{prefix}{k}"] = v.detach().numpy().copy()
            return out

        for (mask, policy, fused) in config["cases"]:
            start = config["starts"][mask, fused]
            cfg = tfm.TransformerConfig(**dict(
                kw, remat=True, remat_policy=policy, fused_ce=fused))
            step = ts.ShardedTrainStep(
                cfg, mesh, device="cpu", optimizer=ts.default_optimizer(
                    learning_rate=1e-2, warmup_steps=1))
            state = ts.state_from_numpy(start, cfg, device="cpu")
            metrics = []
            for _ in range(config["steps"]):
                state, m = step.step(state, config["batches"][mask])
                metrics.append((m["loss"].item(),
                                m["grad_norm"].item()))
            res[(mask, policy, fused)] = {
                "metrics": metrics, "params": flat(state["params"]),
                "digest": step.check_replicated(state["params"]),
                "comm": dict(step.last_comm)}

        # forward under the mesh: global tokens in, global logits out.
        cfg = tfm.TransformerConfig(**dict(kw, remat=False))
        params = ts.state_from_numpy(config["starts"][False, False], cfg,
                                     device="cpu")["params"]
        with torch.no_grad(), mesh:
            res["forward"] = tfm.forward(
                params, torch.from_numpy(config["tokens"]).long(),
                cfg).numpy()

        if config["axes"] == {"data": 2}:
            # The Train library's helpers on two ranks.
            m = tr.get_mesh({"dp": 2})
            rank = dist.get_rank()
            tree = {"w": torch.full((3,), float(rank + 1)),
                    "n": [np.arange(2) + rank]}
            got = tr.prepare_pytree(tree, m)
            res["prepare"] = (got["w"].tolist(), got["n"][0].tolist())
            res["shard"] = tr.shard_batch(
                {"x": np.arange(8).reshape(4, 2)}, m)["x"].tolist()
            res["get_mesh"] = dict(m.shape)
            res["digests"] = comm.digests_equal([got["w"]], m.get_group())
            raised = {}
            for axis in ("fsdp", "tensor", "expert", "stage"):
                try:
                    ts.ShardedTrainStep(cfg, mesh_mod.build_mesh(
                        axes={axis: 2}), device="cpu")
                except NotImplementedError as e:
                    raised[axis] = str(e)
            moe = tfm.TransformerConfig(**dict(kw, num_experts=4))
            try:
                with mesh:
                    tfm.loss_fn(tfm.init_params(moe, 0, device="cpu"),
                                {"tokens": torch.zeros((2, 9),
                                                       dtype=torch.long)},
                                moe)
            except NotImplementedError as e:
                raised["moe"] = str(e)
            try:
                tr.prepare_pytree(tree, m, rules={})
            except NotImplementedError as e:
                raised["rules"] = str(e)
            res["raised"] = raised
        with open(os.path.join(config["out"],
                               f"rank{dist.get_rank()}.pkl"), "wb") as f:
            pickle.dump(res, f)

    tokens = np.random.default_rng(3).integers(0, 64, size=(4, 32))
    config = {"axes": axes, "cfg": _tcfg_kw(_jcfg()), "steps": STEPS,
              "starts": {key: refs[key][0] for key in refs},
              "batches": {mask: _batch(mask) for mask in (False, True)},
              "cases": CASES,
              "tokens": tokens}
    ranks = fit_ranks(loop, n, tmp_path_factory.mktemp(name), config,
                      timeout=300.0)
    return refs, ranks, tokens


def _shared_mesh(request, tmp_path_factory, name):
    """The mesh's fit, once per test run (torch_ranks.shared_result);
    the file's cluster starts only where the fit runs."""
    def compute():
        request.getfixturevalue("cluster")
        return _run_mesh(tmp_path_factory, name)

    return shared_result(request, f"sharded_train-{name}", compute)


@pytest.fixture(scope="module")
def seq2(request, tmp_path_factory):
    return _shared_mesh(request, tmp_path_factory, "seq2")


@pytest.fixture(scope="module")
def data2(request, tmp_path_factory):
    return _shared_mesh(request, tmp_path_factory, "data2")


@pytest.fixture(scope="module")
def data2_seq2(request, tmp_path_factory):
    return _shared_mesh(request, tmp_path_factory, "data2_seq2")


def _check_steps(run, mask, policy, fused):
    refs, ranks, _ = run
    _, want_metrics, want_params = refs[mask, fused]
    got = ranks[0][(mask, policy, fused)]
    for (tl, tn), (jl, jn) in zip(got["metrics"], want_metrics):
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(tn, jn, rtol=NORM_RTOL)
    assert set(got["params"]) == set(want_params)
    for name, w in want_params.items():
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(got["params"][name] - w).max() <= PARAM_TOL * scale, \
            name
    # Replicated: every rank's params bit for bit, the same metrics.
    for r in ranks[1:]:
        other = r[(mask, policy, fused)]
        assert other["digest"] == got["digest"]
        assert other["metrics"] == got["metrics"]
        for name, p in got["params"].items():
            np.testing.assert_array_equal(other["params"][name], p)
    # "dots" keeps products; the values are full remat's, bit for bit.
    full = ranks[0][(mask, "full", fused)]
    assert got["metrics"] == full["metrics"]
    assert got["digest"] == full["digest"]
    # The gradient all-reduce ran in flat buckets over the whole tree.
    n_params = sum(p.size for p in got["params"].values())
    assert got["comm"]["bytes"] == 4 * n_params


@pytest.mark.parametrize("mask,policy,fused", CASES)
def test_seq2_steps_match_reference(seq2, mask, policy, fused):
    _check_steps(seq2, mask, policy, fused)


@pytest.mark.parametrize("mask,policy,fused", CASES)
def test_data2_steps_match_reference(data2, mask, policy, fused):
    _check_steps(data2, mask, policy, fused)


@pytest.mark.parametrize("mask,policy,fused", CASES)
def test_data2_seq2_steps_match_reference(data2_seq2, mask, policy, fused):
    _check_steps(data2_seq2, mask, policy, fused)


@pytest.mark.parametrize("name", ["seq2", "data2_seq2"])
def test_forward_under_seq_mesh_equals_dense(name, request):
    """forward() under a seq-sharded mesh (ring_attention="auto")
    matches the reference's dense single-device forward, on every rank."""
    refs, ranks, tokens = request.getfixturevalue(name)
    start = refs[False, False][0]
    dense = jtf.forward(jax.tree.map(jnp.asarray, start["params"]),
                        jnp.asarray(tokens), _jcfg(use_flash=False))
    for r in ranks:
        np.testing.assert_allclose(r["forward"], np.asarray(dense),
                                   rtol=5e-4, atol=5e-4)


def test_train_helpers_on_two_ranks(data2):
    """get_mesh builds the mesh over the worker group, prepare_pytree
    gives every rank rank 0's tree, shard_batch keeps the rank's data
    rows."""
    _, ranks, _ = data2
    for r, res in enumerate(ranks):
        assert res["get_mesh"] == {"data": 2, "stage": 1, "fsdp": 1,
                                   "seq": 1, "tensor": 1, "expert": 1}
        assert res["prepare"] == ([1.0, 1.0, 1.0], [0, 1])
        assert res["shard"] == [[0, 1], [2, 3]] if r == 0 \
            else res["shard"] == [[4, 5], [6, 7]]
        assert res["digests"][0] is True


def test_later_axes_and_moe_raise_on_a_mesh(data2):
    _, ranks, _ = data2
    raised = ranks[0]["raised"]
    assert set(raised) == {"fsdp", "tensor", "expert", "stage", "moe",
                           "rules"}
    assert "sharding slice" in raised["fsdp"]
    assert "sharding slice" in raised["tensor"]
    assert "pipeline slice" in raised["stage"]
    assert "expert-parallel" in raised["expert"]
    assert "expert-parallel" in raised["moe"]
    assert "sharding slice" in raised["rules"]


@pytest.mark.parametrize("axes,match", [
    ({"fsdp": 2}, "sharding"), ({"tp": 2}, "sharding"),
    ({"ep": 2}, "expert-parallel"), ({"stage": 1}, "pipeline")])
def test_axes_dicts_for_later_slices_raise(axes, match):
    """One process: an axes dict naming a later slice's axis raises
    NotImplementedError; a dict of more than one device is no
    one-process mesh."""
    with pytest.raises(NotImplementedError, match=match):
        tts.ShardedTrainStep(ttf.TransformerConfig.tiny(), mesh=axes,
                             device="cpu")
    with pytest.raises(ValueError):
        tts.ShardedTrainStep(ttf.TransformerConfig.tiny(), mesh={"data": 2},
                             device="cpu")


def test_ring_attention_true_without_a_mesh_raises():
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32,
                                     ring_attention=True)
    params = ttf.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        ttf.loss_fn(params, {"tokens": torch.zeros((1, 5),
                                                   dtype=torch.long)}, cfg)
