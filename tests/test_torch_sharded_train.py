"""The port's ShardedTrainStep on data, seq, fsdp and tensor ranks against
the JAX package's, on the CPU.

The reference runs `ray_tpu.train.train_state.ShardedTrainStep` in this
process on the 8 virtual CPU devices, on meshes {seq: 2}, {data: 2},
{data: 2, seq: 2}, {fsdp: 2}, {data: 2, fsdp: 2}, {tensor: 2},
{fsdp: 2, tensor: 2} and {data: 2, tensor: 2}; the port runs the
same config (`TransformerConfig.tiny` in fp32, flash attention: its
plain version on the CPU) on 2 or 4 gloo ranks in TorchTrainer workers,
from the reference's initial state carried across with
`state_from_numpy` (and cut to each rank's blocks with `shard_state`),
with `default_optimizer(learning_rate=1e-2, warmup_steps=1)` on both
sides so that 3 steps move the params.  Every rank passes the same
global batch.

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
- the ranks' whole params bit for bit (digest and arrays; gathered from
  the blocks on fsdp ranks), and their metrics equal; "dots" equal to
  full remat bit for bit; the bytes of each kind of collective.
On fsdp ranks also: each rank holds its half of every leaf with an
embed dim, and Adam's moments in the same layout; losses and grad_norm
equal to the replicated {data: 2} run's (a norm over one rank's blocks
would not be); `prepare_pytree` with the model's logical axes,
`shard_batch` over fsdp, and `reduce_scatter` / `all_gather` in a rank
order that is not the group's.
On tensor ranks also: each rank holds its half of every leaf with a
heads, mlp or vocab dim (and of the embed dim too with fsdp), Adam's
moments in the same layout, the norms bit-equal on every rank; losses
and grad_norm equal to {data: 2}'s (a loss pair or norms' gradient
summed over tensor would be t times off); the bytes of the model's
all-reduces over `tensor` (`last_comm["tensor"]`) as the shapes count
them; `prepare_pytree` placing tensor blocks and `shard_batch` giving
both tensor ranks the same rows.
Also: `forward` under a seq mesh and under tensor meshes (whole logits
from vocabulary blocks) equals the reference's dense forward
(tests/test_ring_pipeline.py:120-147); `get_mesh`, `prepare_pytree` and
`shard_batch` on a 2-rank data mesh; steps on {fsdp: 2} and
{tensor: 2}; a run on {fsdp: 2} that goes on bit for bit through a
checkpoint saved whole and restored as each rank's blocks
(`load_pytree(shardings=...)`); and NotImplementedError for expert and
stage of more than one rank, tensor with seq, and MoE on a mesh.

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
          "data2_seq2": {"data": 2, "seq": 2}, "fsdp2": {"fsdp": 2},
          "data2_fsdp2": {"data": 2, "fsdp": 2}, "tensor2": {"tensor": 2},
          "fsdp2_tensor2": {"fsdp": 2, "tensor": 2},
          "data2_tensor2": {"data": 2, "tensor": 2}}
TENSOR_MESHES = ["tensor2", "fsdp2_tensor2", "data2_tensor2"]
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
    metrics.append(float(step.eval_step(state["params"], batch)))
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
        optim = importlib.import_module(f"{port}.train.optim")
        torch.set_num_threads(1)
        kw = dict(config["cfg"], dtype=torch.float32,
                  param_dtype=torch.float32)
        mesh = mesh_mod.build_mesh(axes=config["axes"])
        res = {"rank": dist.get_rank(), "axes": config["axes"]}

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
            # The reference's whole state, cut to this rank's blocks (on
            # data and seq ranks every leaf stays whole).
            state = step.shard_state(ts.state_from_numpy(start, cfg,
                                                         device="cpu"))
            metrics = []
            for _ in range(config["steps"]):
                state, m = step.step(state, config["batches"][mask])
                metrics.append((m["loss"].item(),
                                m["grad_norm"].item()))
            metrics.append(step.eval_step(state["params"],
                                          config["batches"][mask]).item())
            adam = state["opt_state"][1][0]
            whole = step.gather_state(state)
            res[(mask, policy, fused)] = {
                "metrics": metrics, "params": flat(whole["params"]),
                "digest": step.check_replicated(whole["params"]),
                "blocks": flat(state["params"]), "mu": flat(adam.mu),
                "nu": flat(adam.nu),
                "whole_mu": flat(whole["opt_state"][1][0].mu),
                "comm": {k: (dict(v) if isinstance(v, dict) else v)
                         for k, v in step.last_comm.items()}}

        # forward under the mesh: global tokens in, global logits out,
        # from the params in the layout the model computes on (whole but
        # on tensor ranks, their blocks there).
        cfg = tfm.TransformerConfig(**dict(kw, remat=False))
        params = ts.state_from_numpy(config["starts"][False, False], cfg,
                                     device="cpu")["params"]
        params = optim.tree_map(
            lambda t, s: s.shard(t), params,
            ts.ShardedTrainStep(cfg, mesh, device="cpu").compute_shardings)
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
                    made = ts.ShardedTrainStep(cfg, mesh_mod.build_mesh(
                        axes={axis: 2}), device="cpu")
                except NotImplementedError as e:
                    raised[axis] = str(e)
                else:
                    res[f"{axis}_wq_spec"] = (
                        tuple(made.param_shardings["blocks"]["wq"].spec),
                        made.sharded)
            moe = tfm.TransformerConfig(**dict(kw, num_experts=4))
            try:
                with mesh:
                    tfm.loss_fn(tfm.init_params(moe, 0, device="cpu"),
                                {"tokens": torch.zeros((2, 9),
                                                       dtype=torch.long)},
                                moe)
            except NotImplementedError as e:
                raised["moe"] = str(e)
            # Rules that map nothing, and the default rules on the names
            # of a tree with no embed axis: every leaf replicated.
            got = tr.prepare_pytree(tree, m, rules={})
            res["rules"] = (got["w"].tolist(), got["n"][0].tolist())
            res["raised"] = raised
        if config["axes"] == {"tensor": 2}:
            # The Train library's helpers on two tensor ranks: the tree
            # placed by the model's logical axes is the step's blocks of
            # rank 0's values; both ranks take every row.
            m = tr.get_mesh({"tensor": 2})
            rank = dist.get_rank()
            cfg = tfm.TransformerConfig(**kw)
            placed = tr.prepare_pytree(
                tfm.init_params(cfg, 7 + rank, device="cpu"), m,
                logical_axes=tfm.logical_axes(cfg))
            want = flat(ts.ShardedTrainStep(cfg, m, device="cpu").shard(
                tfm.init_params(cfg, 7, device="cpu")))
            res["prepare"] = {k: (v.shape, bool(np.array_equal(v, want[k])))
                              for k, v in flat(placed).items()}
            res["shard"] = tr.shard_batch(
                {"x": np.arange(8).reshape(4, 2)}, m)["x"].tolist()
        if config["axes"] == {"fsdp": 2}:
            # The Train library's helpers on two fsdp ranks: the tree
            # placed by the model's logical axes is the step's blocks of
            # rank 0's values; the batch's rows split over fsdp.
            m = tr.get_mesh({"fsdp": 2})
            rank = dist.get_rank()
            cfg = tfm.TransformerConfig(**kw)
            whole = tfm.init_params(cfg, 7 + rank, device="cpu")
            placed = tr.prepare_pytree(whole, m,
                                       logical_axes=tfm.logical_axes(cfg))
            step = ts.ShardedTrainStep(cfg, m, device="cpu")
            want = step.shard(tfm.init_params(cfg, 7, device="cpu"))
            want = flat(want)
            res["prepare"] = {k: (v.shape, bool(np.array_equal(v, want[k])))
                              for k, v in flat(placed).items()}
            res["shard"] = tr.shard_batch(
                {"x": np.arange(8).reshape(4, 2)}, m)["x"].tolist()
            # reduce_scatter and all_gather in a rank order that is not
            # the group's own (sorted) one.
            order = list(reversed(m.axis_ranks("fsdp")))
            x = torch.arange(12.0).reshape(2, 6) * (rank + 1)
            res["reduce_scatter"] = comm.reduce_scatter(
                x, order, m.get_group("fsdp"), 1).tolist()
            res["all_gather"] = comm.all_gather(
                torch.full((1, 2), float(rank)), order, m.get_group("fsdp"),
                0).tolist()
            # A sharded restore mid-run: the state after one step, saved
            # whole by rank 0 and restored as each rank's blocks into a
            # fresh step; then the next step from each.
            ckpt = importlib.import_module(f"{port}.train.checkpoint")
            cfg = tfm.TransformerConfig(**dict(kw, remat=True))

            def make():
                return ts.ShardedTrainStep(
                    cfg, mesh, device="cpu", optimizer=ts.default_optimizer(
                        learning_rate=1e-2, warmup_steps=1))

            live = make()
            state = live.shard_state(ts.state_from_numpy(
                config["starts"][False, False], cfg, device="cpu"))
            batch = config["batches"][False]
            state, _ = live.step(state, batch)
            path = os.path.join(config["out"], "restore")
            whole = live.gather_state(state)
            if rank == 0:
                ckpt.save_pytree(whole, path)
            dist.barrier()
            fresh = make()
            back = ckpt.load_pytree(path,
                                    shardings=fresh.state_shardings(whole))
            (sa, ta), (sb, tb) = (ckpt.flatten_pytree(back),
                                  ckpt.flatten_pytree(state))
            same = sa == sb and ta.keys() == tb.keys() and all(
                ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k])
                for k in ta)
            state, m_live = live.step(state, batch)
            back, m_back = fresh.step(back, batch)
            res["restore"] = {
                "same": same, "loss": (m_live["loss"].item(),
                                       m_back["loss"].item()),
                "digest": (live.check_replicated(live.gather(state["params"])),
                           fresh.check_replicated(
                               fresh.gather(back["params"])))}
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


@pytest.fixture(scope="module")
def fsdp2(request, tmp_path_factory):
    return _shared_mesh(request, tmp_path_factory, "fsdp2")


@pytest.fixture(scope="module")
def data2_fsdp2(request, tmp_path_factory):
    return _shared_mesh(request, tmp_path_factory, "data2_fsdp2")


@pytest.fixture(scope="module")
def tensor2(request, tmp_path_factory):
    return _shared_mesh(request, tmp_path_factory, "tensor2")


@pytest.fixture(scope="module")
def fsdp2_tensor2(request, tmp_path_factory):
    return _shared_mesh(request, tmp_path_factory, "fsdp2_tensor2")


@pytest.fixture(scope="module")
def data2_tensor2(request, tmp_path_factory):
    return _shared_mesh(request, tmp_path_factory, "data2_tensor2")


def _split(name, logical="embed"):
    """Whether the tiny model's leaf `name` has a dim of one of the
    `logical` names (embed: the one the rules split over fsdp; "heads
    mlp vocab": over tensor), and which dim that is."""
    axes = ttf.logical_axes(ttf.TransformerConfig.tiny())
    for k in name.split("/"):
        axes = axes[k]
    dims = [d for d, a in enumerate(axes) if a in logical.split()]
    return bool(dims), (dims[0] if dims else None)


def _tensor_bytes(axes, cfg=None):
    """The bytes of the model's collectives over `tensor` in one step on
    a rank of mesh `axes` (fp32): per layer, the two activation
    all-reduces of the forward (after wo and w_down), the first of them
    again in the checkpoint's re-run (which stops after the layer's last
    saved tensor, before the MLP's all-reduce) and the two of the
    backward (the gradients entering q/k/v and gate/up); the
    embedding's and the LM head's dx; the cross-entropy's max and its
    (sum of exponentials, target logit) pair per token."""
    if axes.get("tensor", 1) == 1:
        return 0
    kw = _jcfg()
    tokens = 4 // (axes.get("data", 1) * axes.get("fsdp", 1)) * 32
    act = tokens * kw.hidden_size * 4
    return act * (5 * kw.num_layers + 2) + tokens * 4 * 3


def _check_steps(run, mask, policy, fused):
    refs, ranks, _ = run
    _, want_metrics, want_params = refs[mask, fused]
    got = ranks[0][(mask, policy, fused)]
    assert len(got["metrics"]) == len(want_metrics) == STEPS + 1
    for (tl, tn), (jl, jn) in zip(got["metrics"][:-1], want_metrics[:-1]):
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(tn, jn, rtol=NORM_RTOL)
    # eval_step on the final params (gathered on fsdp ranks).
    np.testing.assert_allclose(got["metrics"][-1], want_metrics[-1],
                               rtol=LOSS_RTOL)
    assert set(got["params"]) == set(want_params)
    for name, w in want_params.items():
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(got["params"][name] - w).max() <= PARAM_TOL * scale, \
            name
    # Every rank's whole params bit for bit (gathered from the blocks on
    # an fsdp mesh), the same metrics.
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
    # The collectives' bytes: on data and seq ranks one all-reduce in
    # flat buckets over the whole tree; on fsdp ranks a gather and a
    # reduce-scatter of the split leaves (of their bytes in the compute
    # layout: halved on tensor ranks where a leaf has a heads, mlp or
    # vocab dim), the other leaves' all-reduce over the mesh without
    # tensor and, with data ranks, the blocks' over data; on tensor
    # ranks also the model's all-reduces over tensor.
    axes = ranks[0]["axes"]
    fsdp, data = axes.get("fsdp", 1), axes.get("data", 1)
    t = axes.get("tensor", 1)
    compute = {name: p.size // (t if _split(name, "heads mlp vocab")[0]
                                else 1)
               for name, p in got["params"].items()}
    n_split = sum(n for name, n in compute.items()
                  if fsdp > 1 and _split(name)[0])
    n_rep = sum(compute.values()) - n_split
    others = data * fsdp * axes.get("seq", 1) > 1
    comm = got["comm"]
    assert comm["gather"]["bytes"] == comm["reduce_scatter"]["bytes"] \
        == 4 * n_split
    assert comm["all_reduce"]["bytes"] == (4 * n_rep if others else 0) + (
        4 * n_split // fsdp if data > 1 else 0)
    assert comm["tensor"]["bytes"] == _tensor_bytes(axes)
    assert comm["bytes"] == sum(comm[k]["bytes"] for k in (
        "gather", "reduce_scatter", "all_reduce", "tensor"))


@pytest.mark.parametrize("mask,policy,fused", CASES)
def test_seq2_steps_match_reference(seq2, mask, policy, fused):
    _check_steps(seq2, mask, policy, fused)


@pytest.mark.parametrize("mask,policy,fused", CASES)
def test_data2_steps_match_reference(data2, mask, policy, fused):
    _check_steps(data2, mask, policy, fused)


@pytest.mark.parametrize("mask,policy,fused", CASES)
def test_data2_seq2_steps_match_reference(data2_seq2, mask, policy, fused):
    _check_steps(data2_seq2, mask, policy, fused)


@pytest.mark.parametrize("mask,policy,fused", CASES)
def test_fsdp2_steps_match_reference(fsdp2, mask, policy, fused):
    _check_steps(fsdp2, mask, policy, fused)


@pytest.mark.parametrize("mask,policy,fused", CASES)
def test_data2_fsdp2_steps_match_reference(data2_fsdp2, mask, policy,
                                           fused):
    _check_steps(data2_fsdp2, mask, policy, fused)


@pytest.mark.parametrize("mask,policy,fused", CASES)
def test_tensor2_steps_match_reference(tensor2, mask, policy, fused):
    _check_steps(tensor2, mask, policy, fused)


@pytest.mark.parametrize("mask,policy,fused", CASES)
def test_fsdp2_tensor2_steps_match_reference(fsdp2_tensor2, mask, policy,
                                             fused):
    _check_steps(fsdp2_tensor2, mask, policy, fused)


@pytest.mark.parametrize("mask,policy,fused", CASES)
def test_data2_tensor2_steps_match_reference(data2_tensor2, mask, policy,
                                             fused):
    _check_steps(data2_tensor2, mask, policy, fused)


@pytest.mark.parametrize("name", TENSOR_MESHES)
def test_tensor_ranks_hold_their_blocks(name, request):
    """Each rank holds, of every leaf with a heads, mlp or vocab dim, its
    half along that dim (the block at its tensor coordinate of the
    gathered params; with fsdp also its half of the embed dim), and
    Adam's mu and nu in the same layout; the norms whole and bit-equal
    on every rank."""
    _, ranks, _ = request.getfixturevalue(name)
    axes = ranks[0]["axes"]
    for r, res in enumerate(ranks):
        got = res[False, "full", False]
        outer, t = divmod(r, 2)  # tensor is the inner axis here
        f = outer if axes.get("fsdp", 1) > 1 else 0
        for leaf, whole in got["params"].items():
            block = got["blocks"][leaf]
            tsplit, tdim = _split(leaf, "heads mlp vocab")
            if not tsplit:
                np.testing.assert_array_equal(block, whole)
                np.testing.assert_array_equal(
                    block, ranks[0][False, "full", False]["blocks"][leaf])
                continue
            n = whole.shape[tdim] // 2
            want = np.take(whole, np.arange(t * n, (t + 1) * n), axis=tdim)
            mu = np.take(got["whole_mu"][leaf],
                         np.arange(t * n, (t + 1) * n), axis=tdim)
            if axes.get("fsdp", 1) > 1:
                _, edim = _split(leaf)
                m = want.shape[edim] // 2
                want = np.take(want, np.arange(f * m, (f + 1) * m),
                               axis=edim)
                mu = np.take(mu, np.arange(f * m, (f + 1) * m), axis=edim)
            np.testing.assert_array_equal(block, want)
            for moment in ("mu", "nu"):
                assert got[moment][leaf].shape == block.shape, (leaf, moment)
            np.testing.assert_array_equal(got["mu"][leaf], mu)
        whole_bytes = sum(p.nbytes for p in got["params"].values())
        block_bytes = sum(p.nbytes for p in got["blocks"].values())
        share = 0.5 / (2 if axes.get("fsdp", 1) > 1 else 1)
        assert block_bytes < whole_bytes * (share + 0.1)


@pytest.mark.parametrize("name", TENSOR_MESHES)
def test_tensor_grad_norm_equals_replicated_runs(name, request, data2):
    """The same global batch on tensor ranks and on replicated data
    ranks: the same losses and global gradient norms, within the
    reference tolerances (a loss pair or the norms' gradients summed
    over tensor, or a norm over one rank's blocks, would not be)."""
    _, tensor_ranks, _ = request.getfixturevalue(name)
    _, data_ranks, _ = data2
    for case in CASES:
        for (tl, tn), (dl, dn) in zip(tensor_ranks[0][case]["metrics"][:-1],
                                      data_ranks[0][case]["metrics"][:-1]):
            np.testing.assert_allclose(tl, dl, rtol=LOSS_RTOL)
            np.testing.assert_allclose(tn, dn, rtol=NORM_RTOL)


def test_train_helpers_on_two_tensor_ranks(tensor2):
    """prepare_pytree places rank 0's tree by the model's logical axes
    (the step's tensor blocks: half of each heads, mlp and vocab dim),
    and shard_batch gives both tensor ranks every row."""
    _, ranks, _ = tensor2
    whole = ranks[0][False, "full", False]["params"]
    for res in ranks:
        for leaf, (shape, equal) in res["prepare"].items():
            assert equal, leaf
            split, dim = _split(leaf, "heads mlp vocab")
            if split:
                assert shape[dim] == whole[leaf].shape[dim] // 2, leaf
        assert res["shard"] == [[0, 1], [2, 3], [4, 5], [6, 7]]


@pytest.mark.parametrize("name", ["fsdp2", "data2_fsdp2"])
def test_fsdp_ranks_hold_their_blocks(name, request):
    """Each rank holds, of every leaf with an embed dim, its half along
    that dim (the block at its fsdp coordinate of the gathered params),
    and Adam's mu and nu in the same layout; the other leaves whole."""
    _, ranks, _ = request.getfixturevalue(name)
    for r, res in enumerate(ranks):
        got = res[False, "full", False]
        f = r % 2  # the fsdp coordinate: fsdp is the inner axis here
        for leaf, whole in got["params"].items():
            split, dim = _split(leaf)
            block = got["blocks"][leaf]
            if not split:
                np.testing.assert_array_equal(block, whole)
                continue
            n = whole.shape[dim] // 2
            want = np.take(whole, np.arange(f * n, (f + 1) * n), axis=dim)
            np.testing.assert_array_equal(block, want)
            for moment in ("mu", "nu"):
                assert got[moment][leaf].shape == block.shape, (leaf, moment)
            mu = got["whole_mu"][leaf]
            np.testing.assert_array_equal(
                got["mu"][leaf],
                np.take(mu, np.arange(f * n, (f + 1) * n), axis=dim))
        whole_bytes = sum(p.nbytes for p in got["params"].values())
        block_bytes = sum(p.nbytes for p in got["blocks"].values())
        assert block_bytes < whole_bytes * 0.6


@pytest.mark.parametrize("name", ["fsdp2", "data2_fsdp2"])
def test_fsdp_grad_norm_equals_replicated_runs(name, request, data2):
    """The same global batch on fsdp ranks and on replicated data ranks:
    the same losses and global gradient norms (a norm over one rank's
    blocks alone would differ), within the reference tolerances."""
    _, fsdp_ranks, _ = request.getfixturevalue(name)
    _, data_ranks, _ = data2
    for case in CASES:
        for (fl, fn), (dl, dn) in zip(fsdp_ranks[0][case]["metrics"][:-1],
                                      data_ranks[0][case]["metrics"][:-1]):
            np.testing.assert_allclose(fl, dl, rtol=LOSS_RTOL)
            np.testing.assert_allclose(fn, dn, rtol=NORM_RTOL)


def test_train_helpers_on_two_fsdp_ranks(fsdp2):
    """prepare_pytree places rank 0's tree by the model's logical axes
    (the step's blocks), shard_batch splits the rows over fsdp, and
    reduce_scatter / all_gather follow the rank order they are given."""
    _, ranks, _ = fsdp2
    for r, res in enumerate(ranks):
        for leaf, (shape, equal) in res["prepare"].items():
            assert equal, leaf
            split, dim = _split(leaf)
            if split:
                assert shape[dim] == 32 // 2, (leaf, shape)
        assert res["shard"] == ([[0, 1], [2, 3]] if r == 0
                                else [[4, 5], [6, 7]])
        # Both ranks' x summed is 3 * arange; rank r sits at position
        # 1 - r of the reversed order, so it holds block 1 - r.
        total = 3 * np.arange(12.0).reshape(2, 6)
        np.testing.assert_array_equal(
            res["reduce_scatter"], total[:, 3 * (1 - r):3 * (2 - r)])
        assert res["all_gather"] == [[1.0, 1.0], [0.0, 0.0]]


def test_fsdp2_run_continues_bit_for_bit_through_a_sharded_restore(fsdp2):
    """A state saved whole (gather_state, rank 0) and restored by
    load_pytree(shardings=state_shardings) on each of two fsdp ranks
    equals the rank's live blocks, NamedTuple for NamedTuple, and the
    next step from it equals the next step from the live state, bit for
    bit: the loss, and the gathered params by digest."""
    _, ranks, _ = fsdp2
    for res in ranks:
        r = res["restore"]
        assert r["same"], res["rank"]
        assert r["loss"][0] == r["loss"][1], r
        assert r["digest"][0] == r["digest"][1], r
    assert ranks[0]["restore"] == ranks[1]["restore"]


@pytest.mark.parametrize("name", ["seq2", "data2_seq2"] + TENSOR_MESHES)
def test_forward_under_seq_mesh_equals_dense(name, request):
    """forward() under a seq-sharded mesh (ring_attention="auto"), and
    under tensor meshes (each rank's blocks in, whole logits out),
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
    """On two ranks: steps on {fsdp: 2} and {tensor: 2} split wq (over
    fsdp, over tensor); expert and stage of two ranks, and MoE on a
    mesh, raise naming their items, and so does the model under a mesh
    of tensor with seq; rules that map nothing place a tree
    replicated."""
    _, ranks, _ = data2
    res = ranks[0]
    raised = res["raised"]
    assert set(raised) == {"expert", "stage", "moe"}
    assert res["fsdp_wq_spec"] == (("stage", "fsdp", "tensor"), True)
    assert res["tensor_wq_spec"] == (("stage", "fsdp", "tensor"), True)
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32)
    mesh = importlib.import_module(f"{PORT}.parallel.mesh")
    sizes = {a: 1 for a in mesh.AXIS_ORDER} | {"tensor": 2, "seq": 2}
    with mesh.Mesh(sizes, np.arange(4)), \
            pytest.raises(NotImplementedError, match="6b, tensor with seq"):
        ttf.loss_fn(ttf.init_params(cfg, 0, device="cpu"),
                    {"tokens": torch.zeros((2, 9), dtype=torch.long)}, cfg)
    assert "pipeline slice" in raised["stage"]
    assert "expert-parallel" in raised["expert"]
    assert "expert-parallel" in raised["moe"]
    assert res["rules"] == ([1.0, 1.0, 1.0], [0, 1])


@pytest.mark.parametrize("axes,match", [
    ({"fsdp": 2}, None), ({"tp": 2}, None),
    ({"tp": 2, "sp": 2}, "6b, tensor with seq"),
    ({"ep": 2}, "expert-parallel"), ({"stage": 1}, "pipeline")])
def test_axes_dicts_for_later_slices_raise(axes, match):
    """One process: an axes dict naming a later slice's axis, or tensor
    with seq, raises NotImplementedError.  fsdp and tensor are ported:
    {fsdp: 1} and {tensor: 1} train, and {fsdp: 2} or {tp: 2}, like
    {data: 2}, is a dict of more than one device and so no one-process
    mesh (ValueError)."""
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32)
    if match is None:
        step = tts.ShardedTrainStep(cfg, mesh={a: 1 for a in axes},
                                    device="cpu")
        assert not step.sharded
        state, m = step.step(step.init(0), {
            "tokens": np.zeros((2, 9), dtype=np.int32)})
        assert torch.isfinite(m["loss"]) and state["step"] == 1
        with pytest.raises(ValueError, match="not divisible"):
            tts.ShardedTrainStep(cfg, mesh=axes, device="cpu")
    else:
        with pytest.raises(NotImplementedError, match=match):
            tts.ShardedTrainStep(cfg, mesh=axes, device="cpu")
    with pytest.raises(ValueError):
        tts.ShardedTrainStep(cfg, mesh={"data": 2}, device="cpu")


def test_ring_attention_true_without_a_mesh_raises():
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32,
                                     ring_attention=True)
    params = ttf.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        ttf.loss_fn(params, {"tokens": torch.zeros((1, 5),
                                                   dtype=torch.long)}, cfg)
