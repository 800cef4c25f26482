"""The port's ring attention against the JAX package's, on the CPU.

Mirrors tests/test_ring_pipeline.py:20-117 in fp32.  The reference runs
`ray_tpu.ops.ring_attention.ring_attention` on the 8 virtual CPU devices
of this process; the port runs the same global inputs (made from a seed
with numpy) on 2 or 4 gloo ranks in TorchTrainer workers.  Values are
held to the reference tests' tolerances (rtol 2e-4, atol 2e-5), and so
are the gradients of sum(out^2) for q, k and v (rtol 5e-3, atol 5e-4):
each rank's gradient covers its own rows and chunk, and their sum over
the ranks is the whole one.  Cases: {seq: 2}, {seq: 4} and
{data: 2, seq: 2}, causal and not; unexpanded GQA K/V against the
expanded form; `_merge` against the reference's on rows that hold the
-1e30 sentinel; and a seq-2 layer under a remat policy that keeps the
flash kernel's (out, lse) against the same layer without remat (each
ring step keeps its own); a seq-2 loss under full remat whose backward
runs on a thread outside the mesh (each layer's re-run still takes the
ring).

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

from ray_tpu.ops import ring_attention as jring
from ray_tpu.parallel.mesh import build_mesh

rt = importlib.import_module(PORT)
tring = importlib.import_module(f"{PORT}.ops.ring_attention")

MESHES = {"seq2": {"seq": 2}, "seq4": {"seq": 4},
          "data2_seq2": {"data": 2, "seq": 2}}
VALUES = dict(rtol=2e-4, atol=2e-5)
GRADS = dict(rtol=5e-3, atol=5e-4)


def _inputs(seed, b=4, s=32, h=4, kvh=4, d=8):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, s, h, d)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(b, s, kvh, d)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    return q, k, v


def _reference(axes, causal, q, k, v):
    """The reference's ring attention on the first prod(axes) virtual
    devices: out and the gradients of sum(out^2)."""
    n = int(np.prod(list(axes.values())))
    mesh = build_mesh(axes=axes, devices=jax.devices()[:n])

    def loss(q, k, v):
        return jnp.sum(jring.ring_attention(q, k, v, mesh=mesh,
                                            causal=causal) ** 2)

    with mesh:
        out = jax.jit(lambda q, k, v: jring.ring_attention(
            q, k, v, mesh=mesh, causal=causal))(q, k, v)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def cluster():
    drv = rt.init(num_cpus=4, num_gpus=0, log_to_driver=False)
    try:
        yield drv
    finally:
        rt.shutdown()


def _run_mesh(tmp_path_factory, name):
    """One fit on the mesh's ranks: for causal and not, each rank's
    global out and its q/k/v gradients; on {seq: 2} also the GQA and
    remat cases."""
    port = PORT
    axes = MESHES[name]
    n = int(np.prod(list(axes.values())))

    def loop(config):
        import os
        import pickle
        import threading

        import numpy as np
        import torch
        import torch.distributed as dist

        ring = importlib.import_module(f"{port}.ops.ring_attention")
        mesh_mod = importlib.import_module(f"{port}.parallel.mesh")
        tfm = importlib.import_module(f"{port}.models.transformer")
        remat = importlib.import_module(f"{port}.models.remat")
        torch.set_num_threads(1)
        mesh = mesh_mod.build_mesh(axes=config["axes"])

        def run(q, k, v, causal):
            q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
            out = ring.ring_attention(q, k, v, mesh=mesh, causal=causal)
            (out ** 2).sum().backward()
            return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]

        res = {"rank": dist.get_rank()}
        for causal in (True, False):
            res[causal] = run(*config["inputs"], causal)
        if "gqa" in config:
            q, k, v = config["gqa"]
            rep = q.shape[2] // k.shape[2]
            res["gqa"] = run(q, k, v, True)
            res["gqa_expanded"] = run(q, k.repeat(rep, 2), v.repeat(rep, 2),
                                      True)
        if "block" in config:
            # One layer under a policy that keeps "attn", and without
            # remat: the same loss and gradients.
            cfg = tfm.TransformerConfig.tiny(dtype=torch.float32)
            params = tfm.init_params(cfg, 3, device="cpu")
            bp = {k: t[0] for k, t in params["blocks"].items()}
            x0 = torch.from_numpy(config["block"])
            s_loc = x0.shape[1] // 2
            off = mesh.axis_index("seq") * s_loc
            pos = (off + torch.arange(s_loc)).expand(x0.shape[0], s_loc)
            cos, sin = tfm.rope_freqs(cfg.head_dim_, cfg.max_seq_len,
                                      cfg.rope_theta, device="cpu")
            x_loc = x0[:, off:off + s_loc]
            kept = {}
            for policy in ("save_attn", None):
                live = {k: t.detach().requires_grad_() for k, t in bp.items()}
                x = x_loc.clone().requires_grad_()
                if policy is None:
                    y, _ = tfm._block(x, live, cos, sin, pos, None, cfg,
                                      ring=mesh)
                else:
                    memo = remat.Remat(policy)
                    y, _ = torch.utils.checkpoint.checkpoint(
                        tfm._block, x, live, cos, sin, pos, None, cfg,
                        memo, mesh, use_reentrant=False)
                    memo.replay = True
                    kept = sorted(memo.kept)
                (y ** 2).sum().backward()
                res[("block", policy)] = (
                    y.detach().numpy(), x.grad.numpy(),
                    {k: t.grad.numpy() for k, t in live.items()})
            res["kept"] = kept
            # The loss under `with mesh:` and its backward on another
            # thread, outside the mesh (autograd runs a CUDA backward on
            # its device thread): the re-run of each checkpointed layer
            # must still take the ring.
            cfg = tfm.TransformerConfig.tiny(dtype=torch.float32,
                                             remat=True)
            batch = {"tokens": torch.from_numpy(config["tokens"])}
            grads = {}
            for where in ("here", "thread"):
                live = {k: t.detach().requires_grad_() if torch.is_tensor(t)
                        else {n: w.detach().requires_grad_()
                              for n, w in t.items()}
                        for k, t in params.items()}
                leaves = [live["tok_embed"], live["final_norm"],
                          *live["blocks"].values()]
                with mesh:
                    loss = tfm.loss_fn(live, batch, cfg)
                if where == "here":
                    with mesh:
                        got = torch.autograd.grad(loss, leaves)
                else:
                    box = {}

                    def back():
                        try:
                            box["g"] = torch.autograd.grad(loss, leaves)
                        except BaseException as e:
                            box["e"] = e

                    t = threading.Thread(target=back)
                    t.start()
                    t.join(120)
                    if "e" in box:
                        raise box["e"]
                    got = box["g"]
                grads[where] = [g.numpy() for g in got]
            res["thread_grads"] = grads
        with open(os.path.join(config["out"],
                               f"rank{dist.get_rank()}.pkl"), "wb") as f:
            pickle.dump(res, f)

    config = {"axes": axes, "inputs": _inputs(0)}
    if name == "seq2":
        config["gqa"] = _inputs(1, h=4, kvh=2)
        config["block"] = np.random.default_rng(2).normal(
            size=(2, 32, 64)).astype(np.float32)
        config["tokens"] = np.random.default_rng(5).integers(
            0, 256, size=(2, 33))
    out = fit_ranks(loop, n, tmp_path_factory.mktemp(name), config)
    return config, out


def _shared_mesh(request, tmp_path_factory, name):
    """The mesh's fit, once per test run (torch_ranks.shared_result);
    the file's cluster starts only where the fit runs."""
    def compute():
        request.getfixturevalue("cluster")
        return _run_mesh(tmp_path_factory, name)

    return shared_result(request, f"ring-{name}", compute)


@pytest.fixture(scope="module")
def seq2(request, tmp_path_factory):
    return _shared_mesh(request, tmp_path_factory, "seq2")


@pytest.fixture(scope="module")
def seq4(request, tmp_path_factory):
    return _shared_mesh(request, tmp_path_factory, "seq4")


@pytest.fixture(scope="module")
def data2_seq2(request, tmp_path_factory):
    return _shared_mesh(request, tmp_path_factory, "data2_seq2")


def _check_against_reference(config, ranks, causal):
    want_out, want_grads = _reference(config["axes"], causal,
                                      *config["inputs"])
    for r in ranks:
        out, _ = r[causal]
        np.testing.assert_allclose(out, want_out, **VALUES)
    got = [sum(r[causal][1][i] for r in ranks) for i in range(3)]
    for g, w in zip(got, want_grads):
        np.testing.assert_allclose(g, w, **GRADS)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_seq2_matches_reference(seq2, causal):
    _check_against_reference(*seq2, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_seq4_matches_reference(seq4, causal):
    _check_against_reference(*seq4, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_data_and_seq_matches_reference(data2_seq2, causal):
    """Mixed mesh: rows on data, sequence on seq (the reference's
    test_ring_attention_with_data_and_seq_axes)."""
    _check_against_reference(*data2_seq2, causal)


def test_ring_gqa_unexpanded_equals_expanded(seq2):
    """The ring rotates KVH < H heads: the values equal the expanded
    form's, and the K/V gradients are the expanded ones summed over each
    group of query heads; both match the reference, which takes the
    expanded K/V."""
    config, ranks = seq2
    q, k, v = config["gqa"]
    rep = q.shape[2] // k.shape[2]
    want_out, (wq, wk, wv) = _reference(
        config["axes"], True, q, np.repeat(k, rep, 2), np.repeat(v, rep, 2))
    for r in ranks:
        np.testing.assert_allclose(r["gqa"][0], r["gqa_expanded"][0],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["gqa"][0], want_out, **VALUES)
    got = [sum(r["gqa"][1][i] for r in ranks) for i in range(3)]
    exp = [sum(r["gqa_expanded"][1][i] for r in ranks) for i in range(3)]

    def fold(g):  # [b, s, h, d] -> [b, s, kvh, d]
        b, s, h, d = g.shape
        return g.reshape(b, s, h // rep, rep, d).sum(3)

    np.testing.assert_allclose(got[0], exp[0], rtol=1e-5, atol=1e-6)
    for i in (1, 2):
        np.testing.assert_allclose(got[i], fold(exp[i]), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(got[0], wq, **GRADS)
    np.testing.assert_allclose(got[1], fold(wk), **GRADS)
    np.testing.assert_allclose(got[2], fold(wv), **GRADS)


def test_ring_steps_keep_their_own_flash_outputs_under_remat(seq2):
    """A seq-2 layer under "save_attn" keeps one (out, lse) per ring step
    ("attn" and "attn@1") and gives the output and gradients of the
    layer without remat; one name for both steps would hand step 0's
    result to step 1 in the re-run."""
    _, ranks = seq2
    for r in ranks:
        assert r["kept"] == ["attn", "attn@1"]
        y, dx, dw = r[("block", "save_attn")]
        y0, dx0, dw0 = r[("block", None)]
        np.testing.assert_array_equal(y, y0)
        np.testing.assert_array_equal(dx, dx0)
        for name in dw0:
            np.testing.assert_array_equal(dw[name], dw0[name], err_msg=name)


def test_checkpoint_rerun_on_another_thread_takes_the_ring(seq2):
    """A seq-2 loss under full remat, its backward run on a thread that
    entered no mesh (as autograd runs a CUDA backward on its device
    thread): each layer's re-run still takes the ring, and the gradients
    equal those of a backward run under the mesh, bit for bit."""
    _, ranks = seq2
    for r in ranks:
        here, there = r["thread_grads"]["here"], r["thread_grads"]["thread"]
        assert len(here) == len(there)
        for a, b in zip(here, there):
            np.testing.assert_array_equal(a, b)


def test_merge_matches_reference_on_sentinel_rows():
    """`_merge` against the reference's: fp32 values and lse, where
    either side, both, or neither holds the -1e30 sentinel."""
    rng = np.random.default_rng(4)
    b, q, h, d = 2, 6, 3, 4
    o1, o2 = (rng.normal(size=(b, q, h, d)).astype(np.float32)
              for _ in range(2))
    l1, l2 = (rng.normal(size=(b, h, q)).astype(np.float32) * 3
              for _ in range(2))
    o1[:, :2] = 0.0
    l1[:, :, :2] = -1e30          # rows 0-1: left side saw no key
    o2[:, 1:3] = 0.0
    l2[:, :, 1:3] = -1e30         # rows 1-2: right side saw none
    want_o, want_l = jring._merge(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    got_o, got_l = tring._merge(*(torch.from_numpy(x)
                                  for x in (o1, l1, o2, l2)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-6)
    assert (got_l.numpy()[:, :, 1] == -1e30).all()
    assert np.isfinite(got_o.numpy()).all()
    # Gradients through a sentinel row are finite, and zero for the side
    # without weight.
    t = [torch.from_numpy(x).requires_grad_() for x in (o1, l1, o2, l2)]
    out, lse = tring._merge(*t)
    (out.sum() + lse.clamp_min(-10).sum()).backward()
    for x in t:
        assert torch.isfinite(x.grad).all()
    assert (t[0].grad[:, :2] == 0).all() and (t[2].grad[:, 1:3] == 0).all()
