"""The port's worker zygote (core/zygote.py), on the CPU.

The spawn-and-semantics, env-isolation and no-leaked-children cases of
tests/test_zygote.py on one cluster of the port (num_cpus=4, num_gpus=0),
plus the port's own: the template warms torch (import only), so a worker
forked from it has torch loaded and CUDA never initialized, and it sees no
card (CUDA_VISIBLE_DEVICES="").  The no-leaked-children case shuts the
cluster down and comes last.
"""

import importlib
import time

import pytest

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
rt = importlib.import_module(PORT)
zygote = importlib.import_module(f"{PORT}.core.zygote")

T = 120


@pytest.fixture(scope="module")
def zcluster():
    drv = rt.init(num_cpus=4, num_gpus=0, log_to_driver=False)
    try:
        yield drv
    finally:
        if rt.is_initialized():
            rt.shutdown()


def _wait_ready(timeout=60.0):
    h = zygote.get_zygote()
    h.prewarm()
    deadline = time.time() + timeout
    while not h._ready and time.time() < deadline:
        time.sleep(0.1)
    assert h._ready, "zygote template never became ready"


def _forked_pids(drv):
    return {w.proc.pid for w in drv.control.workers.values()
            if isinstance(w.proc, zygote.ZygoteProc)}


def test_zygote_spawn_and_semantics(zcluster):
    """Once the template is warm, new workers are forks (ZygoteProc) and
    run tasks with full semantics; the fork has torch imported, CUDA
    uninitialized and no visible card."""
    _wait_ready()

    # A distinct runtime env keys a new worker pool: a post-warm spawn.
    @rt.remote(runtime_env={"env_vars": {"ZSPAWN": "1"}})
    def probe():
        import os
        import sys

        import torch

        return (os.getpid(), os.environ.get("ZSPAWN"),
                "torch" in sys.modules, torch.cuda.is_initialized(),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    pid, flag, has_torch, cuda_init, visible = rt.get(probe.remote(),
                                                      timeout=T)
    assert flag == "1"
    assert pid in _forked_pids(zcluster), \
        "no worker was spawned via the zygote fast path"
    assert has_torch and cuda_init is False and visible == ""


def test_zygote_env_isolation(zcluster):
    """Two spawns with different env vars must not bleed into each other
    (os.environ is rebuilt per fork)."""
    _wait_ready()

    @rt.remote(runtime_env={"env_vars": {"ISO": "a"}})
    def get_a():
        import os

        return os.environ.get("ISO")

    @rt.remote(runtime_env={"env_vars": {"ISO": "b"}})
    def get_b():
        import os

        return os.environ.get("ISO")

    assert rt.get(get_a.remote(), timeout=T) == "a"
    assert rt.get(get_b.remote(), timeout=T) == "b"


def test_template_imports_torch_without_cuda():
    """The template's warm-up imports torch and never calls into
    torch.cuda (a template with a CUDA context forks children that
    cannot use the card)."""
    import ast
    import inspect
    import textwrap

    fn = ast.parse(textwrap.dedent(
        inspect.getsource(zygote._ZygoteServer._warm_torch))).body[0]
    imports = [a.name for n in ast.walk(fn) if isinstance(n, ast.Import)
               for a in n.names]
    cuda = [n for n in ast.walk(fn) if isinstance(n, ast.Attribute)
            and n.attr == "cuda"]
    assert imports == ["torch"] and not cuda


def test_zygote_no_leaked_children(zcluster):
    """After shutdown, the template reports zero live children.  Last in
    the file: it ends the file's cluster."""
    _wait_ready()

    @rt.remote(runtime_env={"env_vars": {"ZL": "1"}})
    def f():
        return 1

    try:
        assert rt.get([f.remote() for _ in range(4)], timeout=T) == [1] * 4
    finally:
        rt.shutdown()
    h = zygote.get_zygote()
    deadline = time.time() + 30
    reply = None
    while time.time() < deadline:
        try:
            reply = h._request({"op": "poll_all"})
        except RuntimeError:  # raylint: allow-swallow(template already gone: nothing to leak from)
            return
        if not reply["alive"]:
            return
        time.sleep(0.5)
    raise AssertionError(f"zygote still reports children: {reply['alive']}")
