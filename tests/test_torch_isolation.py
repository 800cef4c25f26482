"""The port stands alone: no module of it imports JAX or the JAX package.

An AST scan of every module of the port finds no `jax` or `ray_tpu`
import (its own package aside), and a subprocess imports every module
with `jax` and `ray_tpu` made unimportable.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
PORT_DIR = os.path.join(REPO, PORT)


def _modules():
    for dirpath, dirnames, files in os.walk(PORT_DIR):
        dirnames[:] = [d for d in dirnames if not d.startswith(("_", "."))]
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _module_name(path):
    rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


@pytest.mark.parametrize("script", ["chip_smoke.py", None])
def test_no_jax_or_reference_imports(script):
    paths = [os.path.join(REPO, script)] if script else list(_modules())
    assert paths
    for path in paths:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "flax", "ray_tpu"}, (path, roots)


def test_every_module_imports_without_jax():
    names = sorted(_module_name(p) for p in _modules())
    assert {f"{PORT}.{m}" for m in (
        "serve.llm_engine", "ops.attention", "ops.fused_ce", "train.optim",
        "train.train_state", "bench")} <= set(names)
    code = ("import sys\n"
            "for blocked in ('jax', 'jaxlib', 'ray_tpu'):\n"
            "    sys.modules[blocked] = None\n"
            f"for name in {names!r}:\n"
            "    __import__(name)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
