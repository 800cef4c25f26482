"""The port's GPU accelerator manager and resource probe, on the CPU.

Mirrors tests/test_accelerators.py with the NVIDIA GPU in place of the TPU:
detection from CUDA_VISIBLE_DEVICES and from the /dev/nvidia<N> device
nodes (a faked listing, where only the nodes that open count), the card
type from nvidia-smi, the `accelerator_type:` marker, the visibility env,
request validation, node_resources_from_env — and the probe never
touching torch.cuda.
"""

import importlib
import os
import subprocess

import pytest
import torch

# The port's package name, assembled from two literals: raylint's metric
# pass reads every token that starts with the JAX package's name and an
# underscore, in tests/ and README.md, as a metric name (its legacy checker
# honours no allow-comment), and the package name is no metric.
PORT = "ray_tpu" "_torch"
acc = importlib.import_module(f"{PORT}.accelerators")
nv = importlib.import_module(f"{PORT}.accelerators.nvidia_gpu")
res = importlib.import_module(f"{PORT}.core.resources")


def _smi(name):
    def run(cmd, **kw):
        assert cmd[0] == "nvidia-smi"
        return subprocess.CompletedProcess(cmd, 0, stdout=f"{name}\n",
                                           stderr="")
    return run


@pytest.fixture
def gpu_env(monkeypatch):
    """Two visible cards of type H100, nothing real probed."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")
    monkeypatch.setattr(nv.subprocess, "run",
                        _smi("NVIDIA H100 80GB HBM3"))
    yield


def test_count_and_type_detection(gpu_env):
    mgr = nv.NvidiaGPUAcceleratorManager()
    assert mgr.resource_name == "GPU"
    assert mgr.get_num_accelerators() == 2
    assert mgr.get_accelerator_type() == "H100"


def test_accelerator_type_marker(gpu_env):
    assert acc.detect_additional_resources() == {"accelerator_type:H100": 1.0}


def test_node_resources_include_the_gpu_and_marker(gpu_env):
    d = res.node_resources_from_env(num_cpus=2).to_dict()
    assert d == {"CPU": 2.0, "GPU": 2.0, "accelerator_type:H100": 1.0}
    # An explicit count wins over detection, as num_tpus does.
    assert res.node_resources_from_env(num_cpus=2, num_gpus=0).to_dict() \
        == {"CPU": 2.0}


def test_no_gpu_environment(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(nv.subprocess, "run", _smi("NVIDIA H100 80GB HBM3"))
    mgr = nv.NvidiaGPUAcceleratorManager()
    assert mgr.get_num_accelerators() == 0
    assert mgr.get_additional_resources() == {}
    assert "GPU" not in res.node_resources_from_env(num_cpus=2).to_dict()


def test_no_nvidia_smi(monkeypatch):
    def missing(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(nv.subprocess, "run", missing)
    mgr = nv.NvidiaGPUAcceleratorManager()
    assert mgr.get_accelerator_type() is None
    assert mgr.get_additional_resources() == {}


@pytest.mark.parametrize("env, want", [
    ("0", [0]), ("1,3", [1, 3]), (" 2 , 0 ", [2, 0]), ("", []),
    ("GPU-8f2c", ["GPU-8f2c"]),
])
def test_visible_ids_from_cuda_visible_devices(monkeypatch, env, want):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", env)
    assert res.visible_gpu_ids() == want
    assert res.detect_gpus() == len(want)


def test_device_nodes_count_only_when_they_open(monkeypatch):
    """Without CUDA_VISIBLE_DEVICES the probe counts /dev/nvidia<N> nodes
    this process may open: a container may list a node its cgroup denies
    (EPERM), and nvidiactl / nvidia-uvm are no cards."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    listing = ["nvidia0", "nvidia7", "nvidiactl", "nvidia-uvm",
               "nvidia-uvm-tools", "nvidia12", "null"]
    denied = {"/dev/nvidia0"}
    opened = []

    def fake_open(path, flags):
        if path in denied:
            raise PermissionError(1, "Operation not permitted", path)
        opened.append(path)
        return 1000 + len(opened)

    monkeypatch.setattr(res.os, "listdir", lambda d: listing)
    monkeypatch.setattr(res.os, "open", fake_open)
    monkeypatch.setattr(res.os, "close", lambda fd: None)
    assert res.detect_gpus() == 2
    assert res.visible_gpu_ids() == [0, 1]
    assert sorted(opened) == ["/dev/nvidia12", "/dev/nvidia12",
                              "/dev/nvidia7", "/dev/nvidia7"]


def test_no_dev_directory(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)

    def gone(d):
        raise FileNotFoundError(d)

    monkeypatch.setattr(res.os, "listdir", gone)
    assert res.detect_gpus() == 0


def test_probe_never_touches_torch_cuda(monkeypatch):
    """Counting GPUs must not create a CUDA context: every torch.cuda
    entry point the probe could reach raises here."""
    def boom(*a, **k):
        raise AssertionError("the probe called into torch.cuda")

    for name in ("is_available", "device_count", "init", "get_device_name",
                 "current_device", "is_initialized"):
        monkeypatch.setattr(torch.cuda, name, boom)
    monkeypatch.setattr(nv.subprocess, "run", _smi("NVIDIA H100 80GB HBM3"))
    for env in ("0,1", None):
        if env is None:
            monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        else:
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", env)
        res.detect_gpus()
        res.node_resources_from_env(num_cpus=1)
        acc.detect_additional_resources()


def test_request_validation():
    mgr = nv.NvidiaGPUAcceleratorManager()
    for ok in (0.0, 0.25, 0.5, 1.0, 2.0, 8.0):
        assert mgr.validate_resource_request_quantity(ok) is None, ok
    assert "whole cards" in mgr.validate_resource_request_quantity(1.5)
    assert "negative" in mgr.validate_resource_request_quantity(-1.0)


def test_visibility_env():
    mgr = nv.NvidiaGPUAcceleratorManager()
    assert mgr.get_visibility_env([0, 1]) == {"CUDA_VISIBLE_DEVICES": "0,1"}
    assert mgr.get_visibility_env([]) == {"CUDA_VISIBLE_DEVICES": ""}


def test_managers_registry():
    mgrs = acc.get_all_accelerator_managers()
    assert [m.resource_name for m in mgrs] == ["GPU"]
    assert isinstance(mgrs[0], acc.AcceleratorManager)


def test_cpu_worker_env_hides_the_card():
    nm = importlib.import_module(f"{PORT}.core.node_manager")
    env = nm.cpu_worker_env({"CUDA_VISIBLE_DEVICES": "0", "PATH": os.defpath})
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert "JAX_PLATFORMS" not in env
