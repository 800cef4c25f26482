"""Accelerator managers (counterpart of python/ray/_private/accelerators/).

The reference ships one AcceleratorManager per vendor (nvidia/amd/intel
GPU, TPU, neuron, hpu, npu — accelerator.py ABC). The port needs exactly
one real manager — the NVIDIA GPU — plus the ABC so other accelerators
can plug in; CPU needs no manager (cpu_count is core logic).
"""

from ray_tpu_torch.accelerators.accelerator import AcceleratorManager
from ray_tpu_torch.accelerators.nvidia_gpu import NvidiaGPUAcceleratorManager

_MANAGERS = [NvidiaGPUAcceleratorManager()]


def get_all_accelerator_managers():
    return list(_MANAGERS)


def register_accelerator_manager(mgr: AcceleratorManager) -> None:
    _MANAGERS.append(mgr)


def detect_additional_resources() -> dict:
    """All managers' extra node resources (accelerator_type markers)."""
    out = {}
    for mgr in _MANAGERS:
        try:
            out.update(mgr.get_additional_resources())
        except Exception:
            pass
    return out


__all__ = [
    "AcceleratorManager",
    "NvidiaGPUAcceleratorManager",
    "get_all_accelerator_managers",
    "register_accelerator_manager",
    "detect_additional_resources",
]
