"""NVIDIA GPU accelerator manager: count, card type, visibility.

Counterpart of the reference's python/ray/_private/accelerators/
nvidia_gpu.py (NvidiaGPUAcceleratorManager), standing where the JAX
package has its TPU manager.  Detection never initializes CUDA: the count
comes from CUDA_VISIBLE_DEVICES or the device nodes
(core/resources.py detect_gpus), the type from `nvidia-smi`, which talks
to the driver through NVML and opens no CUDA context.
"""

from __future__ import annotations

import re
import subprocess
from typing import Dict, List, Optional

from ray_tpu_torch.accelerators.accelerator import AcceleratorManager
from ray_tpu_torch.core.resources import detect_gpus

# "NVIDIA H100 80GB HBM3" -> "H100", as upstream's NVIDIA_GPU_NAME_PATTERN.
_NAME_PATTERN = re.compile(r"\w+\s+([A-Z0-9]+)")


def _query_card_name(timeout: float = 5.0) -> Optional[str]:
    """The first visible card's name from nvidia-smi, None when the tool
    is absent, fails or names nothing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    names = [line.strip() for line in out.stdout.splitlines() if line.strip()]
    return names[0] if names else None


class NvidiaGPUAcceleratorManager(AcceleratorManager):
    resource_name = "GPU"

    def get_num_accelerators(self) -> int:
        return detect_gpus()

    def get_accelerator_type(self) -> Optional[str]:
        """The card's type, e.g. "H100" (upstream's short form of the
        name nvidia-smi reports), or None when no card or tool is
        found."""
        name = _query_card_name()
        if not name:
            return None
        m = _NAME_PATTERN.match(name)
        return m.group(1) if m else name.replace(" ", "_")

    def get_additional_resources(self) -> Dict[str, float]:
        """`accelerator_type:<type>` = 1 on a node with a card (the
        reference's marker for accelerator_type= placement)."""
        if not self.get_num_accelerators():
            return {}
        acc_type = self.get_accelerator_type()
        if not acc_type:
            return {}
        return {f"accelerator_type:{acc_type}": 1.0}

    def get_visibility_env(self, ids: List[int]) -> Dict[str, str]:
        return {"CUDA_VISIBLE_DEVICES": ",".join(str(i) for i in ids)}

    def validate_resource_request_quantity(self, quantity: float
                                           ) -> Optional[str]:
        if quantity < 0:
            return f"GPU requests must not be negative (got {quantity})"
        if quantity > 1 and quantity != int(quantity):
            return ("GPU requests above one must be whole cards "
                    f"(got {quantity}); only a share of one card may be "
                    "fractional")
        return None
