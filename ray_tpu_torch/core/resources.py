"""Resource model: named resource vectors with fractional amounts.

Counterpart of the reference's ResourceSet / NodeResources
(src/ray/common/scheduling/cluster_resource_data.h) with FixedPoint
arithmetic (fixed_point.h): amounts are stored as integer ten-thousandths so
fractional resources (0.5 CPU) compose exactly.

``GPU`` is a first-class resource alongside CPU/memory, and a node with a
card also exposes an ``accelerator_type:<name>`` marker, as the
reference's Python-side NVIDIA accelerator manager does
(python/ray/_private/accelerators/nvidia_gpu.py).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Union

GRANULARITY = 10_000  # fixed-point denominator

CPU = "CPU"
GPU = "GPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"


def _to_fixed(amount: float) -> int:
    return round(amount * GRANULARITY)


def _from_fixed(units: int) -> float:
    return units / GRANULARITY


class ResourceSet:
    """Immutable-ish mapping of resource name -> fixed-point amount."""

    __slots__ = ("_units",)

    def __init__(self, amounts: Mapping[str, float] | None = None, _units=None):
        if _units is not None:
            self._units: Dict[str, int] = {k: v for k, v in _units.items() if v > 0}
        else:
            self._units = {
                k: _to_fixed(v) for k, v in (amounts or {}).items() if v > 0
            }

    def to_dict(self) -> Dict[str, float]:
        return {k: _from_fixed(v) for k, v in self._units.items()}

    def get(self, name: str) -> float:
        return _from_fixed(self._units.get(name, 0))

    def is_empty(self) -> bool:
        return not self._units

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(other._units.get(k, 0) >= v for k, v in self._units.items())

    def fit_count(self, need: "ResourceSet") -> int:
        """How many disjoint copies of `need` fit inside this set."""
        if not need._units:
            return 1 << 30
        return min(self._units.get(k, 0) // v
                   for k, v in need._units.items())

    def add(self, other: "ResourceSet") -> "ResourceSet":
        units = dict(self._units)
        for k, v in other._units.items():
            units[k] = units.get(k, 0) + v
        return ResourceSet(_units=units)

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        units = dict(self._units)
        for k, v in other._units.items():
            units[k] = units.get(k, 0) - v
            if units[k] < 0:
                raise ValueError(
                    f"Resource {k} would go negative: {self.to_dict()} - {other.to_dict()}"
                )
        return ResourceSet(_units=units)

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and other._units == self._units

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"

    def __reduce__(self):
        return (ResourceSet, (self.to_dict(),))


def node_resources_from_env(num_cpus=None, num_gpus=None, extra=None) -> ResourceSet:
    """Detect this host's resources (CPU count, the GPUs this process may
    use, and the card's ``accelerator_type:<name>`` marker)."""
    amounts: Dict[str, float] = {}
    amounts[CPU] = float(num_cpus if num_cpus is not None else os.cpu_count() or 1)
    if num_gpus is None:
        num_gpus = detect_gpus()
    if num_gpus:
        amounts[GPU] = float(num_gpus)
        try:
            from ray_tpu_torch.accelerators import detect_additional_resources

            amounts.update(detect_additional_resources())
        except Exception:
            pass
    if extra:
        amounts.update(extra)
    return ResourceSet(amounts)


_DEV_NODE = re.compile(r"nvidia[0-9]+")


def _usable_device_nodes() -> List[str]:
    """The /dev/nvidia<N> nodes this process may open.  A container can
    list nodes its device cgroup denies (a one-card machine may show
    /dev/nvidia0, refused with EPERM, beside the card's own node), so a
    node counts only when it opens.  Opening the node file creates no
    CUDA context: that takes the driver's ioctls, which only the CUDA
    runtime issues."""
    try:
        names = sorted(e for e in os.listdir("/dev") if _DEV_NODE.fullmatch(e))
    except OSError:
        return []
    usable = []
    for name in names:
        try:
            fd = os.open(os.path.join("/dev", name), os.O_RDWR)
        except OSError:
            continue
        os.close(fd)
        usable.append(name)
    return usable


def visible_gpu_ids() -> List[Union[int, str]]:
    """The GPU ids this process sees: the entries of CUDA_VISIBLE_DEVICES
    (ints where they parse, UUIDs as given; empty means none), else one
    logical id per usable device node.  Never imports torch and never
    initializes CUDA: a driver that has not touched the card must not
    take a context (about 0.5 GB of its memory) by calling init()."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        ids = [c.strip() for c in env.split(",") if c.strip()]
        return [int(c) if c.isdigit() else c for c in ids]
    return list(range(len(_usable_device_nodes())))


def detect_gpus() -> int:
    """Count the GPUs this process may use without initializing CUDA
    (counterpart of the reference's TPU chip probe, which counts device
    nodes rather than importing jax): CUDA_VISIBLE_DEVICES first, then
    the /dev/nvidia<N> nodes that open."""
    return len(visible_gpu_ids())
