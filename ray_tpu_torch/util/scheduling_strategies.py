"""Copy of ray_tpu/util/scheduling_strategies.py.

Scheduling strategies (counterpart of python/ray/util/scheduling_strategies.py).

Passed as ``scheduling_strategy=`` to @remote tasks/actors.  The control
plane's scheduler (core/gcs.py _pick_node) interprets them; the default is
the hybrid pack-then-spread policy mirroring the reference's
HybridSchedulingPolicy (raylet/scheduling/policy/hybrid_scheduling_policy.h:50).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class NodeAffinitySchedulingStrategy:
    """Pin to a node. soft=True allows fallback to any feasible node."""

    node_id: str
    soft: bool = False


@dataclass
class NodeLabelSchedulingStrategy:
    """Schedule by node labels (reference node-label policy,
    raylet/scheduling/policy/node_label_scheduling_policy.h).

    ``hard`` labels MUST all match — the task stays pending until a
    matching node has capacity; ``soft`` labels prefer matching nodes
    but fall back to the hard-matching set, e.g. hard={"slice": name}
    co-locates work with the nodes that carry that label."""

    hard: Optional[Dict[str, str]] = None
    soft: Optional[Dict[str, str]] = None


@dataclass
class PlacementGroupSchedulingStrategy:
    """Run inside a reserved placement-group bundle."""

    placement_group: object  # PlacementGroup handle
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


SPREAD = "SPREAD"
DEFAULT = "DEFAULT"
