"""Observability plane: metrics, tracing, flight recorder, ops journal and
device telemetry, each process-local; and the placement-group API with
its scheduling strategies, exported here as the reference's `util`
exports them (its client, actor pool and queue are not ported yet)."""

from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "PlacementGroup",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
]
