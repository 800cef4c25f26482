"""Copy of ray_tpu/util/placement_group.py.

Placement group API (counterpart of python/ray/util/placement_group.py).

placement_group() reserves resource bundles across nodes through the control
plane (reference: GCS PG manager + raylet 2PC Prepare/CommitBundleResources);
tasks/actors opt in via PlacementGroupSchedulingStrategy.

Only this docstring's accelerator wording differs from the reference's:
a GPU trainer asks for one bundle per worker ({"CPU": 1, "GPU": 1}); the
demand's "GPU" makes the worker that fills the bundle GPU-class
(core/gcs.py `_env_key_for`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.ids import ObjectID, PlacementGroupID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.runtime import get_runtime

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    """Handle to a reserved (or pending) placement group."""

    def __init__(self, pg_hex: str, bundles: List[Dict[str, float]],
                 ready_obj_hex: str = ""):
        self._pg_hex = pg_hex
        self._bundles = bundles
        self._ready_obj_hex = ready_obj_hex

    @property
    def id(self):
        return PlacementGroupID.from_hex(self._pg_hex)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def ready(self) -> ObjectRef:
        """ObjectRef that resolves to True once all bundles are reserved."""
        return ObjectRef(ObjectID.from_hex(self._ready_obj_hex))

    def wait(self, timeout_seconds: Optional[float] = 30) -> bool:
        """Block until all bundles are reserved. Defaults to a 30 s bound
        (matching the reference util/placement_group.py wait); pass None to
        wait indefinitely."""
        deadline = (None if timeout_seconds is None
                    else time.monotonic() + timeout_seconds)
        rt = get_runtime()
        while True:
            st = rt.kv().call({"op": "pg_state", "pg": self._pg_hex})
            if st is not None and st["state"] == "CREATED":
                return True
            if st is not None and st["state"] == "REMOVED":
                return False
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.02)

    def state(self) -> Optional[dict]:
        return get_runtime().kv().call({"op": "pg_state", "pg": self._pg_hex})

    def __reduce__(self):
        return (PlacementGroup,
                (self._pg_hex, self._bundles, self._ready_obj_hex))

    def __repr__(self):
        return f"PlacementGroup({self._pg_hex[:8]}, {len(self._bundles)} bundles)"


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    rt = get_runtime()
    pg_hex = PlacementGroupID.from_random().hex()
    ready_obj = ObjectID.from_random().hex()
    rt.kv().send({
        "op": "create_pg", "pg": pg_hex,
        "bundles": [dict(b) for b in bundles],
        "strategy": strategy, "ready_obj": ready_obj, "name": name,
    })
    return PlacementGroup(pg_hex, bundles, ready_obj)


def remove_placement_group(pg: PlacementGroup) -> None:
    get_runtime().kv().call({"op": "remove_pg", "pg": pg._pg_hex})


def placement_group_table() -> List[dict]:
    return get_runtime().kv().call({"op": "list_placement_groups"})
