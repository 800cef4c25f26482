"""The parallelism layer: meshes of torch.distributed ranks
(`mesh.py`) and the collectives run over their axes (`comm.py`).

Port of ray_tpu/parallel/.  So far the `data` and `seq` axes, whose
params stay replicated, and the logical sharding rules with fsdp
placement (`sharding.py`); tensor placement, the pipeline and expert
all_to_all wait for later slices (ROADMAP.md, Queue A items 6b-6d).
"""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    Mesh,
    MeshConfig,
    build_mesh,
    canonical_axis,
    current_mesh,
    local_mesh_info,
    mesh_shape,
    one_process_mesh,
    single_axis_mesh,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    NamedSharding,
    PartitionSpec,
    data_sharding,
    infer_logical_axes,
    replicated,
    shard_tree,
    spec_from_logical,
    tree_shardings,
)
