"""The voxel-block sharded solvers on ``torch.distributed``. Twin of
``levelsetfusion_tpu/parallel``: its 1D sync solver. The 2D-mesh, Schur and
hierarchical sharded solvers are not ported yet (ROADMAP A12)."""

from levelsetfusion_tpu_torch.parallel.mesh import Group, close_group, init_group
from levelsetfusion_tpu_torch.parallel.sharded import (
    solve_single_level_sharded,
    warp_field_sharded,
)

__all__ = [
    "Group",
    "close_group",
    "init_group",
    "solve_single_level_sharded",
    "warp_field_sharded",
]
