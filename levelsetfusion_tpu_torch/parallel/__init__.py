"""The voxel-block sharded solvers on ``torch.distributed``. Twin of
``levelsetfusion_tpu/parallel``: the 1D sync solver, the 2D-mesh sync
solver, the Schur and Schur-2D solvers and the hierarchical sharded
solve."""

from levelsetfusion_tpu_torch.parallel.hierarchical import solve_hierarchical_sharded
from levelsetfusion_tpu_torch.parallel.mesh import (
    Group,
    Mesh2D,
    close_group,
    init_group,
    make_mesh_2d,
)
from levelsetfusion_tpu_torch.parallel.schur import SchurResult, solve_single_level_schur
from levelsetfusion_tpu_torch.parallel.schur2d import solve_single_level_schur2d
from levelsetfusion_tpu_torch.parallel.sharded import (
    solve_single_level_sharded,
    warp_field_sharded,
)
from levelsetfusion_tpu_torch.parallel.sharded2d import (
    solve_single_level_sharded2d,
    warp_field_sharded2d,
)

__all__ = [
    "Group",
    "Mesh2D",
    "SchurResult",
    "close_group",
    "init_group",
    "make_mesh_2d",
    "solve_hierarchical_sharded",
    "solve_single_level_schur",
    "solve_single_level_schur2d",
    "solve_single_level_sharded",
    "solve_single_level_sharded2d",
    "warp_field_sharded",
    "warp_field_sharded2d",
]
