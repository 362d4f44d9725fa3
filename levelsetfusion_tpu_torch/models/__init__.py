from levelsetfusion_tpu_torch.models.hierarchical import HierarchicalResult, solve_hierarchical
from levelsetfusion_tpu_torch.models.params import (
    HierarchicalParams,
    SolverParams,
    solver_params_from_jax,
)
from levelsetfusion_tpu_torch.models.rigid import Sdf2SdfResult, solve_rigid_2d, solve_rigid_3d
from levelsetfusion_tpu_torch.models.single_level import SolveResult, solve_single_level

__all__ = [
    "SolverParams",
    "HierarchicalParams",
    "solver_params_from_jax",
    "solve_single_level",
    "SolveResult",
    "solve_hierarchical",
    "HierarchicalResult",
    "Sdf2SdfResult",
    "solve_rigid_2d",
    "solve_rigid_3d",
]
