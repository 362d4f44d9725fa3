from levelsetfusion_tpu_torch.models.params import SolverParams, solver_params_from_jax
from levelsetfusion_tpu_torch.models.single_level import SolveResult, solve_single_level

__all__ = ["SolverParams", "solver_params_from_jax", "solve_single_level", "SolveResult"]
