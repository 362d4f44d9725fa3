"""Typed solver parameter objects. Twin of ``levelsetfusion_tpu/models/params.py``.

The JAX twin's four TPU fast-path fields (``use_pallas_resample``,
``pallas_max_displacement``, ``use_pallas_gradient``, ``pallas_interpret``)
have no counterpart: here the device of the tensors decides whether the
CUDA kernels run, and the resample kernel is exact for any displacement.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from levelsetfusion_tpu_torch.ops.gradient import SmoothingMode

__all__ = ["HierarchicalParams", "SmoothingMode", "SolverParams", "solver_params_from_jax"]

# SolverParams fields of the JAX twin that only steer its TPU kernels.
JAX_ONLY_FIELDS = (
    "use_pallas_resample",
    "pallas_max_displacement",
    "use_pallas_gradient",
    "pallas_interpret",
)


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Single-level non-rigid warp-solver parameters."""

    learning_rate: float = 0.1
    max_iterations: int = 100
    # Terminate when the longest per-voxel warp update (voxel units) drops
    # below this.
    convergence_threshold: float = 0.01
    data_term_weight: float = 1.0
    smoothing_term_weight: float = 0.2
    level_set_term_weight: float = 0.0
    smoothing_mode: SmoothingMode = SmoothingMode.TIKHONOV
    rigidity_enforcement_factor: float = 0.1
    sobolev_smoothing: bool = False
    sobolev_kernel_size: int = 7
    sobolev_strength: float = 0.1
    band_union_only: bool = True
    # Halve the rate whenever the total energy increases between iterations.
    adaptive_learning_rate: bool = False
    # The sharded solver (parallel/sharded.py) runs rounds of k iterations
    # with one global termination check each, so it may run up to k - 1
    # iterations past the gate; the single-level solve checks every
    # iteration whatever k.
    termination_check_interval: int = 1

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)

    @property
    def sobolev_radius(self) -> int:
        """Sobolev filter radius (0 when the filter is off)."""
        return self.sobolev_kernel_size // 2 if self.sobolev_smoothing else 0

    @property
    def stencil_halo(self) -> int:
        """Ghost rows one iteration of the sharded solver needs a side of
        the sharded axis: the stencils' 2 (central differences, Hessian)
        and the Sobolev filter's radius."""
        return 2 + self.sobolev_radius


@dataclasses.dataclass(frozen=True)
class HierarchicalParams:
    """Coarse-to-fine solver parameters."""

    levels: int = 3
    # Per-level solve settings; max_iterations applies at every level.
    base: SolverParams = SolverParams(
        max_iterations=50, convergence_threshold=0.001, sobolev_smoothing=True
    )

    def replace(self, **kw) -> "HierarchicalParams":
        return dataclasses.replace(self, **kw)


def solver_params_from_jax(d) -> SolverParams:
    """The port's ``SolverParams`` from a JAX ``SolverParams``, given as the
    dataclass itself or as a dict (``dataclasses.asdict`` or a run's
    ``config.json``); the TPU-only fields are dropped and
    ``smoothing_mode`` may be the enum's string value."""
    if dataclasses.is_dataclass(d):
        d = {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}
    s = {k: v for k, v in d.items() if k not in JAX_ONLY_FIELDS}
    mode = s.get("smoothing_mode")
    if mode is not None and not isinstance(mode, SmoothingMode):
        s["smoothing_mode"] = SmoothingMode(getattr(mode, "value", mode))
    return SolverParams(**s)

