"""Typed experiment configuration. Twin of ``levelsetfusion_tpu/utils/config.py``.

One dataclass covers every experiment mode; the JAX package's presets are
carried as data, without the TPU-only solver fields (see
``models/params.py``). Configs serialize to and from JSON, and
``from_dict`` also reads a JAX run's ``config.json``. The CLI runs every
single-device mode (configs 1–4 and the two rigid presets) and refuses the
sharded ones (config5) by name.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from levelsetfusion_tpu_torch.models.params import (
    SmoothingMode,
    SolverParams,
    solver_params_from_jax,
)
from levelsetfusion_tpu_torch.ops.tsdf import GenerationMethod


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    # "single_pair_2d" | "hierarchical_2d" | "single_pair_3d" |
    # "multi_frame_3d" | "multi_frame_sharded_3d" | "sharded_3d" |
    # "hierarchical_sharded_3d" | "rigid_2d" | "rigid_3d"
    mode: str
    grid_shape: Tuple[int, ...] = (96, 48)
    voxel_size: float = 0.004
    grid_offset: Tuple[int, ...] = (-48, 85)
    narrow_band_width_voxels: int = 20
    generation_method: GenerationMethod = GenerationMethod.BASIC
    dataset: str = "synthetic"
    dataset_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    solver: SolverParams = SolverParams()
    levels: int = 3
    pyramid_method: str = "block_mean"
    num_frames: int = 4
    checkpoint_every: int = 0
    num_devices: Optional[int] = None
    mesh_shape: Optional[Tuple[int, int]] = None
    live_halo: int = 8
    solver_kind: str = "sync"
    schur_inner_iterations: int = 8

    def to_json(self) -> str:
        def default(o):
            if hasattr(o, "value"):
                return o.value
            return str(o)

        return json.dumps(dataclasses.asdict(self), indent=2, default=default)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ExperimentConfig":
        """From a dict as ``to_json`` writes it — the port's or a JAX run's
        ``config.json`` (whose TPU-only solver fields are dropped)."""
        d = dict(d)
        if isinstance(d.get("generation_method"), str):
            d["generation_method"] = GenerationMethod(d["generation_method"])
        if isinstance(d.get("solver"), dict):
            d["solver"] = solver_params_from_jax(d["solver"])
        for key in ("grid_shape", "grid_offset", "mesh_shape"):
            if d.get(key) is not None:
                d[key] = tuple(d[key])
        return ExperimentConfig(**d)

    @staticmethod
    def from_json(text: str) -> "ExperimentConfig":
        return ExperimentConfig.from_dict(json.loads(text))


def _solver_2d(**kw) -> SolverParams:
    base = dict(learning_rate=1.0, convergence_threshold=1e-3, max_iterations=200)
    base.update(kw)
    return SolverParams(**base)


def _solver_3d(**kw) -> SolverParams:
    # 3D explicit-GD stability: rate*weight*λmax < 2, λmax ≈ 26.
    base = dict(
        learning_rate=0.5,
        smoothing_term_weight=0.1,
        convergence_threshold=1e-3,
        max_iterations=120,
        adaptive_learning_rate=True,
    )
    base.update(kw)
    return SolverParams(**base)


# The JAX package's presets (levelsetfusion_tpu/utils/config.py, where each
# carries its rationale), less the TPU-only solver fields.
PRESETS: Dict[str, ExperimentConfig] = {
    "config1_2d_pair": ExperimentConfig(
        name="config1_2d_pair",
        mode="single_pair_2d",
        grid_shape=(96, 48),
        grid_offset=(-48, 85),
        solver=_solver_2d(max_iterations=600),
    ),
    "config2_2d_hierarchical": ExperimentConfig(
        name="config2_2d_hierarchical",
        mode="hierarchical_2d",
        grid_shape=(96, 64),
        grid_offset=(-48, 75),
        levels=3,
        solver=_solver_2d(max_iterations=60, sobolev_smoothing=True),
        dataset_kwargs={"live_shift_px": 8.0},
        pyramid_method="ewa_depth",
    ),
    # 3D dense 128³ single pair with the full energy: data + Killing +
    # level set + Sobolev.
    "config3_3d_full_energy": ExperimentConfig(
        name="config3_3d_full_energy",
        mode="single_pair_3d",
        grid_shape=(128, 128, 128),
        voxel_size=0.004,
        grid_offset=(-64, -64, 75),
        solver=_solver_3d(
            smoothing_mode=SmoothingMode.KILLING,
            level_set_term_weight=0.1,
            sobolev_smoothing=True,
            max_iterations=1200,
        ),
    ),
    "config4_3d_fusion": ExperimentConfig(
        name="config4_3d_fusion",
        mode="multi_frame_3d",
        grid_shape=(128, 128, 128),
        voxel_size=0.004,
        grid_offset=(-64, -64, 75),
        num_frames=8,
        checkpoint_every=2,
        solver=_solver_3d(smoothing_mode=SmoothingMode.KILLING, max_iterations=80),
        dataset_kwargs={"width": 96, "height": 96},
    ),
    "config5_sharded": ExperimentConfig(
        name="config5_sharded",
        mode="sharded_3d",
        grid_shape=(128, 64, 128),
        voxel_size=0.008,
        grid_offset=(-64, -32, 38),
        solver=_solver_3d(max_iterations=320),
        live_halo=8,
    ),
    "config5_sharded_schur": ExperimentConfig(
        name="config5_sharded_schur",
        mode="sharded_3d",
        grid_shape=(128, 64, 128),
        voxel_size=0.008,
        grid_offset=(-64, -32, 38),
        solver=_solver_3d(max_iterations=320, adaptive_learning_rate=False),
        live_halo=8,
        solver_kind="schur",
        schur_inner_iterations=8,
    ),
    "config5_2dmesh": ExperimentConfig(
        name="config5_2dmesh",
        mode="sharded_3d",
        grid_shape=(128, 64, 128),
        voxel_size=0.008,
        grid_offset=(-64, -32, 38),
        solver=_solver_3d(max_iterations=320),
        live_halo=8,
        mesh_shape=(2, 4),
    ),
    "config5_512": ExperimentConfig(
        name="config5_512",
        mode="sharded_3d",
        grid_shape=(512, 512, 512),
        voxel_size=0.004,
        grid_offset=(-256, -256, 38),
        solver=_solver_3d(max_iterations=32,
                          smoothing_mode=SmoothingMode.KILLING,
                          level_set_term_weight=0.1,
                          sobolev_smoothing=True,
                          termination_check_interval=4),
        live_halo=8,
    ),
    "config5_hierarchical": ExperimentConfig(
        name="config5_hierarchical",
        mode="hierarchical_sharded_3d",
        grid_shape=(128, 64, 128),
        voxel_size=0.008,
        grid_offset=(-64, -32, 38),
        levels=3,
        dataset_kwargs={"live_shift_px": 10.0},
        solver=_solver_3d(max_iterations=200),
        live_halo=11,
    ),
    "config5_schur2d": ExperimentConfig(
        name="config5_schur2d",
        mode="sharded_3d",
        grid_shape=(128, 64, 128),
        voxel_size=0.008,
        grid_offset=(-64, -32, 38),
        solver=_solver_3d(max_iterations=320, adaptive_learning_rate=False),
        live_halo=8,
        mesh_shape=(2, 4),
        solver_kind="schur2d",
        schur_inner_iterations=8,
    ),
    "rigid_2d": ExperimentConfig(
        name="rigid_2d",
        mode="rigid_2d",
        grid_shape=(96, 48),
        grid_offset=(-48, 85),
    ),
    "rigid_3d": ExperimentConfig(
        name="rigid_3d",
        mode="rigid_3d",
        grid_shape=(32, 32, 24),
        voxel_size=0.008,
        grid_offset=(-16, -16, 42),
    ),
}
