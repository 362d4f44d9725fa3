"""The sharded solvers' live-halo contract. Twin of
``levelsetfusion_tpu/utils/debug.py::check_displacement_contract``, its
live-halo half on the sharded axes (axis 0 on the 1D mesh, axes 0 and 1 on
the 2D mesh): the port's resample has no ±K clamp, so the clamp half has no
counterpart. ``validate_solve`` and the NaN checks come with the
rest of the utilities (ROADMAP A10b).
"""

from __future__ import annotations

import logging

_log = logging.getLogger("levelsetfusion_tpu_torch.debug")


def check_displacement_contract(result, *, live_halo: int, sharded_axes: tuple = (0,),
                                name: str = "solve") -> list:
    """Compare a solve's measured max |u| along each sharded axis with the
    sharded solvers' live-halo contract: past ``live_halo - 2`` slices from
    a block's face the resample reads the +1 fill beyond the halo, silently.
    Returns the violation messages (JAX's), each also logged as a
    warning."""
    md = [float(v) for v in result.max_abs_displacement]
    limit = live_halo - 2
    violations = []
    for ax in sharded_axes:
        if md[ax] > limit:
            violations.append(
                f"{name}: max |u[{ax}]| = {md[ax]:.3f} exceeds the "
                f"sharded halo contract live_halo−2 = {limit} — "
                "cross-block resample reads returned truncation fill. "
                "Raise live_halo or use solve_hierarchical_sharded."
            )
    for message in violations:
        _log.warning(message)
    return violations
