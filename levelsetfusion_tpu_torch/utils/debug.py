"""The 1D sharded solver's live-halo contract. Twin of
``levelsetfusion_tpu/utils/debug.py::check_displacement_contract``, its
live-halo half on axis 0: the port's resample has no ±K clamp, so the clamp
half has no counterpart. ``validate_solve`` and the NaN checks come with the
rest of the utilities (ROADMAP A10b).
"""

from __future__ import annotations

import logging

_log = logging.getLogger("levelsetfusion_tpu_torch.debug")


def check_displacement_contract(result, *, live_halo: int, name: str) -> list:
    """Compare a solve's measured max |u| along axis 0 with the sharded
    solver's live-halo contract: past ``live_halo - 2`` rows from a block's
    face the resample reads the +1 fill beyond the halo, silently. Returns
    the violation messages (JAX's), each also logged as a warning."""
    md0 = float(result.max_abs_displacement[0])
    limit = live_halo - 2
    if md0 <= limit:
        return []
    message = (
        f"{name}: max |u[0]| = {md0:.3f} exceeds the "
        f"sharded halo contract live_halo−2 = {limit} — "
        "cross-block resample reads returned truncation fill. "
        "Raise live_halo or use solve_hierarchical_sharded."
    )
    _log.warning(message)
    return [message]
