"""Numerics sanitizers and the sharded solvers' live-halo contract. Twin of
``levelsetfusion_tpu/utils/debug.py``.

Three NaN/Inf layers, cheapest first:

- ``validate_solve(result)``: post hoc, checks a solve's telemetry and warp
  and raises ``NonFiniteError`` naming the first non-finite telemetry
  iteration (JAX's message and rule).
- ``nan_checks()``: a context in which ``models.single_level.SolveLoop``
  runs its serial loop, one iteration at a time with no CUDA graph, checks
  each iteration's telemetry and new warp with ``torch.isfinite`` and
  raises ``NonFiniteError`` naming the iteration (JAX's ``jax_debug_nans``
  re-runs the op un-jitted). It gives the iterations of the graph loop, at
  one host read an iteration; the CLI's ``--check-nans``.
- ``tap_finite(x, name)``: logs when ``x`` holds a NaN or Inf and returns
  ``x``, never raising. It reads ``x`` on the host, so it refuses to run
  while a CUDA graph is being captured.

``check_displacement_contract`` is the live-halo half of JAX's guard: the
port's resample has no ±K clamp, so the clamp half has no counterpart.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

_log = logging.getLogger("levelsetfusion_tpu_torch.debug")

_nan_checks = [False]  # the mode nan_checks() sets, read by SolveLoop


class NonFiniteError(RuntimeError):
    pass


class DisplacementContractError(RuntimeError):
    pass


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def validate_solve(result, name: str = "solve") -> None:
    """Raise NonFiniteError if a solve produced NaN/Inf anywhere, naming the
    first non-finite telemetry iteration."""
    tel = result.telemetry
    n = int(result.iterations) if hasattr(result, "iterations") else None
    for field in tel._fields:
        arr = _host(getattr(tel, field))
        arr = arr[:n] if n is not None else arr
        bad = ~np.isfinite(arr)
        if bad.any():
            it = int(np.argmax(bad))
            raise NonFiniteError(
                f"{name}: telemetry '{field}' non-finite from iteration {it}"
                " — learning rate too high for the energy's stiffness?"
            )
    if not bool(torch.isfinite(torch.as_tensor(result.warp)).all()):
        raise NonFiniteError(f"{name}: warp field contains non-finite values")


def nan_checks_enabled() -> bool:
    """Whether ``nan_checks()`` is in force."""
    return _nan_checks[0]


@contextlib.contextmanager
def nan_checks():
    """Run every ``SolveLoop`` solve in the scope serially, checked each
    iteration (see the module docstring); the previous mode on exit."""
    prev = _nan_checks[0]
    _nan_checks[0] = True
    try:
        yield
    finally:
        _nan_checks[0] = prev


def tap_finite(x: torch.Tensor, name: str) -> torch.Tensor:
    """Log an error if ``x`` has NaN/Inf (with the largest finite |x|);
    returns ``x``, so it can be inserted inline."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"tap_finite({name!r}) reads the host: not inside a CUDA graph "
                           "capture")
    finite = torch.isfinite(x)
    ok, worst = torch.stack([finite.all().to(x.dtype),
                             torch.amax(torch.where(finite, torch.abs(x), 0.0))]).tolist()
    if not ok:
        _log.error("non-finite values in %s (max |finite part| %s)", name, worst)
    return x


def check_displacement_contract(result, *, live_halo: int, sharded_axes: tuple = (0,),
                                name: str = "solve", error: bool = False) -> list:
    """Compare a solve's measured max |u| along each sharded axis with the
    sharded solvers' live-halo contract: past ``live_halo - 2`` slices from
    a block's face the resample reads the +1 fill beyond the halo, silently.
    Returns the violation messages (JAX's), each also logged as a warning;
    with ``error`` raises DisplacementContractError instead."""
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
    if violations and error:
        raise DisplacementContractError("; ".join(violations))
    return violations
