"""The 2D warp solve of the scanline experiments, by the definitions the
configuration states.

Fields are (X, Z); the warp is component-major (2, X, Z), component c along
axis c, in voxels. With ``w`` the live field resampled at ``v + u(v)``
(bilinear; a corner outside the field reads +1):

- ``∇w`` by np.gradient (central differences, one-sided at the edges); the
  band: voxels where |canonical| or |w| < 1 - 1e-5;
- data: ``E = ½ Σ_band (w - c)²``, gradient ``(w - c) ∇w`` on the band;
- Tikhonov: ``E = ½ Σ ‖J‖²`` (J by np.gradient), gradient ``-Δu`` (the
  1, -2, 1 stencil along each axis with replicated edges);
- ``u ← u - rate g`` for the weighted sum ``g``, at a fixed rate.

The solve stops once ``max_iterations`` ran or the last iteration's longest
update ‖rate g‖ is below the threshold rounded to float32; the first
iteration always runs. The configuration states no level-set term, no
Sobolev filter, no halving of the rate and no Killing term, and ``params``
refuses a configuration that states one. Each energy is summed in float64
in the float32 reference and rounded to float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference.solver import EPS_BAND, _sum, grad


class Params(NamedTuple):
    learning_rate: float
    max_iterations: int
    threshold: float
    w_data: float
    w_smooth: float


def params(solver: dict) -> Params:
    """A configuration file's ``solver``, refused where it states a term or
    a rule this solve does not follow."""
    stated = {
        "level_set_term_weight": solver["level_set_term_weight"] != 0.0,
        "sobolev_smoothing": bool(solver["sobolev_smoothing"]),
        "adaptive_learning_rate": bool(solver["adaptive_learning_rate"]),
        "smoothing_mode": solver["smoothing_mode"] != "tikhonov",
        "band_union_only": not solver["band_union_only"],
    }
    refused = [key for key, bad in stated.items() if bad]
    if refused:
        raise ValueError(f"the 2D reference follows data + Tikhonov at a fixed rate on the "
                         f"band union; the configuration states {refused}")
    return Params(solver["learning_rate"], solver["max_iterations"],
                  solver["convergence_threshold"], solver["data_term_weight"],
                  solver["smoothing_term_weight"])


def laplacian(f: torch.Tensor) -> torch.Tensor:
    """The 1, -2, 1 stencil along both axes of (X, Z), replicated edges."""
    out = -4.0 * f
    for axis in range(2):
        n = f.shape[axis]
        out.narrow(axis, 1, n - 1).add_(f.narrow(axis, 0, n - 1))
        out.narrow(axis, 0, 1).add_(f.narrow(axis, 0, 1))
        out.narrow(axis, 0, n - 1).add_(f.narrow(axis, 1, n - 1))
        out.narrow(axis, n - 1, 1).add_(f.narrow(axis, n - 1, 1))
    return out


def resample(field: torch.Tensor, warp: torch.Tensor) -> torch.Tensor:
    """``field`` (X, Z) at ``v + warp(v)``, bilinear, +1 outside."""
    X, Z = field.shape
    dev, dt = field.device, field.dtype
    one = torch.ones((), dtype=dt, device=dev)
    pos = (torch.arange(X, device=dev, dtype=dt).view(X, 1) + warp[0],
           torch.arange(Z, device=dev, dtype=dt).view(1, Z) + warp[1])
    base = [torch.floor(p) for p in pos]
    frac = [p - b for p, b in zip(pos, base)]
    base = [b.long() for b in base]
    acc = None
    for cx in (0, 1):
        for cz in (0, 1):
            i, k = base[0] + cx, base[1] + cz
            w = (frac[0] if cx else 1.0 - frac[0]) * (frac[1] if cz else 1.0 - frac[1])
            inside = (i >= 0) & (i < X) & (k >= 0) & (k < Z)
            term = w * torch.where(inside, field[i.clamp(0, X - 1), k.clamp(0, Z - 1)], one)
            acc = term if acc is None else acc + term
    return acc


def step(canonical, live, u, rate, p: Params):
    """One iteration: (new warp, (data, Tikhonov) energies of ``u``, each
    weighted, longest update)."""
    w = resample(live, u)
    wg = [grad(w, a) for a in range(2)]
    band = (torch.abs(canonical) < 1 - EPS_BAND) | (torch.abs(w) < 1 - EPS_BAND)
    diff = torch.where(band, w - canonical, torch.zeros_like(w))
    g = [p.w_data * diff * wg[c] for c in range(2)]
    jac = sum(_sum(grad(u[c], a) ** 2) for c in range(2) for a in range(2))
    energy = torch.stack([(p.w_data * 0.5 * _sum(diff * diff)).to(u.dtype),
                          (p.w_smooth * 0.5 * jac).to(u.dtype)])
    if p.w_smooth:
        for c in range(2):
            g[c] = g[c] - p.w_smooth * laplacian(u[c])
    upd = torch.stack(g).mul_(-rate)
    longest = torch.sqrt(torch.sum(upd * upd, dim=0)).max()
    return u + upd, energy, longest


class Solution(NamedTuple):
    warp: torch.Tensor  # (2, X, Z)
    iterations: int
    energies: torch.Tensor  # (iterations, 2): each iteration's data and Tikhonov energy


def solve(canonical, live, p: Params, dtype=torch.float32) -> Solution:
    """The solve of ``live`` onto ``canonical`` from a zero warp, all
    computed in ``dtype``."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 is float32 here
    torch.backends.cudnn.allow_tf32 = False
    canonical, live = canonical.to(dtype), live.to(dtype)
    u = torch.zeros((2, *canonical.shape), dtype=dtype, device=canonical.device)
    thr = torch.tensor(p.threshold, dtype=torch.float32).to(dtype).item()
    rate = torch.tensor(p.learning_rate, dtype=dtype, device=u.device)
    it, longest, energies = 0, math.inf, []
    while it < p.max_iterations and longest >= thr:
        u, energy, top = step(canonical, live, u, rate, p)
        energies.append(energy)
        longest = float(top)
        it += 1
    return Solution(u, it, torch.stack(energies))
