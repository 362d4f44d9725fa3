"""The warp solve, by the definitions the configuration files state.

Fields are (X, Y, Z); the warp is component-major (3, X, Y, Z), component
c along axis c, in voxels. With ``w`` the live field resampled at
``v + u(v)`` (trilinear, +1 outside the volume):

- ``∇w`` by np.gradient (central differences, one-sided at the edges); the
  band: voxels where |canonical| or |w| < 1 - 1e-5;
- data: ``E = ½ Σ_band (w - c)²``, gradient ``(w - c) ∇w`` on the band;
- Killing: ``E = ½ Σ (½ ‖J + Jᵀ‖² + γ ‖J‖²)``, gradient
  ``-(1 + γ) Δu - ∇(∇·u)``; Tikhonov: ``E = ½ Σ ‖J‖²``, gradient ``-Δu``
  (J by np.gradient; Δ the 1, -2, 1 stencil with replicated edges);
- level set: ``E = ½ Σ_band (‖∇w‖ - 1)²``, gradient
  ``(‖∇w‖ - 1) / (‖∇w‖ + 1e-5) H(w) ∇w`` on the band, H = ∇(∇w);
- the weighted sum, then the Sobolev filter (the central column of
  ``(I - λ L)⁻¹`` on ``size`` taps, unit sum) along x, y, z with zero
  padding; ``u ← u - rate g``.

The loop runs rounds of k iterations (k = 1: every iteration): after each
round the rate halves where the round's last total energy (of the warp it
started from) exceeds the previous round's, and the solve stops once
``max_iterations`` (rounded up to k) ran or the round's last longest update
is below the threshold. Each term's energy is summed in float64 in the
float32 reference and rounded to float32; the total is their float32 sum.
Where two rounds' energies lie within rounding of each other either
halving decision is sound: ``flip`` takes one round's the other way, and
``margins`` says how close each decision was.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

EPS_BAND = 1e-5
EPS_LS = 1e-5


class Params(NamedTuple):
    learning_rate: float
    max_iterations: int
    threshold: float
    w_data: float
    w_smooth: float
    w_ls: float
    killing: bool
    gamma: float
    taps: tuple  # () without the filter
    adaptive: bool
    k: int


def params(solver: dict, rounds: bool) -> Params:
    """A configuration file's ``solver``; ``rounds``: the sharded solve's
    rounds of ``termination_check_interval`` iterations (else 1)."""
    taps = ()
    if solver["sobolev_smoothing"]:
        taps = sobolev_taps(solver["sobolev_kernel_size"], solver["sobolev_strength"])
    return Params(solver["learning_rate"], solver["max_iterations"],
                  solver["convergence_threshold"], solver["data_term_weight"],
                  solver["smoothing_term_weight"], solver["level_set_term_weight"],
                  solver["smoothing_mode"] == "killing",
                  solver["rigidity_enforcement_factor"], taps,
                  solver["adaptive_learning_rate"],
                  solver["termination_check_interval"] if rounds else 1)


def sobolev_taps(size: int, strength: float) -> tuple:
    lap = -2.0 * np.eye(size) + np.eye(size, k=1) + np.eye(size, k=-1)
    delta = np.zeros(size)
    delta[size // 2] = 1.0
    col = np.linalg.solve(np.eye(size) - strength * lap, delta)
    return tuple(float(v) for v in (col / col.sum()).astype(np.float32))


def grad(f: torch.Tensor, axis: int) -> torch.Tensor:
    n = f.shape[axis]
    out = torch.empty_like(f)
    out.narrow(axis, 1, n - 2).copy_((f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) * 0.5)
    out.narrow(axis, 0, 1).copy_(f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1))
    out.narrow(axis, n - 1, 1).copy_(f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1))
    return out


def laplacian(f: torch.Tensor) -> torch.Tensor:
    out = -6.0 * f
    for axis in range(3):
        n = f.shape[axis]
        out.narrow(axis, 1, n - 1).add_(f.narrow(axis, 0, n - 1))
        out.narrow(axis, 0, 1).add_(f.narrow(axis, 0, 1))
        out.narrow(axis, 0, n - 1).add_(f.narrow(axis, 1, n - 1))
        out.narrow(axis, n - 1, 1).add_(f.narrow(axis, n - 1, 1))
    return out


def smooth(f: torch.Tensor, taps: tuple) -> torch.Tensor:
    """Same-size convolution with ``taps`` along each axis, zero padding."""
    r = len(taps) // 2
    for axis in range(3):
        n = f.shape[axis]
        out = f * taps[r]
        for k in range(1, min(r, n - 1) + 1):
            out.narrow(axis, 0, n - k).add_(f.narrow(axis, k, n - k), alpha=taps[r - k])
            out.narrow(axis, k, n - k).add_(f.narrow(axis, 0, n - k), alpha=taps[r + k])
        f = out
    return f


SLAB_VOXELS = 1 << 23  # voxels a slab of the resample's temporaries holds


def resample(field: torch.Tensor, warp: torch.Tensor) -> torch.Tensor:
    """``field`` at ``v + warp(v)``, trilinear, +1 outside the volume (in
    slabs of x rows, so that 512³ fits beside the solve)."""
    X, Y, Z = field.shape
    slab = max(1, SLAB_VOXELS // (Y * Z))
    dev, dt = field.device, field.dtype
    flat = field.reshape(-1)
    one = torch.ones((), dtype=dt, device=dev)
    out = torch.empty_like(field)
    jy = torch.arange(Y, device=dev, dtype=dt).view(1, Y, 1)
    kz = torch.arange(Z, device=dev, dtype=dt).view(1, 1, Z)
    for x0 in range(0, X, slab):
        x1 = min(X, x0 + slab)
        ix = torch.arange(x0, x1, device=dev, dtype=dt).view(-1, 1, 1)
        pos = (ix + warp[0, x0:x1], jy + warp[1, x0:x1], kz + warp[2, x0:x1])
        base = [torch.floor(p) for p in pos]
        frac = [p - b for p, b in zip(pos, base)]
        base = [b.long() for b in base]
        acc = None
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    idx = [base[0] + cx, base[1] + cy, base[2] + cz]
                    w = ((frac[0] if cx else 1.0 - frac[0]) * (frac[1] if cy else 1.0 - frac[1])
                         * (frac[2] if cz else 1.0 - frac[2]))
                    inside = ((idx[0] >= 0) & (idx[0] < X) & (idx[1] >= 0) & (idx[1] < Y)
                              & (idx[2] >= 0) & (idx[2] < Z))
                    flat_idx = ((idx[0].clamp(0, X - 1) * Y + idx[1].clamp(0, Y - 1)) * Z
                                + idx[2].clamp(0, Z - 1))
                    term = w * torch.where(inside, flat[flat_idx], one)
                    acc = term if acc is None else acc + term
        out[x0:x1] = acc
    return out


def _sum(x: torch.Tensor) -> float:
    acc = torch.float64 if x.dtype == torch.float32 else x.dtype
    return torch.sum(x, dtype=acc)


def step(canonical, live, u, rate, p: Params):
    """One iteration: (new warp, total energy of ``u``, longest update)."""
    w = resample(live, u)
    wg = [grad(w, a) for a in range(3)]
    band = (torch.abs(canonical) < 1 - EPS_BAND) | (torch.abs(w) < 1 - EPS_BAND)
    diff = torch.where(band, w - canonical, torch.zeros_like(w))
    terms = [p.w_data * 0.5 * _sum(diff * diff)]
    g = [p.w_data * diff * wg[c] for c in range(3)]
    del diff
    if p.w_smooth:
        sym = full = 0.0
        for c in range(3):
            for d in range(3):
                j_cd = grad(u[c], d)
                full = full + _sum(j_cd * j_cd)
                if c == d:
                    sym = sym + 4.0 * _sum(j_cd * j_cd)
                elif c < d:
                    s = j_cd + grad(u[d], c)
                    sym = sym + 2.0 * _sum(s * s)
                del j_cd
        if p.killing:
            terms.append(p.w_smooth * 0.5 * (0.5 * sym + p.gamma * full))
            div = grad(u[0], 0) + grad(u[1], 1) + grad(u[2], 2)
            for c in range(3):
                g[c] += p.w_smooth * (-(1.0 + p.gamma) * laplacian(u[c]) - grad(div, c))
            del div
        else:
            terms.append(p.w_smooth * 0.5 * full)
            for c in range(3):
                g[c] -= p.w_smooth * laplacian(u[c])
    if p.w_ls:
        norm = torch.sqrt(wg[0] * wg[0] + wg[1] * wg[1] + wg[2] * wg[2])
        terms.append(p.w_ls * 0.5 * _sum(
            torch.where(band, (norm - 1.0) ** 2, torch.zeros_like(norm))))
        scale = torch.where(band, (norm - 1.0) / (norm + EPS_LS), torch.zeros_like(norm))
        del norm
        for i in range(3):
            h = grad(wg[i], 0) * wg[0] + grad(wg[i], 1) * wg[1] + grad(wg[i], 2) * wg[2]
            g[i] += p.w_ls * scale * h
            del h
    del wg, band, w
    if p.taps:
        g = [smooth(gc, p.taps) for gc in g]
    # Each term's energy in the configuration's precision, then their sum in
    # it: the energy the rate's halving compares.
    energy = terms[0].to(u.dtype)
    for term in terms[1:]:
        energy = energy + term.to(u.dtype)
    upd = torch.stack(g).mul_(-rate)
    longest = torch.sqrt(torch.sum(upd * upd, dim=0)).max()
    return u + upd, energy, longest


class Solution(NamedTuple):
    warp: torch.Tensor  # (3, X, Y, Z)
    iterations: int
    # Each round's total energy, and the relative margin of its halving
    # decision, |energy - previous| / |previous| (inf in the first round).
    energies: tuple = ()
    margins: tuple = ()


def solve(canonical, live, p: Params, initial=None, dtype=torch.float32,
          flip: int | None = None) -> Solution:
    """The solve of ``live`` onto ``canonical`` from ``initial`` (component
    major, else zeros), all computed in ``dtype``; round ``flip``'s halving
    decision taken the other way."""
    canonical, live = canonical.to(dtype), live.to(dtype)
    u = (torch.zeros((3, *canonical.shape), dtype=dtype, device=canonical.device)
         if initial is None else initial.to(dtype).clone())
    k = max(1, p.k)
    n_iter = -(-p.max_iterations // k) * k
    thr = torch.tensor(p.threshold, dtype=torch.float32).to(dtype).item()
    rate = torch.tensor(p.learning_rate, dtype=dtype, device=u.device)
    prev = math.inf
    it, longest = 0, math.inf
    energies, margins = [], []
    while it < n_iter and longest >= thr:
        for _ in range(k):
            u, energy, top = step(canonical, live, u, rate, p)
            it += 1
        energy, longest = float(energy), float(top)
        margins.append(abs(energy - prev) / abs(prev) if math.isfinite(prev) else math.inf)
        if p.adaptive:
            if (energy > prev) != (len(energies) == flip):
                rate = rate * 0.5
            prev = energy
        energies.append(energy)
    return Solution(u, it, tuple(energies), tuple(margins))


def blend(canonical, weights, warped):
    """The fusion's running weighted average: a voxel of the warped live
    field counts where |w| < 1 - 1e-5."""
    w_live = (torch.abs(warped) < 1 - EPS_BAND).to(warped.dtype)
    total = weights + w_live
    fused = torch.where(total > 0,
                        (weights * canonical + w_live * warped) / torch.clamp(total, min=1e-12),
                        canonical)
    return fused, total


def first_state(field):
    return field, (torch.abs(field) < 1 - EPS_BAND).to(field.dtype)
