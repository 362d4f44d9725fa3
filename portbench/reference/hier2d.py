"""The coarse-to-fine 2D warp solve of the scanline experiments, by the
definitions the configuration states: depth pyramids of both scanlines,
the warp solved at the coarsest level, then at each finer level from the
coarser level's warp prolongated, and the finest live field resampled by the
finest warp.

Grids and pyramids. Level 0 is the configuration's grid; level l + 1 halves
each extent, doubles the voxel and puts the offset at ``(o + 0.5) / 2``, so
that it covers the same region; its band is ``max(nb // 2, 2)`` voxels for
level l's ``nb``. Level 0's TSDF is ``tsdf2d.py``'s (BASIC, nearest pixel).
A coarser level's is the EWA average of the depth over the voxel's image
footprint: with ``u = fx x / z + cx`` and ``c`` its nearest pixel (half to
even), the taps ``p = c + k`` for k in [-3, 3], each weighted
``exp(-½ (p - u)² / var_u)``, ``var_u = (fx / z)² (voxel / 2)² + 0.25``;
a tap is valid where it lies in the scanline and sees a depth > 0; the
depth ``d`` is the valid taps' weighted mean (their weight floored at
1e-12), and the TSDF ``clip((d - z) / (nb / 2 · voxel), -1, 1)``; +1 where
z ≤ 1e-4 or no tap is valid.

A level's solve is ``solver2d.py``'s step (the same resample, gradient,
band, data and Tikhonov terms, at a fixed rate) with the Sobolev filter
applied to the weighted gradient: the taps of ``solver.py::sobolev_taps``,
a same-size convolution along x and then along z with zero padding. It
starts from the warm start (zeros at the coarsest level) and stops as
``solver2d.solve`` does. The warm start of level l from level l + 1's warp
(component-major (2, X, Z), in voxels): output voxel i of each axis samples
the coarse warp at ``(i + 0.5) / 2 - 0.5`` clamped to [0, n - 1],
bilinearly, and the values are doubled, since the voxels halve.

Departures from Algomorph/LevelSetFusion-Python's ``HierarchicalOptimizer2d``
(``nonrigid_opt/hierarchical/hierarchical_optimizer2d.py``), as that code's
survey in SURVEY.md (§2.10, §3.2) describes it:

- its coarse levels are 2x downsamplings of the finest TSDF; here each is a
  TSDF regenerated from the depth on the coarsened grid with EWA, as the
  configuration's ``pyramid_method`` ("ewa_depth") states;
- it may bound each level's iterations and update threshold apart; the
  configuration states one solver for every level (≤ 60 iterations, gate
  1e-3, data + Tikhonov 0.2 with the 7-tap Sobolev filter at 0.1);
- the warp is prolongated x2 bilinearly in both, at the sample positions
  and edge clamp stated above;
- no energy is computed: at a fixed rate none decides anything.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch

from portbench.reference import solver2d, tsdf2d
from portbench.reference.solver import EPS_BAND, grad, sobolev_taps

EWA_RADIUS = 3
SCREEN_VARIANCE = 0.25
WEIGHT_FLOOR = 1e-12


class Level(NamedTuple):
    shape: tuple
    voxel_size: float
    offset: tuple
    band_voxels: int


def levels(shape, voxel_size: float, offset, band_voxels: int, n: int) -> List[Level]:
    """The pyramid's grids, finest first."""
    out = [Level(tuple(shape), voxel_size, tuple(offset), band_voxels)]
    for _ in range(n - 1):
        s, v, o, b = out[-1]
        out.append(Level(tuple(e // 2 for e in s), 2 * v, tuple((x + 0.5) / 2 for x in o),
                         max(b // 2, 2)))
    return out


def ewa(depth: torch.Tensor, cam, level: Level, dtype=torch.float32) -> torch.Tensor:
    """The EWA TSDF of ``depth`` ((W,) metres) on ``level``'s grid."""
    dev = depth.device
    depth = depth.to(dtype)
    X, Z = level.shape
    band = 0.5 * level.band_voxels * level.voxel_size
    x = ((torch.arange(X, dtype=dtype, device=dev) + level.offset[0]) * level.voxel_size)
    z = ((torch.arange(Z, dtype=dtype, device=dev) + level.offset[1]) * level.voxel_size)
    x, z = torch.broadcast_tensors(x.view(X, 1), z.view(1, Z))
    front = z > tsdf2d.NEAR
    zs = torch.where(front, z, torch.ones_like(z))
    u = cam.fx * x / zs + cam.cx
    centre = torch.round(u).long()
    var = (cam.fx / zs) ** 2 * (0.5 * level.voxel_size) ** 2 + SCREEN_VARIANCE
    num = torch.zeros_like(z)
    weight = torch.zeros_like(z)
    valid_taps = torch.zeros(z.shape, dtype=torch.int64, device=dev)
    for k in range(-EWA_RADIUS, EWA_RADIUS + 1):
        p = centre + k
        d = depth[p.clamp(0, cam.width - 1)]
        valid = (p >= 0) & (p < cam.width) & (d > 0)
        w = torch.where(valid, torch.exp(-0.5 * (p.to(dtype) - u) ** 2 / var),
                        torch.zeros_like(z))
        num = num + w * d
        weight = weight + w
        valid_taps += valid.long()
    mean = num / torch.clamp(weight, min=WEIGHT_FLOOR)
    value = torch.clamp((mean - z) / band, -1.0, 1.0)
    return torch.where(front & (valid_taps > 0), value, torch.ones_like(value))


def pyramid(depth: torch.Tensor, cam, grids: List[Level], dtype=torch.float32):
    """The scanline's TSDFs, finest first: BASIC at level 0, EWA above."""
    out = []
    for i, g in enumerate(grids):
        if i == 0:
            out.append(tsdf2d.generate(depth, cam, g.shape, g.voxel_size, g.offset,
                                       g.band_voxels, dtype))
        else:
            out.append(ewa(depth, cam, g, dtype))
    return out


def prolongate(warp: torch.Tensor, shape) -> torch.Tensor:
    """A (2, X, Z) warp at the next finer level's ``shape``: bilinear at
    ``(i + 0.5) / 2 - 0.5`` clamped to the edge, values doubled."""
    out = warp
    for axis in range(2):
        n, m = out.shape[axis + 1], shape[axis]
        dt, dev = out.dtype, out.device
        pos = ((torch.arange(m, dtype=torch.float64, device=dev) + 0.5) / 2 - 0.5).clamp(0, n - 1)
        lo = torch.floor(pos).long()
        hi = (lo + 1).clamp(max=n - 1)
        frac = (pos - lo).to(dt)
        view = [1, 1, 1]
        view[axis + 1] = m
        frac = frac.view(view)
        a, b = out.index_select(axis + 1, lo), out.index_select(axis + 1, hi)
        out = a * (1 - frac) + b * frac
    return 2 * out


def smooth(f: torch.Tensor, taps: tuple) -> torch.Tensor:
    """Same-size convolution of an (X, Z) field with ``taps`` along x, then
    along z, zero padding."""
    r = len(taps) // 2
    for axis in range(2):
        n = f.shape[axis]
        out = f * taps[r]
        for k in range(1, min(r, n - 1) + 1):
            out.narrow(axis, 0, n - k).add_(f.narrow(axis, k, n - k), alpha=taps[r - k])
            out.narrow(axis, k, n - k).add_(f.narrow(axis, 0, n - k), alpha=taps[r + k])
        f = out
    return f


class Params(NamedTuple):
    learning_rate: float
    max_iterations: int
    threshold: float
    w_data: float
    w_smooth: float
    taps: tuple  # () without the filter


def params(solver: dict) -> Params:
    """A configuration file's ``solver``, refused where it states a term or
    a rule this solve does not follow (the Sobolev filter it follows)."""
    flat = solver2d.params({**solver, "sobolev_smoothing": False})
    taps = ()
    if solver["sobolev_smoothing"]:
        taps = sobolev_taps(solver["sobolev_kernel_size"], solver["sobolev_strength"])
    return Params(flat.learning_rate, flat.max_iterations, flat.threshold, flat.w_data,
                  flat.w_smooth, taps)


def step(canonical, live, u, rate, p: Params):
    """One iteration: (new warp, longest update)."""
    w = solver2d.resample(live, u)
    wg = [grad(w, a) for a in range(2)]
    band = (torch.abs(canonical) < 1 - EPS_BAND) | (torch.abs(w) < 1 - EPS_BAND)
    diff = torch.where(band, w - canonical, torch.zeros_like(w))
    g = [p.w_data * diff * wg[c] for c in range(2)]
    if p.w_smooth:
        g = [g[c] - p.w_smooth * solver2d.laplacian(u[c]) for c in range(2)]
    if p.taps:
        g = [smooth(g[c], p.taps) for c in range(2)]
    upd = torch.stack(g).mul_(-rate)
    longest = torch.sqrt(torch.sum(upd * upd, dim=0)).max()
    return u + upd, longest


def solve_level(canonical, live, p: Params, warm: torch.Tensor | None):
    """(warp, iterations) of one level from ``warm`` (else zeros)."""
    u = torch.zeros((2, *canonical.shape), dtype=canonical.dtype, device=canonical.device) \
        if warm is None else warm
    thr = torch.tensor(p.threshold, dtype=torch.float32).to(canonical.dtype).item()
    rate = torch.tensor(p.learning_rate, dtype=canonical.dtype, device=u.device)
    it, longest = 0, math.inf
    while it < p.max_iterations and longest >= thr:
        u, top = step(canonical, live, u, rate, p)
        longest = float(top)
        it += 1
    return u, it


class Solution(NamedTuple):
    canonical: List[torch.Tensor]  # the pyramids, finest first
    live: List[torch.Tensor]
    warp: torch.Tensor  # (2, X, Z), the finest level's
    warped: torch.Tensor  # the finest live field resampled by it
    iterations: List[int]  # a level's, coarsest first


def solve(canonical_depth, live_depth, cam, grids: List[Level], p: Params,
          dtype=torch.float32) -> Solution:
    """The hierarchical solve of the live scanline onto the canonical one,
    all computed in ``dtype``."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 is float32 here
    torch.backends.cudnn.allow_tf32 = False
    canon = pyramid(canonical_depth, cam, grids, dtype)
    live = pyramid(live_depth, cam, grids, dtype)
    warp, iterations = None, []
    for level in reversed(range(len(grids))):
        if warp is not None:
            warp = prolongate(warp, grids[level].shape)
        warp, its = solve_level(canon[level], live[level], p, warp)
        iterations.append(its)
    return Solution(canon, live, warp, solver2d.resample(live[0], warp), iterations)
