"""A pool of canonical/live bump-on-a-wall depth scanlines, the pair of
``cli.py::_pair_2d`` made into a pool (the mix's ``camera`` width,
``wall_depth``, ``bump_radius_px``, ``bump_height``, ``bump_center_px``,
``pool``, ``shift_px`` and ``height_scale``). Every seed gets the same
pairs: the live bump's shifts evenly spaced over the mix's range with the
sign alternating, so that half the pairs move each way, and its height
scales evenly spaced at a stride prime to the pool. The seed orders them,
so that seeds change the order and not the work."""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from portbench.lib.traffic import rng


class Pair(NamedTuple):
    canonical: np.ndarray  # (W,) metres
    live: np.ndarray
    shift_px: float
    height_scale: float


def bump_row(width: int, wall_depth: float, center: float, radius_px: float,
             height: float) -> np.ndarray:
    """Depth scanline (metres, float32) of a wall with a cos² bump: a frozen
    copy of ``io/synthetic.py::bump_wall_pair_2d``'s rows."""
    d = (np.arange(width, dtype=np.float32) - center) / radius_px
    bump = np.where(np.abs(d) < 1.0, height * np.cos(0.5 * np.pi * d) ** 2, 0.0)
    return (wall_depth - bump).astype(np.float32)


def generate(mix: dict, seed: int) -> List[Pair]:
    """The pool of pairs, in the order the window sends them."""
    width, n = int(mix["camera"]["width"]), int(mix["pool"])
    signs = np.where(np.arange(n) % 2, -1.0, 1.0)
    shifts = signs * np.linspace(*mix["shift_px"], n)
    scales = np.linspace(*mix["height_scale"], n)[(np.arange(n) * 5) % n]
    center = float(mix["bump_center_px"])
    canonical = bump_row(width, mix["wall_depth"], center, mix["bump_radius_px"],
                         mix["bump_height"])
    pool = []
    for i in rng(seed).permutation(n):
        live = bump_row(width, mix["wall_depth"], center + shifts[i], mix["bump_radius_px"],
                        mix["bump_height"] * scales[i])
        pool.append(Pair(canonical.copy(), live, float(shifts[i]), float(scales[i])))
    return pool
