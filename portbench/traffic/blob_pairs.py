"""A pool of canonical/live blob-on-wall depth pairs (the mix's
``camera``, ``wall_depth``, ``blob_radius_px``, ``blob_height``, ``pool``,
``shift_px`` and ``height_scale``). Every seed gets the same pairs: shifts
and height scales evenly spaced over the mix's ranges, directions evenly
spaced around the circle, each pair its own triple. The seed orders them,
so that seeds change the order and not the work."""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from portbench.lib.traffic import blob_depth, camera, rng


class Pair(NamedTuple):
    canonical: np.ndarray  # (H, W) metres
    live: np.ndarray
    shift_px: float
    angle: float
    height_scale: float


def generate(mix: dict, seed: int) -> List[Pair]:
    """The pool of pairs, in the order the window sends them."""
    cam = camera(mix["camera"])
    n = int(mix["pool"])
    shifts = np.linspace(*mix["shift_px"], n)
    # Scales and directions run through their ranges at strides prime to
    # n, so that no pair takes the largest of all three.
    scales = np.linspace(*mix["height_scale"], n)[(np.arange(n) * 5) % n]
    angles = 2.0 * np.pi * ((np.arange(n) * 7) % n) / n
    order = rng(seed).permutation(n)
    center = (cam.width / 2.0, cam.height / 2.0)
    pool = []
    for i in order:
        canonical = blob_depth(cam, mix["wall_depth"], center, mix["blob_radius_px"],
                               mix["blob_height"])
        live_center = (center[0] + shifts[i] * np.cos(angles[i]),
                       center[1] + shifts[i] * np.sin(angles[i]))
        live = blob_depth(cam, mix["wall_depth"], live_center, mix["blob_radius_px"],
                          mix["blob_height"] * scales[i])
        pool.append(Pair(canonical, live, float(shifts[i]), float(angles[i]),
                         float(scales[i])))
    return pool
