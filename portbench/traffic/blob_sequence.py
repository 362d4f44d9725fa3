"""One period of a depth sequence: a blob on a wall moving back and forth
(``travel_px`` at ``step_px`` a frame) along a seeded direction, its radius
pulsing by ``pulse``, stored as 16-bit depth in the mix's unit (a count of
``depth_unit_m``, 0 invalid). A sequence repeats the period."""

from __future__ import annotations

from typing import List

import numpy as np

from portbench.lib.traffic import blob_depth, camera, rng


def offset(t: int, mix: dict) -> float:
    """The blob's displacement (pixels) along the direction at frame t:
    from -travel/2 out to +travel/2 and back, ``step_px`` a frame."""
    half = int(mix["period"]) // 2
    k = t % int(mix["period"])
    steps = k if k <= half else 2 * half - k
    return -0.5 * mix["travel_px"] + mix["step_px"] * steps


def generate(mix: dict, seed: int) -> List[np.ndarray]:
    """The period's frames as stored depth (uint16)."""
    cam = camera(mix["camera"])
    period = int(mix["period"])
    angle = rng(seed).uniform(0.0, 2.0 * np.pi)
    frames = []
    for t in range(period):
        d = offset(t, mix)
        center = (cam.width / 2.0 + d * np.cos(angle), cam.height / 2.0 + d * np.sin(angle))
        radius = mix["blob_radius_px"] * (1.0 + mix["pulse"] * np.sin(2 * np.pi * t / period))
        depth = blob_depth(cam, mix["wall_depth"], center, radius, mix["blob_height"])
        raw = np.clip(np.round(depth / mix["depth_unit_m"]), 0, 65535).astype(np.uint16)
        frames.append(raw)
    return frames
