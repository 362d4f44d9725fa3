"""Traffic generation: a traffic mix is a data file of parameters
(``traffic/<mix>.json``) whose ``generator`` key names a general generator,
found by its file, ``traffic/<generator>.py``, with ``generate(mix, seed)``.
Inputs come from the seed alone; the program receives only what is
generated.

This module holds what the generators share: the depth model, a frozen copy
of ``io/synthetic.py::blob_wall_depth_3d`` (a wall with a radially symmetric
cos² blob), the synthetic camera (``default_camera_3d``: f = W / 2,
principal point at the centre), the seed's generator and 16-bit PNGs.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import List, NamedTuple, Tuple

import numpy as np


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def camera(spec: dict) -> Camera:
    """The synthetic camera of a traffic file's ``camera`` {width, height}."""
    w, h = int(spec["width"]), int(spec["height"])
    f = w / 2.0
    return Camera(f, f, w / 2.0, h / 2.0, w, h)


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The seed's generator (any integer; ``stream`` splits it)."""
    return np.random.default_rng([int(seed) % 2**64, stream])


ROUND_STREAM = 1000  # the seed's generator streams of the rounds' orders start here


class Rounds:
    """The entry of a pool of ``n`` that request i of a closed loop sends:
    every round of ``n`` requests sends each entry once. With the mix's
    ``"reshuffle": true`` each round comes in an order of its own drawn
    from the seed, so that no one order of the pool, repeated all through
    the window, sets what follows what; else each round in the pool's
    order."""

    def __init__(self, n: int, seed: int, reshuffle: bool):
        self.n, self.seed, self.reshuffle = n, seed, reshuffle
        self._round, self._order = -1, None

    def __call__(self, i: int) -> int:
        r, k = divmod(i, self.n)
        if not self.reshuffle:
            return k
        if r != self._round:
            self._round = r
            self._order = rng(self.seed, ROUND_STREAM + r).permutation(self.n)
        return int(self._order[k])


def rounds(mix: dict, seed: int, n: int) -> Rounds:
    """The request order of a pool of ``n`` under the mix's parameters."""
    return Rounds(n, seed, bool(mix.get("reshuffle", False)))


def blob_depth(cam: Camera, wall_depth: float, center: Tuple[float, float],
               radius_px: float, height: float) -> np.ndarray:
    """Depth image (metres, float32) of a wall with a cos² blob."""
    u, v = np.meshgrid(np.arange(cam.width, dtype=np.float32),
                       np.arange(cam.height, dtype=np.float32))
    r = np.sqrt((u - center[0]) ** 2 + (v - center[1]) ** 2) / radius_px
    bump = np.where(r < 1.0, height * np.cos(0.5 * np.pi * r) ** 2, 0.0)
    return (wall_depth - bump).astype(np.float32)


def metres(raw: np.ndarray, unit: float) -> np.ndarray:
    """Stored depth as float32 metres: ``raw * unit`` in float32, as a
    16-bit depth PNG is read."""
    return np.multiply(raw, np.float32(unit), dtype=np.float32)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png16(raw: np.ndarray) -> bytes:
    """A 16-bit greyscale PNG of ``raw`` (uint16, H x W): rows with filter
    byte 0, one IDAT."""
    h, w = raw.shape
    rows = np.zeros((h, 1 + 2 * w), np.uint8)
    rows[:, 1:] = raw.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_sequence(directory: str, frames: List[np.ndarray], cam: Camera) -> List[str]:
    """The frames as PNGs named as ``io/datasets.py::depth_directory`` reads
    them, and an ``intrinsics.json``, in ``directory``; returns the frames'
    paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for t, raw in enumerate(frames):
        path = os.path.join(directory, f"depth_{t:06d}.png")
        with open(path, "wb") as f:
            f.write(png16(raw))
        paths.append(path)
    with open(os.path.join(directory, "intrinsics.json"), "w") as f:
        json.dump({"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy,
                   "width": cam.width, "height": cam.height}, f)
    return paths


def generator(name: str):
    """The generator ``traffic/<name>.py``: its ``generate(mix, seed)``."""
    from portbench.lib.cells import HERE, load_module

    return load_module(HERE / "traffic" / f"{name}.py", f"portbench_traffic_{name}")


def generate(mix: dict, seed: int):
    """The inputs of a traffic file, by the generator its ``generator`` key
    names."""
    return generator(mix["generator"]).generate(mix, seed)
