"""Dataset registry. Twin of ``levelsetfusion_tpu/io/datasets.py``.

Experiment runners select a depth sequence by name. The synthetic entries
are generated on the fly (``io/synthetic.py``) and held in memory. The
disk-backed entry, ``depth_directory``, reads a directory of 16-bit depth
PNGs (``io/depth.py``) with a calibration file: ``intrinsics.json`` or a
Snoopy/KillingFusion-style text file (``load_snoopy_calib``). Its
``frame_source`` is the native prefetcher (``io/native_loader.py``) where
the native decoder is there, else a lazy per-frame decode.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List

import numpy as np

from levelsetfusion_tpu_torch.core.camera import PinholeCamera
from levelsetfusion_tpu_torch.io import native_loader, synthetic
from levelsetfusion_tpu_torch.io.depth import load_depth_png


@dataclasses.dataclass
class SequenceDataset:
    """A depth sequence + camera, the unit every experiment consumes: the
    frames in memory, or the paths of their PNGs (``_paths``)."""

    name: str
    camera: PinholeCamera
    frames: List[np.ndarray] = dataclasses.field(default_factory=list)
    _paths: List[str] | None = None

    def __len__(self) -> int:
        return len(self.frames) if self.frames else len(self._paths or [])

    def frame(self, t: int) -> np.ndarray:
        if self.frames:
            return self.frames[t]
        return load_depth_png(self._paths[t])

    def frame_source(self, start: int = 0):
        """Sized iterable of frames from ``start``, for ``fuse_sequence``.

        A disk-backed sequence gives a ``DepthPrefetcher`` where the native
        decoder is there (frames t + 1 .. decode on background threads while
        the device solves frame t, each handed over as a pinned float32
        tensor), else ``_LazyFrames`` (numpy frames decoded one at a time).
        In-memory sequences give their list."""
        if self._paths:
            paths = self._paths[start:]
            if native_loader.native_available() and paths:
                width, height, _ = native_loader.png_info(paths[0])
                return native_loader.DepthPrefetcher(paths, width=width, height=height)
            return _LazyFrames(paths)
        return self.frames[start:]


class _LazyFrames:
    """The frame source without the native decoder: sized, ordered,
    decode-on-demand (numpy frames)."""

    def __init__(self, paths):
        self._paths = paths

    def __len__(self):
        return len(self._paths)

    def __iter__(self):
        for p in self._paths:
            yield load_depth_png(p)


_REGISTRY: Dict[str, Callable[..., SequenceDataset]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def names() -> List[str]:
    return sorted(_REGISTRY)


def get(name: str, **kw) -> SequenceDataset:
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; available: {names()}")
    return _REGISTRY[name](**kw)


@register("synthetic_blob_pair")
def synthetic_blob_pair(width: int = 64, height: int = 64, **kw) -> SequenceDataset:
    canonical, live, cam = synthetic.blob_pair_3d(width, height, **kw)
    return SequenceDataset("synthetic_blob_pair", cam, [canonical, live])


@register("synthetic_snoopy")
def synthetic_snoopy(num_frames: int = 8, width: int = 64, height: int = 64,
                     **kw) -> SequenceDataset:
    seq = synthetic.snoopy_style_sequence_3d(num_frames, width, height, **kw)
    return SequenceDataset("synthetic_snoopy", seq.camera, list(seq.frames))


def _intrinsic_matrix(rows: List[List[float]], path: str) -> dict:
    """fx, fy, cx, cy of the first three bare numeric rows, accepted only
    as a 3x3 intrinsic matrix: rows of exactly 3 values, K[1,0] = K[2,0] =
    K[2,1] = 0, K[2,2] = 1, fx > 0 and fy > 0 (cx and cy are not bounded by
    the image: principal points off the image are legal)."""
    if len(rows) < 3:
        raise ValueError(f"{path}: no fx/fy/cx/cy keys and no 3x3 matrix found")
    k = rows[:3]
    if any(len(r) != 3 for r in k):
        raise ValueError(f"{path}: the matrix rows hold {[len(r) for r in k]} values, not 3 "
                         "each (a 4x4 pose before the intrinsics?)")
    if k[1][0] != 0 or k[2][0] != 0 or k[2][1] != 0 or k[2][2] != 1:
        raise ValueError(f"{path}: {k} is not an intrinsic matrix "
                         "(needs K[1,0] = K[2,0] = K[2,1] = 0 and K[2,2] = 1)")
    if not (k[0][0] > 0 and k[1][1] > 0):
        raise ValueError(f"{path}: fx = {k[0][0]}, fy = {k[1][1]} must be positive")
    return {"fx": k[0][0], "fy": k[1][1], "cx": k[0][2], "cy": k[1][2]}


def load_snoopy_calib(path: str) -> dict:
    """Parse a Snoopy/KillingFusion-style text calibration file into
    {fx, fy, cx, cy[, width, height]}.

    Two layouts are accepted:

    - key-value lines: ``fx 570.3`` / ``fy: 570.3`` / ``ImageSize 640 480``
      (keys case-insensitive; ``cx``/``cy`` aka ``px``/``py``);
    - a whitespace 3x3 intrinsic matrix, its rows the first three lines
      that are all numbers: K[0,0] = fx, K[1,1] = fy, K[0,2] = cx,
      K[1,2] = cy, filling the keys the file does not give.

    JAX's parser takes the first 9 bare numbers of the file as K; this one
    accepts the matrix layout only where it reads as one
    (``_intrinsic_matrix``) and raises ``ValueError`` otherwise. For every
    file JAX parses correctly it returns the same dict.
    """
    keys: dict = {}
    rows: list = []
    with open(path) as f:
        for line in f:
            tokens = line.replace(":", " ").replace(",", " ").split()
            if not tokens:
                continue
            head = tokens[0].lower()
            vals = []
            for t in tokens[1:]:
                try:
                    vals.append(float(t))
                except ValueError:
                    pass
            if head in ("fx", "fy", "cx", "cy", "px", "py") and vals:
                keys[{"px": "cx", "py": "cy"}.get(head, head)] = vals[0]
            elif head in ("imagesize", "image_size", "size") and len(vals) >= 2:
                keys["width"], keys["height"] = int(vals[0]), int(vals[1])
            elif head in ("width", "height") and vals:
                keys[head] = int(vals[0])
            else:
                # A bare numeric row (matrix layout), all or nothing.
                try:
                    rows.append([float(t) for t in tokens])
                except ValueError:
                    continue
    if not {"fx", "fy", "cx", "cy"} <= set(keys):
        for key, value in _intrinsic_matrix(rows, path).items():
            keys.setdefault(key, value)
    return keys


_CALIB_CANDIDATES = (
    "intrinsics.json",
    "snoopy_calib.txt",
    "calibration.txt",
    "calib.txt",
)


@register("depth_directory")
def depth_directory(path: str = "", pattern: str = "depth_{:06d}.png",
                    calib: str | None = None, **kw) -> SequenceDataset:
    """Snoopy-style on-disk sequence: depth PNGs named ``pattern`` from
    frame 0 up to the first missing one, and a calibration file, either
    ``intrinsics.json`` ({fx, fy, cx, cy, width, height}) or a text file
    (``load_snoopy_calib``), found in ``_CALIB_CANDIDATES`` order unless
    ``calib`` names one. The image size falls back to the first frame's
    shape when the calibration omits it."""
    if calib is None:
        for cand in _CALIB_CANDIDATES:
            if os.path.exists(os.path.join(path, cand)):
                calib = cand
                break
        else:
            raise FileNotFoundError(
                f"no calibration file in {path!r} (looked for "
                f"{', '.join(_CALIB_CANDIDATES)})"
            )
    calib_path = os.path.join(path, calib)
    if calib.endswith(".json"):
        with open(calib_path) as f:
            intr = json.load(f)
    else:
        intr = load_snoopy_calib(calib_path)
    if "width" not in intr or "height" not in intr:
        probe = load_depth_png(os.path.join(path, pattern.format(0)))
        intr.setdefault("height", probe.shape[0])
        intr.setdefault("width", probe.shape[1])
    cam = PinholeCamera(
        fx=intr["fx"], fy=intr["fy"], cx=intr["cx"], cy=intr["cy"],
        image_width=intr["width"], image_height=intr["height"],
    )
    paths = []
    t = 0
    while os.path.exists(p := os.path.join(path, pattern.format(t))):
        paths.append(p)
        t += 1
    return SequenceDataset(f"depth_directory:{path}", cam, [], paths)
