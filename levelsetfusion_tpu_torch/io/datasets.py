"""Dataset registry. Twin of ``levelsetfusion_tpu/io/datasets.py``, the part
the fusion experiment (config4) uses.

Experiment runners select a depth sequence by name. The synthetic entries
are generated on the fly (``io/synthetic.py``) and held in memory. The
disk-backed entry (``depth_directory``: 16-bit depth PNGs with a
calibration file), its PNG decoding and the native prefetcher are not
ported yet (ROADMAP A9) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np

from levelsetfusion_tpu_torch.core.camera import PinholeCamera
from levelsetfusion_tpu_torch.io import synthetic

_NOT_PORTED = "depth PNG sequences are not ported yet (ROADMAP A9)"


@dataclasses.dataclass
class SequenceDataset:
    """A depth sequence + camera, the unit every experiment consumes."""

    name: str
    camera: PinholeCamera
    frames: List[np.ndarray] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.frames)

    def frame(self, t: int) -> np.ndarray:
        return self.frames[t]

    def frame_source(self, start: int = 0):
        """Sized iterable of frames from ``start``, for ``fuse_sequence``."""
        return self.frames[start:]


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


@register("depth_directory")
def depth_directory(path: str = "", **kw) -> SequenceDataset:
    raise NotImplementedError(_NOT_PORTED)


def load_snoopy_calib(path: str) -> dict:
    raise NotImplementedError(_NOT_PORTED)
