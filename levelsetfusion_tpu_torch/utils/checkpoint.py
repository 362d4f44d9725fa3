"""Checkpoint / resume of a fusion run. Twin of
``levelsetfusion_tpu/utils/checkpoint.py``, its dense arrays.

A checkpoint is the fusion state after a frame (canonical TSDF, accumulated
weights) and the frame's warp, in JAX's on-disk layout, so that either
package reads the other's: ``<root>/frame_XXXXXX/state.npz`` (arrays
``canonical``, ``weights``, ``warp``) and ``meta.json`` (``frame``, each
array's ``{"sharded": false}`` and the caller's extra keys), written to a
temporary directory and renamed into place. Sharded arrays come with the
sharded solvers (ROADMAP A11).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from levelsetfusion_tpu_torch.models.fusion import FusionState

_FIELDS = ("canonical", "weights", "warp")


def _ckpt_dir(root: str, frame: int) -> str:
    return os.path.join(root, f"frame_{frame:06d}")


def save(root: str, frame: int, state, warp, extra: Optional[Dict[str, Any]] = None) -> str:
    """Snapshot a FusionState and warp after fusing frame ``frame``."""
    os.makedirs(root, exist_ok=True)
    path = _ckpt_dir(root, frame)
    tmp = path + f".tmp{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {name: x.detach().cpu().numpy()
              for name, x in zip(_FIELDS, (state.canonical, state.weights, warp))}
    np.savez_compressed(os.path.join(tmp, "state.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"frame": frame, "arrays": {name: {"sharded": False} for name in _FIELDS},
                   **(extra or {})}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def latest_frame(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    frames = [
        int(d.split("_")[1])
        for d in os.listdir(root)
        if d.startswith("frame_") and ".tmp" not in d
    ]
    return max(frames) if frames else None


def load(root: str, frame: Optional[int] = None,
         device="cpu") -> Tuple[Any, torch.Tensor, Dict[str, Any]]:
    """Load ``(FusionState, warp, meta)`` for ``frame`` (default: the
    latest) onto ``device``."""
    if frame is None:
        frame = latest_frame(root)
        if frame is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = _ckpt_dir(root, frame)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    sharded = [name for name in _FIELDS
               if meta.get("arrays", {}).get(name, {}).get("sharded")]
    if sharded:
        raise NotImplementedError(
            f"{path}: sharded arrays {sharded} are not ported yet (ROADMAP A11)"
        )
    with np.load(os.path.join(path, "state.npz")) as data:
        loaded = {name: torch.from_numpy(data[name]).to(device) for name in _FIELDS}
    state = FusionState(canonical=loaded["canonical"], weights=loaded["weights"])
    return state, loaded["warp"], meta
