"""Checkpoint / resume of a fusion run. Twin of
``levelsetfusion_tpu/utils/checkpoint.py``.

A checkpoint is the fusion state after a frame (canonical TSDF, accumulated
weights) and the frame's warp, in JAX's on-disk layout, so that either
package reads the other's: ``<root>/frame_XXXXXX/state.npz`` (arrays
``canonical``, ``weights``, ``warp``) and ``meta.json`` (``frame``, each
array's entry and the caller's extra keys), written to a temporary
directory and renamed into place.

Sharded arrays (the sharded fusion's blocks, ``group=`` given: a
``Group``'s blocks of axis 0, or a ``Mesh2D``'s of axes 0 and 1) are saved as
shards, as JAX saves a sharded ``jax.Array``: rank r writes its block into
``state.p<r>.npz`` under the key ``<name>.p<r>s0``, and rank 0 writes the
meta, JAX's ``{"sharded": true, "shape", "dtype", "shards": [{"key",
"index", "file"}]}`` (``index``: each axis's ``[start, stop)``; ``file``,
which JAX's meta lacks, names the shard's file, else ``state.npz``). Every
rank must see the directory (a shared file system). ``load`` reassembles a
sharded array, JAX's or the port's, and with ``group=`` gives each rank its
block.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from levelsetfusion_tpu_torch.parallel.mesh import Group, Mesh2D, block_index, full_shape

_FIELDS = ("canonical", "weights", "warp")


def _ckpt_dir(root: str, frame: int) -> str:
    return os.path.join(root, f"frame_{frame:06d}")


def _barrier(group) -> None:
    if group is not None and group.world > 1:
        dist.barrier()


def _shard_meta(name: str, block: np.ndarray, group) -> Dict[str, Any]:
    """The meta of a field split into the ranks' blocks."""
    shape = full_shape(block.shape, group)
    shards = [{"key": f"{name}.p{rank}s0",
               "index": [list(cut) for cut in block_index(shape, group, rank)],
               "file": f"state.p{rank}.npz"} for rank in range(group.world)]
    return {"sharded": True, "shape": list(shape), "dtype": str(block.dtype),
            "shards": shards}


def save(root: str, frame: int, state, warp, extra: Optional[Dict[str, Any]] = None,
         group: Group | Mesh2D | None = None) -> str:
    """Snapshot a FusionState and warp after fusing frame ``frame``. With
    ``group``, the arrays are the rank's blocks and every rank of the group
    calls this: each writes its shards, rank 0 the meta."""
    arrays = {name: x.detach().cpu().numpy()
              for name, x in zip(_FIELDS, (state.canonical, state.weights, warp))}
    path = _ckpt_dir(root, frame)
    tmp = path + ".tmp" + (str(os.getpid()) if group is None else "")
    lead = group is None or group.rank == 0
    if lead:
        os.makedirs(root, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    _barrier(group)
    if group is None:
        np.savez_compressed(os.path.join(tmp, "state.npz"), **arrays)
        array_meta = {name: {"sharded": False} for name in _FIELDS}
    else:
        np.savez_compressed(os.path.join(tmp, f"state.p{group.rank}.npz"),
                            **{f"{name}.p{group.rank}s0": a for name, a in arrays.items()})
        array_meta = {name: _shard_meta(name, a, group) for name, a in arrays.items()}
    _barrier(group)
    if lead:
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"frame": frame, "arrays": array_meta, **(extra or {})}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    _barrier(group)
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


def _assemble(path: str, name: str, info: Dict[str, Any]) -> np.ndarray:
    """A sharded array from its shards, each in its ``file``."""
    if "shards" not in info:
        raise ValueError(f"{path}: sharded array {name!r} lists no shards")
    full = np.zeros(tuple(info["shape"]), dtype=np.dtype(info["dtype"]))
    for shard in info["shards"]:
        with np.load(os.path.join(path, shard.get("file", "state.npz"))) as data:
            full[tuple(slice(a, b) for a, b in shard["index"])] = data[shard["key"]]
    return full


def load(root: str, frame: Optional[int] = None, device="cpu",
         group: Group | Mesh2D | None = None) -> Tuple[Any, torch.Tensor, Dict[str, Any]]:
    """Load ``(FusionState, warp, meta)`` for ``frame`` (default: the
    latest) onto ``device``: the full arrays, or with ``group`` this rank's
    blocks (onto the group's device)."""
    from levelsetfusion_tpu_torch.models.fusion import FusionState

    if frame is None:
        frame = latest_frame(root)
        if frame is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = _ckpt_dir(root, frame)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    array_meta = meta.get("arrays", {})
    loaded = {}
    for name in _FIELDS:
        info = array_meta.get(name, {"sharded": False})
        if info.get("sharded"):
            full = _assemble(path, name, info)
        else:
            with np.load(os.path.join(path, "state.npz")) as data:
                full = data[name]
        if group is not None:
            full = full[tuple(slice(a, b) for a, b in block_index(full.shape, group))]
        loaded[name] = torch.from_numpy(np.ascontiguousarray(full)).to(
            group.device if group is not None else device)
    state = FusionState(canonical=loaded["canonical"], weights=loaded["weights"])
    return state, loaded["warp"], meta
