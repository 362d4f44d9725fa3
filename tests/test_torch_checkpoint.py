"""The port's dense checkpoints against the JAX package's: the same
on-disk layout, so each package loads what the other wrote, exactly."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.models.fusion import FusionState as JState
from levelsetfusion_tpu.utils import checkpoint as jcheckpoint
from levelsetfusion_tpu_torch.models.fusion import FusionState
from levelsetfusion_tpu_torch.utils import checkpoint
from tests.torch_parity import n, t


def _arrays(seed, shape=(6, 5, 4)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, 5, shape).astype(np.float32),
            rng.standard_normal(shape + (3,)).astype(np.float32))


def _port_save(root, frame, arrays, extra):
    c, w, u = (t(a) for a in arrays)
    return checkpoint.save(root, frame, FusionState(c, w), u, extra)


def _jax_save(root, frame, arrays, extra):
    c, w, u = (jnp.asarray(a) for a in arrays)
    return jcheckpoint.save(root, frame, JState(c, w), u, extra)


def _port_load(root, frame):
    state, warp, meta = checkpoint.load(root, frame)
    assert isinstance(warp, torch.Tensor) and warp.device.type == "cpu"
    return (*state, warp), meta


def _jax_load(root, frame):
    state, warp, meta = jcheckpoint.load(root, frame)
    return (*state, warp), meta


@pytest.mark.parametrize("writer,reader", [
    (_port_save, _port_load), (_jax_save, _port_load), (_port_save, _jax_load)])
def test_round_trip(tmp_path, writer, reader):
    root = str(tmp_path / "ckpt")
    for frame, seed in ((2, 0), (4, 1), (3, 2)):
        path = writer(root, frame, _arrays(seed), {"config": "c4", "frame_seed": seed})
        assert path == os.path.join(root, f"frame_{frame:06d}")
    assert checkpoint.latest_frame(root) == jcheckpoint.latest_frame(root) == 4
    for frame, seed in ((None, 1), (2, 0), (3, 2)):
        got, meta = reader(root, frame)
        for a, b in zip(got, _arrays(seed)):
            np.testing.assert_array_equal(n(a), b)
        assert meta["config"] == "c4" and meta["frame_seed"] == seed


def test_layout_and_refusals(tmp_path):
    root = str(tmp_path)
    assert checkpoint.latest_frame(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.load(root)
    _port_save(root, 7, _arrays(3), None)
    os.makedirs(os.path.join(root, "frame_000009.tmp123"))  # a write cut short
    assert checkpoint.latest_frame(root) == 7
    path = os.path.join(root, "frame_000007")
    assert sorted(os.listdir(path)) == ["meta.json", "state.npz"]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"frame": 7, "arrays": {k: {"sharded": False}
                                           for k in ("canonical", "weights", "warp")}}
    meta["arrays"]["warp"] = {"sharded": True}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="lists no shards"):
        checkpoint.load(root)
