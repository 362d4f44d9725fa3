"""The port's ``depth_directory`` dataset (io/datasets.py) and the fusion
read from disk, against JAX's.

The sequences are written with JAX's ``save_depth_png`` (cv2) and read back
for the references with ``cv2.imread``, never through JAX's native loader;
JAX's ``load_snoopy_calib`` parses the calibration files (no PNG is read
there). Tolerances: a fusion from disk equals the port's in-memory fusion of
the cv2-decoded frames exactly (same frames, same code); against JAX's
``fuse_sequence`` on those frames, tests/test_torch_fusion.py's: iterations
exactly, the canonical and final warp within rtol 3e-4 atol 3e-6, the weights
exactly, away from the voxels whose warped value lies at the band's bound."""

import dataclasses
import json
import os
import sys
import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.core.camera import PinholeCamera as JCamera
from levelsetfusion_tpu.core.grid import GridSpec as JGrid
from levelsetfusion_tpu.io import datasets as jdatasets
from levelsetfusion_tpu.io import depth as jdepth
from levelsetfusion_tpu.io import synthetic as jsynthetic
from levelsetfusion_tpu.models import fusion as jfusion
from levelsetfusion_tpu.models.params import SmoothingMode as JMode
from levelsetfusion_tpu.models.params import SolverParams as JSolver
from levelsetfusion_tpu_torch import cli as tcli
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.io import datasets, native_loader
from levelsetfusion_tpu_torch.models import fusion
from levelsetfusion_tpu_torch.models.params import SmoothingMode, SolverParams
from levelsetfusion_tpu_torch.utils import checkpoint
from levelsetfusion_tpu_torch.utils.config import ExperimentConfig
from tests.test_torch_fusion import MAX_NEAR, OFFSET, SEQ, SHAPE, SOLVER, VOXEL, _near_bound
from tests.torch_parity import assert_close, n


def _write_sequence(root, num_frames=4, width=48, height=48, calib="json"):
    """tests/test_dataset_driver.py's sequence as JAX writes it, with
    ``intrinsics.json`` (or no calibration): the sequence and the
    cv2-decoded frames in metres."""
    seq = jsynthetic.snoopy_style_sequence_3d(
        num_frames, width=width, height=height,
        **{k: v for k, v in SEQ.items() if k not in ("num_frames", "width", "height")})
    os.makedirs(root, exist_ok=True)
    decoded = []
    for t, frame in enumerate(seq.frames):
        path = os.path.join(root, f"depth_{t:06d}.png")
        jdepth.save_depth_png(path, np.asarray(frame))
        decoded.append(cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32) * 0.001)
    cam = seq.camera
    if calib == "json":
        with open(os.path.join(root, "intrinsics.json"), "w") as f:
            json.dump({"fx": cam.fx, "fy": cam.fy, "cx": cam.cx, "cy": cam.cy,
                       "width": cam.image_width, "height": cam.image_height}, f)
    return seq, decoded


def _camera(c):
    return (c.fx, c.fy, c.cx, c.cy, c.image_width, c.image_height)


def test_intrinsics_json_equals_jax(tmp_path):
    _write_sequence(str(tmp_path))
    got = datasets.get("depth_directory", path=str(tmp_path))
    # JAX's entry reads no PNG when intrinsics.json gives the image size.
    want = jdatasets.get("depth_directory", path=str(tmp_path))
    assert _camera(got.camera) == _camera(want.camera)
    assert got.name == want.name and len(got) == len(want) == 4
    assert got._paths == want._paths


CALIBS = {
    "key_value": "fx 570.3\nfy: 570.4\ncx 320.0\ncy 240.0\n",
    "key_value_px_size": "# Snoopy\nFx: 570.3\nfy 570.4\npx 319.5\npy 239.5\n"
                         "ImageSize 16 12\n",
    "key_value_width_height": "fx 500\nfy 501\ncx 8\ncy 6\nwidth 16\nheight 12\n",
    "matrix_with_size": "ImageSize 16 12\n570.3 0 320.0\n0 570.4 240.0\n0 0 1\n",
    "matrix_commas_skew": "570.3, 0.5, 7.5\n0, 570.4, 5.5\n0, 0, 1\n",
    "matrix_after_text": "intrinsics of the depth camera\n525 0 319.5\n0 525 239.5\n0 0 1\n"
                         "1.0 scale\n",
    "keys_and_matrix": "fx 600\n570.3 0 320.0\n0 570.4 240.0\n0 0 1\n",
}


@pytest.mark.parametrize("layout", sorted(CALIBS))
def test_text_calibration_equals_jax(tmp_path, layout):
    """Every layout of tests/test_dataset_driver.py:86 and its variants: the
    port's parse equals JAX's dict, and the camera of the directory takes
    the image size from it or from the first frame (cx = 320 on a 16-pixel
    image is legal)."""
    path = tmp_path / "calib.txt"
    path.write_text(CALIBS[layout])
    got = datasets.load_snoopy_calib(str(path))
    assert got == jdatasets.load_snoopy_calib(str(path))
    rng = np.random.default_rng(0)
    for t in range(3):
        jdepth.save_depth_png(str(tmp_path / f"depth_{t:06d}.png"),
                              (0.5 + 0.01 * rng.random((12, 16))).astype(np.float32))
    ds = datasets.get("depth_directory", path=str(tmp_path))
    assert len(ds) == 3 and ds.frame(1).shape == (12, 16)
    cam = ds.camera
    assert (cam.fx, cam.fy, cam.cx, cam.cy) == (got["fx"], got["fy"], got["cx"], got["cy"])
    assert (cam.image_width, cam.image_height) == (got.get("width", 16), got.get("height", 12))


REFUSED = {
    # ADVICE's file: a 4x4 pose before the intrinsics; JAX reads fx = 1.
    "pose_first": "1 0 0 0.1\n0 1 0 0\n0 0 1 0\n0 0 0 1\n570 0 320\n0 570 240\n0 0 1\n",
    "one_row_of_nine": "570 0 320 0 570 240 0 0 1\n",
    "rotation": "0.9 -0.1 0\n0.1 0.9 0\n0 0 1.5\n",
    "lower_triangle": "570 0 320\n3 570 240\n0 0 1\n",
    "negative_fx": "-570 0 320\n0 570 240\n0 0 1\n",
    "too_few_rows": "570 0 320\n0 570 240\n",
}


@pytest.mark.parametrize("layout", sorted(REFUSED))
def test_calibration_that_is_not_an_intrinsic_matrix_is_refused(tmp_path, layout):
    path = tmp_path / "calib.txt"
    path.write_text(REFUSED[layout])
    with pytest.raises(ValueError):
        datasets.load_snoopy_calib(str(path))
    if layout == "pose_first":
        assert jdatasets.load_snoopy_calib(str(path))["fx"] == 1.0  # JAX's silent misread


def test_frame_sources(tmp_path, monkeypatch):
    """The native prefetcher where the decoder is built (pinned float32
    tensors wherever CUDA is up), ``_LazyFrames`` (numpy) without it; both
    give the cv2-decoded frames, from any start."""
    _, decoded = _write_sequence(str(tmp_path))
    ds = datasets.get("depth_directory", path=str(tmp_path))
    np.testing.assert_array_equal(ds.frame(2), decoded[2])
    src = ds.frame_source(1)
    assert isinstance(src, native_loader.DepthPrefetcher) and len(src) == 3
    frames = list(src)
    for got, want in zip(frames, decoded[1:]):
        assert got.is_pinned() == torch.cuda.is_available()
        np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(native_loader, "native_available", lambda: False)
    lazy = ds.frame_source()
    assert isinstance(lazy, datasets._LazyFrames) and len(lazy) == 4
    for got, want in zip(lazy, decoded):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)


def _disk_config(path, **kw):
    return ExperimentConfig(
        name="disk_fusion", mode="multi_frame_3d", grid_shape=SHAPE, voxel_size=VOXEL,
        grid_offset=OFFSET, num_frames=4, checkpoint_every=1, dataset="depth_directory",
        dataset_kwargs={"path": path},
        solver=SolverParams(smoothing_mode=SmoothingMode.KILLING, **SOLVER), **kw)


@pytest.fixture(scope="module")
def disk_run(tmp_path_factory):
    """The CLI's multi_frame_3d from a depth directory on the CPU, and the
    sequence's cv2-decoded frames."""
    root = str(tmp_path_factory.mktemp("seq"))
    seq, decoded = _write_sequence(root)
    out = str(tmp_path_factory.mktemp("run"))
    summary = tcli.run_experiment(_disk_config(root), out, device="cpu")
    return root, seq, decoded, out, summary


def _final(out):
    return checkpoint.load(os.path.join(out, "checkpoints"), 3)


def test_disk_fusion_equals_in_memory_fusion(disk_run):
    root, seq, decoded, out, summary = disk_run
    assert summary["frames"] == 4 and summary["dataset"] == f"depth_directory:{root}"
    ds = datasets.get("depth_directory", path=root)
    tcfg = fusion.FusionPipelineConfig(grid=GridSpec(shape=SHAPE, voxel_size=VOXEL,
                                                     offset=OFFSET),
                                       hierarchical=False, solver=_disk_config(root).solver)
    mem = fusion.fuse_sequence(decoded, ds.camera, tcfg, device="cpu")
    assert json.loads(json.dumps(summary["reports"])) == json.loads(
        json.dumps([r._asdict() for r in mem.reports]))
    state, warp, meta = _final(out)
    assert meta["final"]
    for a, b in zip((*state, warp), (*mem.state, mem.final_warp)):
        assert torch.equal(a, b)


def test_disk_fusion_matches_jax(disk_run):
    root, seq, decoded, out, summary = disk_run
    jcfg = jfusion.FusionPipelineConfig(
        grid=JGrid(shape=SHAPE, voxel_size=VOXEL, offset=OFFSET), hierarchical=False,
        solver=JSolver(smoothing_mode=JMode.KILLING, **SOLVER))
    cam = seq.camera
    jcam = JCamera(cam.fx, cam.fy, cam.cx, cam.cy, cam.image_width, cam.image_height)
    jwarps, twarps = {}, {}

    def keep(store):
        def cb(t_, state, warp, report=None, solver=None):
            store[t_] = np.array(n(warp))
        return cb

    want = jfusion.fuse_sequence([jnp.asarray(f) for f in decoded], jcam, jcfg,
                                 frame_callback=keep(jwarps))
    ds = datasets.get("depth_directory", path=root)
    tcfg = fusion.FusionPipelineConfig(grid=GridSpec(shape=SHAPE, voxel_size=VOXEL,
                                                     offset=OFFSET),
                                       hierarchical=False, solver=_disk_config(root).solver)
    fusion.fuse_sequence(ds.frame_source(), ds.camera, tcfg, device="cpu",
                         frame_callback=keep(twarps))
    near = _near_bound(types.SimpleNamespace(frames=decoded, camera=jcam), jcfg, jwarps, twarps)
    assert near.mean() <= MAX_NEAR, near.mean()
    far = ~near
    got_state, got_warp, _ = _final(out)
    for g, w in zip(summary["reports"], want.reports):
        assert g["solver_iterations"] == int(w.solver_iterations) > 0
        np.testing.assert_allclose(g["final_data_energy"], w.final_data_energy, rtol=2e-4)
    np.testing.assert_array_equal(n(got_state.weights)[far], np.asarray(want.state.weights)[far])
    np.testing.assert_allclose(n(got_state.canonical)[far],
                               np.asarray(want.state.canonical)[far], rtol=3e-4, atol=3e-6)
    assert_close(got_warp, want.final_warp, rtol=3e-4, atol=3e-6)


class _Stop(Exception):
    pass


def test_disk_resume_equals_uninterrupted(disk_run, tmp_path, monkeypatch):
    """Stopped after frame 2's checkpoint and resumed from the same
    directory (the frame source from frame 2): the uninterrupted run's final
    state and warp, exactly."""
    root, _, _, out, summary = disk_run
    stopped = str(tmp_path / "stopped")
    save = checkpoint.save

    def save_then_stop(ckpt_root, frame, *args, **kw):
        path = save(ckpt_root, frame, *args, **kw)
        if frame == 2:
            raise _Stop
        return path

    monkeypatch.setattr(checkpoint, "save", save_then_stop)
    with pytest.raises(_Stop):
        tcli.run_experiment(_disk_config(root), stopped, device="cpu")
    monkeypatch.setattr(checkpoint, "save", save)
    resumed = tcli.run_experiment(_disk_config(root), stopped, device="cpu", resume=True)
    assert resumed["frames_processed"] == 2
    assert resumed["reports"] == summary["reports"][2:]
    for a, b in zip((*_final(stopped)[0], _final(stopped)[1]), (*_final(out)[0], _final(out)[1])):
        assert torch.equal(a, b)


def test_disk_fusion_without_plot_modules(tmp_path, monkeypatch):
    """With cv2, PIL and matplotlib unimportable, multi_frame_3d from a
    depth directory still runs (the port's own PNG decoder) and records the
    plots and the video it did not write."""
    root = str(tmp_path / "seq")
    _write_sequence(root, num_frames=3)
    for name in ("cv2", "PIL", "matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    cfg = dataclasses.replace(_disk_config(root), num_frames=3,
                              solver=SolverParams(max_iterations=5))
    out = str(tmp_path / "run")
    summary = tcli.run_experiment(cfg, out, device="cpu")
    assert summary["frames"] == 3
    with open(os.path.join(out, "events.jsonl")) as f:
        skipped = [e for e in map(json.loads, f) if e["event"] == "artifacts_skipped"]
    assert {tuple(e["files"]) for e in skipped} == {("canonical_evolution.mp4",),
                                                    ("canonical.png", "warp.png")}
    assert all("matplotlib" in e["missing"] for e in skipped)
    assert not any(f.endswith((".png", ".mp4")) for f in os.listdir(out))


def test_sharded_disk_fusion_equals_in_memory(disk_run, tmp_path):
    """multi_frame_sharded_3d from the depth directory on a world of 1 (in
    this process) reports what ``fuse_sequence_sharded`` of the decoded
    frames held in memory reports."""
    from levelsetfusion_tpu_torch.parallel import close_group, init_group

    root, _, decoded, _, _ = disk_run
    cfg = dataclasses.replace(_disk_config(root), mode="multi_frame_sharded_3d",
                              checkpoint_every=0)
    summary = tcli.run_experiment(cfg, str(tmp_path / "sharded"), device="cpu")
    ds = datasets.get("depth_directory", path=root)
    tcfg = fusion.FusionPipelineConfig(grid=GridSpec(shape=SHAPE, voxel_size=VOXEL,
                                                     offset=OFFSET),
                                       hierarchical=False, solver=cfg.solver)
    group = init_group("cpu")
    try:
        mem = fusion.fuse_sequence_sharded(decoded, ds.camera, tcfg, group=group,
                                           live_halo=cfg.live_halo)
    finally:
        close_group(group)
    assert summary["frames"] == 4 and summary["devices"] == 1
    assert json.loads(json.dumps(summary["reports"])) == json.loads(
        json.dumps([r._asdict() for r in mem.reports]))
