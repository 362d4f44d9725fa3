"""Parity of the port's core, synthetic data and TSDF generation (BASIC and
EWA, 2D and 3D) with the JAX package, plus the port's import boundary (no
jax) and precision settings (no TF32)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.core import camera as jcam
from levelsetfusion_tpu.core import grid as jgrid
from levelsetfusion_tpu.io import synthetic as jsyn
from levelsetfusion_tpu.ops import tsdf as jtsdf
from levelsetfusion_tpu_torch.core import camera as tcam
from levelsetfusion_tpu_torch.core import grid as tgrid
from levelsetfusion_tpu_torch.io import synthetic as tsyn
from levelsetfusion_tpu_torch.ops import tsdf as ttsdf
from tests.torch_parity import assert_close, n, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "shape,voxel_size,offset",
    [((24, 20, 16), 0.004, (-12, -10, 80)), ((9, 7), 0.01, (-4, 30)), ((6, 4, 8), 0.016, None)],
)
def test_grid_spec_and_voxel_centers(shape, voxel_size, offset):
    """Exact: the same f32 arange, add and multiply."""
    jg = jgrid.GridSpec(shape, voxel_size, offset)
    tg = tgrid.GridSpec(shape, voxel_size, offset)
    assert (tg.dim, tg.num_voxels, tg.offset) == (jg.dim, jg.num_voxels, jg.offset)
    for a, b in zip(tg.world_bounds(), jg.world_bounds()):
        np.testing.assert_array_equal(a, b)
    if all(s % 2 == 0 for s in shape):
        assert tg.coarsened(2) == tgrid.GridSpec(**jg.coarsened(2).__dict__)
    got = tgrid.voxel_center_coordinates(tg, "cpu")
    np.testing.assert_array_equal(n(got), n(jgrid.voxel_center_coordinates(jg)))


def test_grid_spec_rejects_bad_rank():
    with pytest.raises(ValueError):
        tgrid.GridSpec((4,))
    with pytest.raises(ValueError):
        tgrid.GridSpec((4, 4), offset=(0, 0, 0))


def test_camera_projection_and_transform():
    """Projection and a rigid transform at full f32 (rtol 1e-6: the matmul
    may sum in another order than XLA's)."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.2, 0.2, (50, 3)).astype(np.float32)
    pts[:, 2] += 0.5
    kw = dict(fx=64.0, fy=60.0, cx=64.0, cy=60.0, image_width=128, image_height=120)
    jc, tc = jcam.PinholeCamera(**kw), tcam.PinholeCamera(**kw)
    assert_close(tc.project(t(pts)), jc.project(jnp.asarray(pts)), rtol=1e-6)
    assert_close(tc.scanline().project(t(pts[:, [0, 2]])),
                 jc.scanline().project(jnp.asarray(pts[:, [0, 2]])), rtol=1e-6)
    c, s = np.cos(0.3), np.sin(0.3)
    m = np.array([[c, 0, s, 0.01], [0, 1, 0, -0.02], [-s, 0, c, 0.03], [0, 0, 0, 1]],
                 np.float32)
    assert_close(tcam.transform_points(t(m), t(pts)),
                 jcam.transform_points(jnp.asarray(m), jnp.asarray(pts)), rtol=1e-6, atol=1e-7)


def test_synthetic_blob_wall_depth_matches():
    """Exact: the same numpy code."""
    jc, tc = jsyn.default_camera_3d(96, 80), tsyn.default_camera_3d(96, 80)
    assert tc.__dict__ == jc.__dict__
    kw = dict(wall_depth=0.4, blob_center_px=(50.0, 41.0), blob_radius_px=18.0,
              blob_height=0.06)
    np.testing.assert_array_equal(tsyn.blob_wall_depth_3d(tc, **kw),
                                  jsyn.blob_wall_depth_3d(jc, **kw))


def _tsdf_pair(extrinsic, method="BASIC"):
    cam_kw = dict(fx=64.0, fy=64.0, cx=64.0, cy=64.0, image_width=128, image_height=128)
    depth = jsyn.blob_wall_depth_3d(jcam.PinholeCamera(**cam_kw), blob_height=0.06,
                                    blob_radius_px=18.0)
    depth[:, 70:] = 0.0  # invalid columns: voxels seeing them get +1
    grid_kw = dict(shape=(24, 20, 16), voxel_size=0.004, offset=(-12, -10, 88))
    want = jtsdf.generate_tsdf_3d(
        jnp.asarray(depth), jcam.PinholeCamera(**cam_kw), jgrid.GridSpec(**grid_kw),
        extrinsic=None if extrinsic is None else jnp.asarray(extrinsic),
        method=jtsdf.GenerationMethod[method],
    )
    got = ttsdf.generate_tsdf_3d(
        t(depth), tcam.PinholeCamera(**cam_kw), tgrid.GridSpec(**grid_kw),
        extrinsic=None if extrinsic is None else t(extrinsic),
        method=ttsdf.GenerationMethod[method],
    )
    return got, want


@pytest.mark.parametrize("rotated", [False, True])
def test_tsdf_basic_matches_jax(rotated):
    """BASIC TSDF at (24, 20, 16) on the blob wall: the same pixels and
    values to 1 ulp (atol 2e-7; XLA may scale by the band's reciprocal
    instead of dividing) without an extrinsic; with a rotation the matmul's
    summation order may move a voxel across a pixel-rounding boundary, so at
    most 0.5% of voxels may differ by more than 1e-5."""
    m = None
    if rotated:
        c, s = np.cos(0.05), np.sin(0.05)
        m = np.array([[c, 0, s, 0.002], [0, 1, 0, 0], [-s, 0, c, 0.001], [0, 0, 0, 1]],
                     np.float32)
    got, want = _tsdf_pair(m)
    got, want = n(got), n(want)
    assert got.shape == want.shape == (24, 20, 16)
    assert np.any(np.abs(want) < 1.0) and np.any(want == 1.0)
    if not rotated:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    else:
        off = np.abs(got - want) > 1e-5
        assert off.mean() <= 0.005, off.mean()


def _tsdf_2d_pair(extrinsic, method):
    pair = jsyn.bump_wall_pair_2d(width=128, bump_height=0.04, live_shift_px=4.0)
    depth = pair.live_depth.copy()
    depth[90:100] = 0.0  # invalid pixels: BASIC voxels seeing them get +1
    grid_kw = dict(shape=(96, 48), voxel_size=0.004, offset=(-48, 85))
    want = jtsdf.generate_tsdf_2d(
        jnp.asarray(depth), pair.camera, jgrid.GridSpec(**grid_kw),
        extrinsic=None if extrinsic is None else jnp.asarray(extrinsic),
        method=jtsdf.GenerationMethod[method],
    )
    got = ttsdf.generate_tsdf_2d(
        t(depth), tcam.Camera2d(**pair.camera.__dict__), tgrid.GridSpec(**grid_kw),
        extrinsic=None if extrinsic is None else t(extrinsic),
        method=ttsdf.GenerationMethod[method],
    )
    return n(got), n(want)


METHODS = ["BASIC", "EWA_IMAGE", "EWA_TSDF", "EWA_TSDF_INCLUSIVE"]


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_tsdf_2d_matches_jax(method, rotated):
    """config1's scanline TSDF at (96, 48), every method, without and with
    an SE(2) extrinsic: the rule of the 3D BASIC test (|Δ| > 1e-5 on at most
    0.5% of voxels); the max |Δ| seen is 2.3e-6 (EWA_IMAGE divides an
    averaged depth by the band)."""
    m = jcam.se2_matrix(0.03, 0.004, -0.002) if rotated else None
    got, want = _tsdf_2d_pair(m, method)
    assert got.shape == want.shape == (96, 48)
    assert np.any(np.abs(want) < 1.0) and np.any(want == 1.0)
    off = np.abs(got - want) > 1e-5
    assert off.mean() <= 0.005, off.mean()


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("method", METHODS[1:])
def test_tsdf_ewa_3d_matches_jax(method, rotated):
    """The three EWA methods at (24, 20, 16) on the blob wall with invalid
    columns (7x7 window, projected 2x2 covariance): the BASIC rule; the max
    |Δ| seen is 3.0e-6."""
    m = None
    if rotated:
        c, s = np.cos(0.05), np.sin(0.05)
        m = np.array([[c, 0, s, 0.002], [0, 1, 0, 0], [-s, 0, c, 0.001], [0, 0, 0, 1]],
                     np.float32)
    got, want = _tsdf_pair(m, method)
    got, want = n(got), n(want)
    assert np.any(np.abs(want) < 0.5) and np.any(np.abs(want) > 0.99)
    off = np.abs(got - want) > 1e-5
    assert off.mean() <= 0.005, off.mean()
    assert ttsdf.GenerationMethod[method].value == jtsdf.GenerationMethod[method].value
    assert (ttsdf.EWA_WINDOW_RADIUS, ttsdf.EWA_SCREEN_VARIANCE) == (
        jtsdf.EWA_WINDOW_RADIUS, jtsdf.EWA_SCREEN_VARIANCE)


def test_synthetic_bump_pair_2d_matches():
    """Exact: the same numpy code."""
    kw = dict(width=96, bump_height=0.05, bump_radius_px=15.0, live_shift_px=7.0,
              live_height_scale=0.8)
    got, want = tsyn.bump_wall_pair_2d(**kw), jsyn.bump_wall_pair_2d(**kw)
    assert got.camera.__dict__ == want.camera.__dict__
    assert tsyn.default_camera_2d(64).__dict__ == jsyn.default_camera_2d(64).__dict__
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsyn._bump(np.arange(9.0), 4.0, 3.0, 0.1),
                                  jsyn._bump(np.arange(9.0), 4.0, 3.0, 0.1))


def test_tsdf_rejects_the_wrong_rank():
    cam = tsyn.default_camera_3d(16, 16)
    with pytest.raises(ValueError, match="3D grid"):
        ttsdf.generate_tsdf_3d(torch.ones(16, 16), cam, tgrid.GridSpec((4, 4)))
    with pytest.raises(ValueError, match="2D grid"):
        ttsdf.generate_tsdf_2d(torch.ones(16), cam.scanline(), tgrid.GridSpec((4, 4, 4)))


def test_port_imports_no_jax():
    """Importing every module of the package (``pkgutil.walk_packages``: the
    CLI, the models, the ops, the kernels' wrappers, the experiments) leaves
    jax and the JAX package out of sys.modules."""
    code = ("import sys, importlib, pkgutil, levelsetfusion_tpu_torch as p; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
            "[importlib.import_module(m) for m in names]; "
            "need = {'cli', 'models.rigid', 'models.hierarchical', 'ops.pyramid', "
            "'experiments.loop_cost', 'ops.kernels.resample'}; "
            "assert need <= {m.removeprefix(p.__name__ + '.') for m in names}, names; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'levelsetfusion_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_tf32_is_off():
    import levelsetfusion_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
