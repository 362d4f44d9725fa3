"""Parity of the port's rigid SDF-2-SDF registration (``models/rigid.py``)
with the JAX package's, on tests/test_rigid.py's problems and on the CLI's
two-blob rigid_3d depth.

Tolerances: the recovered extrinsic within 1e-4 of JAX's (both run 30
Gauss–Newton steps on TSDFs that agree to ~1 ulp) and within JAX's own
bounds of the truth (tests/test_rigid.py: 2e-3 on the pose, 5e-3 on the
rotation in 3D); the per-iteration energies rtol 1e-3 (a voxel whose pixel
rounds the other way in one step moves a sum of ~1e3 band voxels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.core.camera import PinholeCamera as JCam
from levelsetfusion_tpu.core.camera import se2_matrix as jse2
from levelsetfusion_tpu.core.grid import GridSpec as JGrid
from levelsetfusion_tpu.io import synthetic as jsyn
from levelsetfusion_tpu.models import rigid as jrigid
from levelsetfusion_tpu.ops.tsdf import generate_tsdf_2d as jtsdf2
from levelsetfusion_tpu.ops.tsdf import generate_tsdf_3d as jtsdf3
from levelsetfusion_tpu_torch.core.camera import PinholeCamera, identity_extrinsic, se2_matrix
from levelsetfusion_tpu_torch.core.grid import GridSpec
from levelsetfusion_tpu_torch.io import synthetic
from levelsetfusion_tpu_torch.models import rigid
from levelsetfusion_tpu_torch.ops.tsdf import generate_tsdf_2d, generate_tsdf_3d
from tests.torch_parity import assert_close, n, t

GRID_2D = dict(shape=(96, 48), voxel_size=0.004, offset=(-48, 85))
GRID_3D = dict(shape=(32, 32, 24), voxel_size=0.008, offset=(-16, -16, 42))
CAM_3D = dict(fx=48.0, fy=48.0, cx=24.0, cy=24.0, image_width=48, image_height=48)


def test_se2_and_identity_match_jax():
    np.testing.assert_array_equal(se2_matrix(0.02, 0.008, 0.004), jse2(0.02, 0.008, 0.004))
    np.testing.assert_array_equal(n(identity_extrinsic(2)), np.eye(3, dtype=np.float32))
    assert identity_extrinsic(3).dtype == torch.float32 and identity_extrinsic(3).shape == (4, 4)


@pytest.mark.parametrize("true_pose", [(0.02, 0.008, 0.004), None])
def test_rigid_2d_matches_jax(true_pose):
    """A known SE(2) pose is recovered as JAX recovers it; with the identity
    the pose stays put (tests/test_rigid.py's two cases)."""
    pair = jsyn.bump_wall_pair_2d(width=128, bump_height=0.04, live_shift_px=0.0)
    tpair = synthetic.bump_wall_pair_2d(width=128, bump_height=0.04, live_shift_px=0.0)
    truth = np.eye(3, dtype=np.float32) if true_pose is None else jse2(*true_pose)
    iterations = 30 if true_pose else 10
    jgrid, tgrid = JGrid(**GRID_2D), GridSpec(**GRID_2D)
    jc = jtsdf2(jnp.asarray(pair.canonical_depth), pair.camera, jgrid,
                extrinsic=None if true_pose is None else jnp.asarray(truth))
    tc = generate_tsdf_2d(t(tpair.canonical_depth), tpair.camera, tgrid,
                          extrinsic=None if true_pose is None else t(truth))
    want = jrigid.solve_rigid_2d(jc, jnp.asarray(pair.canonical_depth), pair.camera, jgrid,
                                 iterations=iterations)
    got = rigid.solve_rigid_2d(tc, t(tpair.canonical_depth), tpair.camera, tgrid,
                               iterations=iterations)
    assert got.extrinsic.shape == (3, 3) and got.energies.shape == (iterations,)
    assert_close(got.extrinsic, want.extrinsic, 0.0, 1e-4)
    np.testing.assert_allclose(n(got.extrinsic), truth, atol=2e-3 if true_pose else 1e-4)
    assert_close(got.energies[0], want.energies[0], rtol=1e-3)
    if true_pose:
        e = n(got.energies)
        assert e[-1] < 0.1 * e[0]
    # The final live field under the two estimates: the BASIC rule of
    # tests/test_torch_core.py (a pixel may round the other way).
    off = np.abs(n(got.final_live) - np.asarray(want.final_live)) > 1e-5
    assert off.mean() <= 0.005, off.mean()


def _two_blobs(cam):
    """The CLI's rigid_3d depth: a blob and a smaller off-centre one."""
    kw = dict(wall_depth=0.4, blob_radius_px=10.0, blob_height=0.06)
    return np.minimum(jsyn.blob_wall_depth_3d(cam, **kw), jsyn.blob_wall_depth_3d(
        cam, **{**kw, "blob_radius_px": 6.0, "blob_height": 0.06 * 0.7,
                "blob_center_px": (14.0, 31.0)}))


@pytest.mark.parametrize("two_blobs", [False, True])
def test_rigid_3d_matches_jax(two_blobs):
    """tests/test_rigid.py's translation (one blob) and the CLI's two-blob
    depth, from the identity, 30 iterations."""
    jcam, tcam = JCam(**CAM_3D), PinholeCamera(**CAM_3D)
    if two_blobs:
        depth = _two_blobs(jcam)
    else:
        depth = jsyn.blob_wall_depth_3d(jcam, wall_depth=0.4, blob_radius_px=10.0,
                                        blob_height=0.06)
    truth = np.eye(4, dtype=np.float32)
    truth[0, 3], truth[2, 3] = 0.012, -0.008
    jgrid, tgrid = JGrid(**GRID_3D), GridSpec(**GRID_3D)
    jc = jtsdf3(jnp.asarray(depth), jcam, jgrid, extrinsic=jnp.asarray(truth))
    tc = generate_tsdf_3d(t(depth), tcam, tgrid, extrinsic=t(truth))
    want = jrigid.solve_rigid_3d(jc, jnp.asarray(depth), jcam, jgrid, iterations=30)
    got = rigid.solve_rigid_3d(tc, t(depth), tcam, tgrid, iterations=30)
    assert got.extrinsic.shape == (4, 4) and got.energies.shape == (30,)
    assert_close(got.extrinsic, want.extrinsic, 0.0, 1e-4)
    est = n(got.extrinsic)
    np.testing.assert_allclose(est[:3, 3], truth[:3, 3], atol=2e-3)
    np.testing.assert_allclose(est[:3, :3], np.eye(3), atol=5e-3)
    np.testing.assert_allclose(n(got.energies), np.asarray(want.energies), rtol=1e-3)
    e = n(got.energies)
    assert e[-1] < 0.2 * e[0]


def test_band_mask_matches_jax():
    rng = np.random.default_rng(5)
    a, b = (np.clip(rng.standard_normal((7, 6)), -1, 1).astype(np.float32) for _ in range(2))
    a.flat[::5] = 1.0
    b.flat[::5] = -1.0
    b.flat[::10] = np.float32(1 - 1e-5)
    np.testing.assert_array_equal(n(rigid._band_mask(t(a), t(b))),
                                  np.asarray(jrigid._band_mask(jnp.asarray(a), jnp.asarray(b))))


def test_rigid_rejects_the_wrong_rank():
    with pytest.raises(ValueError, match="2D grid"):
        rigid.solve_rigid_2d(torch.zeros(4, 4, 4), torch.ones(8), None, GridSpec((4, 4, 4)))
    with pytest.raises(ValueError, match="3D grid"):
        rigid.solve_rigid_3d(torch.zeros(4, 4), torch.ones(8, 8), None, GridSpec((4, 4)))
