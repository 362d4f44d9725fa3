"""The port's synthetic depth data and dataset registry against the JAX
package's: the generators are numpy code copied into the port, so their
frames must be equal, bit for bit."""

import numpy as np
import pytest

from levelsetfusion_tpu.io import datasets as jdatasets
from levelsetfusion_tpu.io import synthetic as jsynthetic
from levelsetfusion_tpu_torch.io import datasets, synthetic

SEQUENCES = [
    {},  # the generator's defaults
    dict(num_frames=4, width=48, height=48, blob_radius_px=10.0, blob_height=0.05,
         drift_px_per_frame=(1.5, 0.0), pulse_amplitude=0.1),  # the CLI's
    dict(num_frames=8, width=96, height=96, blob_radius_px=10.0, blob_height=0.05,
         drift_px_per_frame=(1.5, 0.0), pulse_amplitude=0.1),  # config4's
    dict(num_frames=1, width=33, height=17, drift_px_per_frame=(-2.5, 3.0)),
]


def _camera(cam):
    return (cam.fx, cam.fy, cam.cx, cam.cy, cam.image_width, cam.image_height)


@pytest.mark.parametrize("kw", SEQUENCES)
def test_snoopy_sequence_equals_jax(kw):
    got, want = synthetic.snoopy_style_sequence_3d(**kw), jsynthetic.snoopy_style_sequence_3d(**kw)
    assert len(got.frames) == len(want.frames) == kw.get("num_frames", 8)
    for a, b in zip(got.frames, want.frames):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert _camera(got.camera) == _camera(want.camera)


@pytest.mark.parametrize("name,kw", [
    ("synthetic_snoopy", dict(num_frames=3, width=40, height=32)),
    ("synthetic_blob_pair", dict(width=32, height=24, live_shift_px=(3.0, 1.0))),
])
def test_registry_entries_equal_jax(name, kw):
    got, want = datasets.get(name, **kw), jdatasets.get(name, **kw)
    assert got.name == want.name and len(got) == len(want)
    assert _camera(got.camera) == _camera(want.camera)
    for i in range(len(got)):
        np.testing.assert_array_equal(got.frame(i), want.frame(i))
    src = got.frame_source(1)
    assert len(src) == len(got) - 1
    np.testing.assert_array_equal(src[0], want.frame(1))


def test_registry_names_and_refusals():
    assert set(datasets.names()) == set(jdatasets.names())
    with pytest.raises(KeyError, match="unknown dataset"):
        datasets.get("nope")
    with pytest.raises(FileNotFoundError, match="no calibration file"):
        datasets.get("depth_directory", path="/nonexistent")
    with pytest.raises(FileNotFoundError):
        datasets.load_snoopy_calib("/nonexistent/calib.txt")
