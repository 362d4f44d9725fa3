"""B2's y window (``y_offset``, ``y_global``, ``y_lo``, ``y_len``) and
``conv_local_x`` on its plain version, against the JAX kernel in interpret
mode (chip_smoke.py phase 25 holds the CUDA kernels to the plain version
on the card):

- every block of a (2, 4) and a (4, 2) split of (16, 32, 128), with the
  energy and filter of tests/test_fused_gradient.py's
  ``test_2d_sharded_block_windows_match_golden`` and its garbage halos
  (JAX's 8 y ghost columns; the port's solvers take ``stencil_halo``
  columns, 5 here, which gives the same values);
- ``conv_local_x`` on every rank of a 4-way split of tests/test_schur.py's
  (32, 8, 128) with Sobolev taps, 2 ghost rows a side;
- tolerances: the warp atol 1e-5 rtol 1e-5, the energies and sum |du| rtol
  1e-4, the maxes rtol 1e-4 (tests/test_torch_windows.py's);
- the windows' union against the whole call, and the windows the checks
  refuse.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.ops.pallas import fused_gradient as jfg
from levelsetfusion_tpu_torch.ops.kernels import fused_gradient as kfg
from tests.test_torch_windows import KW, TAPS, _stats
from tests.torch_parity import assert_close, n, t, tsdf_like

SHAPE = (16, 32, 128)
HX, JAX_HY = 5, 8


def _block(a, x0, nx, hx, y0, ny, hy, fill, off=0):
    """Rows [x0 - hx, x0 + nx + hx) and columns [y0 - hy, y0 + ny + hy) of
    ``a`` (axes ``off``, ``off + 1``), ``fill`` beyond its edges."""
    pad = [(0, 0)] * a.ndim
    pad[off], pad[off + 1] = (hx, hx), (hy, hy)
    ext = np.pad(a, pad, constant_values=fill)
    sl = [slice(None)] * a.ndim
    sl[off], sl[off + 1] = slice(x0, x0 + nx + 2 * hx), slice(y0, y0 + ny + 2 * hy)
    return np.ascontiguousarray(ext[tuple(sl)])


@pytest.fixture(scope="module")
def fields():
    canonical, warped, warp = tsdf_like(SHAPE, 40)
    warp_cm = np.ascontiguousarray(np.moveaxis(warp, -1, 0))
    whole = kfg.fused_gradient_update(t(warped), t(canonical), t(warp_cm), torch.tensor(0.25),
                                      taps=TAPS, **KW)
    return canonical, warped, warp_cm, whole


def _window_call(fields, split, ix, iy, hy, jax_too):
    canonical, warped, warp_cm, _ = fields
    nx, ny = SHAPE[0] // split[0], SHAPE[1] // split[1]
    x0, y0 = ix * nx, iy * ny
    blocks = [_block(a, x0, nx, HX, y0, ny, hy, fill, off) for a, fill, off in
              ((warped, 7.7, 0), (canonical, -3.3, 0), (warp_cm, 9.9, 1))]
    win = dict(x_offset=x0 - HX, x_global=SHAPE[0], x_lo=HX, x_len=nx, y_offset=y0 - hy,
               y_global=SHAPE[1], y_lo=hy, y_len=ny)
    got = kfg.fused_gradient_update(*(t(b) for b in blocks), torch.tensor(0.25), taps=TAPS,
                                    **KW, **win)
    want = None
    if jax_too:
        want = jfg.fused_gradient_update(*(jnp.asarray(b) for b in blocks), jnp.float32(0.25),
                                         taps=TAPS, interpret=True, tile_override=(4, 8),
                                         **KW, **win)
    return got, want, (slice(x0, x0 + nx), slice(y0, y0 + ny))


@pytest.mark.parametrize("split", [(2, 4), (4, 2)])
def test_y_window_on_every_block_matches_jax(split, fields):
    """Every block's window against JAX's kernel (8 ghost columns) and the
    whole call's voxels; the port's 5 ghost columns give the same warp; the
    blocks' energies and sum |du| add up to the whole call's, their maxes
    to its maxes."""
    whole_w, whole_s = fields[3]
    sums, maxes = torch.zeros(4, dtype=torch.float64), torch.zeros(4)
    for ix in range(split[0]):
        for iy in range(split[1]):
            (got_w, got_s), (want_w, want_s), part = _window_call(fields, split, ix, iy,
                                                                  JAX_HY, True)
            assert got_w.shape == (3, SHAPE[0] // split[0], SHAPE[1] // split[1], SHAPE[2])
            assert_close(got_w, want_w, rtol=1e-5, atol=1e-5)
            assert_close(got_s[:4], _stats(want_s)[:4], rtol=1e-4)
            assert_close(got_s[4:], _stats(want_s)[4:], rtol=1e-4, atol=1e-7)
            assert_close(got_w, whole_w[(slice(None), *part)], rtol=1e-5, atol=1e-5)
            (narrow_w, narrow_s), _, _ = _window_call(fields, split, ix, iy, HX, False)
            assert_close(narrow_w, got_w, rtol=1e-6, atol=1e-6)
            assert_close(narrow_s, got_s, rtol=1e-5, atol=1e-8)
            sums += got_s[:4].double()
            maxes = torch.maximum(maxes, got_s[4:])
    assert_close(sums, whole_s[:4].double(), rtol=1e-5)
    assert_close(maxes, whole_s[4:], rtol=1e-6)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_conv_local_x_on_every_rank_matches_jax(rank):
    """A 4-way split of (32, 8, 128) with 2 ghost rows a side (garbage past
    the volume): the filter's x pass zero-padded at the block's rows, as
    the Schur solvers run it."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((32, 8, 128)).astype(np.float32)
    canonical = np.tanh(base * 0.3)
    warped = np.tanh(np.roll(base, 1, axis=0) * 0.3)
    warp_cm = (rng.standard_normal((3, 32, 8, 128)) * 0.5).astype(np.float32)
    nx = 8
    blocks = [_block(a, rank * nx, nx, 2, 0, 8, 0, fill, off) for a, fill, off in
              ((warped, 7.7, 0), (canonical, -3.3, 0), (warp_cm, 9.9, 1))]
    win = dict(x_offset=rank * nx - 2, x_global=32, x_lo=2, x_len=nx, conv_local_x=True)
    kw = dict(KW, w_ls=0.1, killing=False)
    got_w, got_s = kfg.fused_gradient_update(*(t(b) for b in blocks), torch.tensor(0.2),
                                             taps=TAPS, **kw, **win)
    want_w, want_s = jfg.fused_gradient_update(*(jnp.asarray(b) for b in blocks),
                                               jnp.float32(0.2), taps=TAPS, interpret=True,
                                               **kw, **win)
    assert_close(got_w, want_w, rtol=1e-5, atol=1e-5)
    assert_close(got_s[:4], _stats(want_s)[:4], rtol=1e-4)
    assert_close(got_s[4:], _stats(want_s)[4:], rtol=1e-4, atol=1e-7)
    # Not the volume's filter: the block-local x pass differs near the
    # block's faces inside the volume.
    whole_w, _ = kfg.fused_gradient_update(t(warped), t(canonical), t(warp_cm),
                                           torch.tensor(0.2), taps=TAPS, **kw)
    assert not torch.allclose(got_w, whole_w[:, rank * nx:(rank + 1) * nx], atol=1e-6)


def test_conv_local_x_ghost_values_ignored():
    """Under conv_local_x the rows outside the window feed the stencils only:
    past a global edge nothing of them is read (NaN and inf there change
    nothing), and the result is the call's whatever the filter."""
    canonical, warped, warp = tsdf_like((12, 10, 16), 41)
    warp_cm = np.ascontiguousarray(np.moveaxis(warp, -1, 0))
    win = dict(x_offset=-2, x_global=8, x_lo=2, x_len=8, conv_local_x=True)
    args = [t(a) for a in (warped, canonical, warp_cm)]
    out1 = kfg.fused_gradient_update(*args, torch.tensor(0.1), taps=TAPS, **KW, **win)
    args[0][:2], args[0][-2:] = float("nan"), -77.0
    args[2][:, :2], args[2][:, -2:] = 55.0, float("inf")
    out2 = kfg.fused_gradient_update(*args, torch.tensor(0.1), taps=TAPS, **KW, **win)
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("window,match", [
    (dict(y_offset=-5, y_global=20, y_lo=2, y_len=8), "y window"),  # beyond the volume
    (dict(y_offset=3, y_global=40, y_lo=4, y_len=4), "y window"),  # column y_lo - 5 missing
    (dict(y_offset=0, y_global=12, y_lo=0, y_len=13), "y window"),  # beyond the input
    (dict(x_offset=2, x_global=30, x_lo=2, x_len=8), "x window"),  # 2 rows need conv_local_x
])
def test_rejects_bad_windows(window, match):
    args = (torch.zeros(12, 12, 4), torch.zeros(12, 12, 4), torch.zeros(3, 12, 12, 4),
            torch.tensor(0.1))
    with pytest.raises(ValueError, match=match):
        kfg.fused_gradient_update(*args, taps=TAPS, **window)


def test_conv_local_x_needs_two_ghost_rows_and_no_y_window_in_2d():
    args = (torch.zeros(12, 12, 4), torch.zeros(12, 12, 4), torch.zeros(3, 12, 12, 4),
            torch.tensor(0.1))
    new, _ = kfg.fused_gradient_update(*args, taps=TAPS, x_offset=2, x_global=30, x_lo=2,
                                       x_len=8, conv_local_x=True)
    assert new.shape == (3, 8, 12, 4)
    flat = (torch.zeros(12, 4), torch.zeros(12, 4), torch.zeros(2, 12, 4), torch.tensor(0.1))
    with pytest.raises(ValueError, match="2D field"):
        kfg.fused_gradient_update_reference(*flat, y_lo=1, y_len=2)
