"""The sharded arguments of the port's two main-path kernels, on their plain
versions (chip_smoke.py phase 22 holds the CUDA kernels to them on the
card):

- B2's x window (``x_offset``, ``x_global``, ``x_lo``, ``x_len``) against
  the JAX kernel's window cases in interpret mode (tests/
  test_fused_gradient.py's ``test_sharded_block_windows_match_golden``,
  every shard of its split, and ``test_global_edge_ghost_values_ignored``),
  at atol 1e-5 / rtol 1e-5 for the warp and rtol 1e-4 for the energies;
  the ghost values beyond a global edge never change the result;
- B1's ``x_start`` against JAX's golden haloed gather
  (``parallel/sharded.py::warp_field_sharded`` on 4 devices), atol 1e-6;
- the defaults, which are the whole-volume call exactly, the 2D form, and
  the windows the kernels refuse.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.ops import interpolation as ji
from levelsetfusion_tpu.ops.pallas import fused_gradient as jfg
from levelsetfusion_tpu.parallel import make_mesh
from levelsetfusion_tpu.parallel.sharded import warp_field_sharded as jwarp_field_sharded
from levelsetfusion_tpu_torch.ops.kernels import fused_gradient as kfg
from levelsetfusion_tpu_torch.ops.kernels import resample as kr
from tests.torch_parity import assert_close, n, t, tsdf_like

KW = dict(w_data=1.0, w_smooth=0.1, w_ls=0.1, killing=True, gamma=0.1, band_union=True)
TAPS = kfg.sobolev_taps(7, 0.1)


def _stats(s):
    """JAX's FusedStats in the port's 8-value order."""
    return np.concatenate([np.stack([np.asarray(v) for v in s[:5]]), np.asarray(s.max_abs_u)])


def _block_ext(a, lo, hi, h, fill, axis=0):
    """Rows [lo - h, hi + h) of ``a`` along ``axis``, ``fill`` beyond its
    edges (tests/test_fused_gradient.py's ``block_ext``)."""
    pad_shape = list(a.shape)
    pad_shape[axis] = h
    pad = np.full(pad_shape, fill, a.dtype)
    ext = np.concatenate([pad, a, pad], axis=axis)
    return np.take(ext, np.arange(lo, hi + 2 * h), axis=axis)


@pytest.mark.parametrize("kernel_kind", ["whole", "tiled_reuse"])
@pytest.mark.parametrize("shard", [0, 1, 2])  # global-first, middle, last
def test_sharded_block_windows_match_jax(kernel_kind, shard):
    """Each shard's window of a 3-way split of (24, 16, 128), garbage in the
    halo rows beyond the volume, against the JAX kernel's window call."""
    x, h, nblk = 24, 5, 8
    canonical, warped, warp = tsdf_like((x, 16, 128), 30)
    lo, hi = shard * nblk, shard * nblk + nblk
    w_ext, c_ext = _block_ext(warped, lo, hi, h, 7.7), _block_ext(canonical, lo, hi, h, -3.3)
    u_ext = _block_ext(np.moveaxis(warp, -1, 0), lo, hi, h, 9.9, axis=1)
    win = dict(x_offset=lo - h, x_global=x, x_lo=h, x_len=nblk)
    want_w, want_s = jfg.fused_gradient_update(
        jnp.asarray(w_ext), jnp.asarray(c_ext), jnp.asarray(u_ext), jnp.float32(0.25),
        taps=TAPS, interpret=True, force_tiled_reuse=kernel_kind == "tiled_reuse",
        tile_override=(8, 8) if kernel_kind == "tiled_reuse" else None, **KW, **win)
    got_w, got_s = kfg.fused_gradient_update(t(w_ext), t(c_ext), t(u_ext), torch.tensor(0.25),
                                             taps=TAPS, **KW, **win)
    assert got_w.shape == (3, nblk, 16, 128)
    assert_close(got_w, want_w, rtol=1e-5, atol=1e-5)
    assert_close(got_s[:4], _stats(want_s)[:4], rtol=1e-4)
    assert_close(got_s[4:], _stats(want_s)[4:], rtol=1e-4, atol=1e-7)
    # The window of the whole-volume call (the golden edge rules at the
    # volume's faces).
    whole_w, _ = kfg.fused_gradient_update(t(warped), t(canonical),
                                           kfg.to_component_major(t(warp)),
                                           torch.tensor(0.25), taps=TAPS, **KW)
    assert_close(got_w, whole_w[:, lo:hi], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("taps", [TAPS, ()])
def test_global_edge_ghost_values_ignored(taps):
    """One block that is the whole volume, its halo rows all beyond the
    global edges: garbage there changes nothing, bit for bit, and the
    result is the JAX kernel's (tests/test_fused_gradient.py's case)."""
    rng = np.random.default_rng(0)
    hx, n_local, y, z = 2 + len(taps) // 2, 16, 16, 128
    xt = n_local + 2 * hx
    warped = np.tanh(rng.standard_normal((xt, y, z)).astype(np.float32) * 0.3)
    canon = np.tanh(rng.standard_normal((xt, y, z)).astype(np.float32) * 0.3)
    warp = rng.standard_normal((3, xt, y, z)).astype(np.float32) * 0.1
    win = dict(x_global=n_local, x_lo=hx, x_len=n_local, x_offset=-hx)
    out1, st1 = kfg.fused_gradient_update(t(warped), t(canon), t(warp), torch.tensor(0.1),
                                          taps=taps, **KW, **win)
    garbled = warped.copy()
    garbled[:hx], garbled[-hx:] = np.nan, -77.0
    garbled_warp = warp.copy()
    garbled_warp[:, :hx], garbled_warp[:, -hx:] = 55.0, np.inf
    garbled_canon = canon.copy()
    garbled_canon[:hx] = np.nan
    out2, st2 = kfg.fused_gradient_update(t(garbled), t(garbled_canon), t(garbled_warp),
                                          torch.tensor(0.1), taps=taps, **KW, **win)
    np.testing.assert_array_equal(n(out1), n(out2))
    np.testing.assert_array_equal(n(st1), n(st2))
    want_w, want_s = jfg.fused_gradient_update(
        jnp.asarray(warped), jnp.asarray(canon), jnp.asarray(warp), 0.1, taps=taps,
        interpret=True, **KW, **win)
    assert_close(out1, want_w, rtol=1e-5, atol=1e-5)
    assert_close(st1[:4], _stats(want_s)[:4], rtol=1e-4)


def test_default_window_is_the_whole_volume_call():
    """x_offset = x_lo = 0, x_len = x_global = X gives today's call exactly,
    energies included (the window sums are the terms' own sums there)."""
    canonical, warped, warp = tsdf_like((9, 10, 11), 31)
    args = (t(warped), t(canonical), kfg.to_component_major(t(warp)), torch.tensor(0.3))
    for taps in (TAPS, ()):
        a = kfg.fused_gradient_update(*args, taps=taps, **KW)
        b = kfg.fused_gradient_update(*args, taps=taps, x_offset=0, x_global=9, x_lo=0,
                                      x_len=9, **KW)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(n(u), n(v))


def test_2d_window_matches_the_whole_call():
    """The plain version is dimension-generic (the sharded solver's 2D step):
    each window of a 2-way split of a 2D field equals the whole call's rows."""
    canonical, warped, warp = tsdf_like((24, 20), 32)
    cm = kfg.to_component_major(t(warp))
    whole_w, whole_s = kfg.fused_gradient_update_reference(
        t(warped), t(canonical), cm, torch.tensor(0.3), taps=TAPS, **KW)
    assert whole_s.shape == (7,)
    h, sums = 5, torch.zeros(4)
    for lo in (0, 12):
        blk = [t(_block_ext(a, lo, lo + 12, h, 5.0, axis)) for a, axis in
               ((warped, 0), (canonical, 0), (np.moveaxis(warp, -1, 0), 1))]
        got_w, got_s = kfg.fused_gradient_update_reference(
            *blk, torch.tensor(0.3), taps=TAPS, x_offset=lo - h, x_global=24, x_lo=h,
            x_len=12, **KW)
        assert_close(got_w, whole_w[:, lo:lo + 12], rtol=1e-6, atol=1e-6)
        sums += got_s[:4]
    assert_close(sums, whole_s[:4], rtol=1e-5)


@pytest.mark.parametrize("window", [
    dict(x_offset=2, x_global=30, x_lo=4, x_len=8),  # row x_lo - 5 inside the volume, not the input
    dict(x_offset=3, x_global=40, x_lo=6, x_len=8),  # row x_lo + x_len + 4 likewise
    dict(x_offset=-5, x_global=20, x_lo=2, x_len=8),  # the window reaches beyond the volume
    dict(x_offset=0, x_global=20, x_lo=5, x_len=0),
])
def test_rejects_bad_windows(window):
    x = 18
    args = (torch.zeros(x, 4, 4), torch.zeros(x, 4, 4), torch.zeros(3, x, 4, 4),
            torch.tensor(0.1))
    with pytest.raises(ValueError, match="x window"):
        kfg.fused_gradient_update(*args, taps=TAPS, **window)


def test_x_start_matches_jax_haloed_gather():
    """Each rank's block of a 4-way split of (16, 10, 12), resampled from
    its live block with a halo of 3 (+1 beyond the volume) and x_start = 3,
    against JAX's golden sharded gather; |u| up to 4 crosses the halo."""
    rng = np.random.default_rng(33)
    shape, lh = (16, 10, 12), 3
    live = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    warp = rng.uniform(-4, 4, shape + (3,)).astype(np.float32)
    want = jwarp_field_sharded(jnp.asarray(live), jnp.asarray(warp), mesh=make_mesh(4),
                               live_halo=lh)
    before = kr.launch_count
    got = [kr.warp_field_cm(t(_block_ext(live, r * 4, r * 4 + 4, lh, 1.0)),
                            kfg.to_component_major(t(warp[r * 4:r * 4 + 4])), x_start=lh)
           for r in range(4)]
    assert kr.launch_count == before  # CPU tensors: the plain version
    assert_close(torch.cat(got), want, rtol=1e-6, atol=1e-6)


def test_x_start_zero_is_the_whole_call_and_2d():
    """x_start = 0 on a field of the warp's rows is the whole-volume call
    exactly; a 2D field taller than the warp is sampled at (x_start + i +
    u0, j + u1), as JAX's golden ``sample_at`` does."""
    rng = np.random.default_rng(34)
    live = t(np.tanh(rng.standard_normal((9, 7, 5))).astype(np.float32))
    warp = t(rng.uniform(-2, 2, (3, 9, 7, 5)).astype(np.float32))
    np.testing.assert_array_equal(n(kr.warp_field_cm(live, warp, x_start=0)),
                                  n(kr.warp_field_cm(live, warp)))
    live2 = np.tanh(rng.standard_normal((12, 6))).astype(np.float32)
    warp2 = rng.uniform(-2, 2, (2, 6, 6)).astype(np.float32)
    got = kr.warp_field_cm(t(live2), t(warp2), x_start=3)
    i, j = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    pos = np.stack([(3 + i).astype(np.float32) + warp2[0],
                    j.astype(np.float32) + warp2[1]], axis=-1)
    assert_close(got, ji.sample_at(jnp.asarray(live2), jnp.asarray(pos)), rtol=1e-6,
                 atol=1e-6)
    with pytest.raises(ValueError):
        kr.warp_field_cm(t(live2), t(np.zeros((2, 6, 5), np.float32)))
