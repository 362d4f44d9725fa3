"""Parity of the port's experiment modules (levelsetfusion_tpu_torch/
experiments/) with the JAX scripts of experiments/, which are loaded by path.

The same seeded numpy inputs go to the JAX Pallas kernel, run in interpret
mode on the CPU, and to the port's plain torch version, which each kernel
wrapper takes for CPU tensors; chip_smoke.py holds the CUDA kernels against
the same plain versions on the card. Tolerances: the stencil 1e-6 abs (sums
of 7 float32 products in another order, outputs O(1)); the banded product
1e-5 abs (dot products of 16–24 terms summed in another order); the bf16
route 1e-5 abs against numpy on the same bf16-rounded operands (products of
bf16 values are exact in float32, so only the sum order differs); the
fused I/O probe rtol 1e-6 and atol 1e-7 (XLA contracts
u + 0.1 d into an FMA; copy exact); the window probe exact.

Also: the banded kernels' extents (``band_extents``) against a brute-force
scan of every block, the skipping product against the dense one, B10's
launch plan (``dma_probe.plan``: every voxel once, the JAX probe's window
origins, the ring schedule, the moved bytes) and its sweep's anchors, the
wrappers' input checks and launch counters, every entry point end to end on
the CPU at a tiny size, and the kernel library's rebuild rule."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from levelsetfusion_tpu_torch.experiments import (
    conv_yz_sweep,
    dma_probe,
    dma_probe_sweep,
    fused_ablation,
    fused_gradient_bench,
    fused_io_probe,
    mxu_conv,
)
from levelsetfusion_tpu_torch.ops.kernels import _lib
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import sobolev_taps
from tests.torch_parity import assert_close, c_prototype, ctypes_kind, interpreted, n, t
from tests.torch_parity import jax_script as _jax_script


def _interpret(kernel, shape):
    return pl.pallas_call(
        kernel, out_shape=jnp.zeros(shape, jnp.float32), interpret=True
    )


# ------------------------------------------------------------------ B12


@pytest.mark.parametrize("size", [16, 24, 128])
def test_band_matches_jax(size):
    jm = _jax_script("mxu_conv")
    taps = jm._taps()
    assert taps == sobolev_taps(7, 0.1)
    np.testing.assert_array_equal(mxu_conv.band(size, taps), jm._band(size, taps))


@pytest.mark.parametrize("reps", [1, 3])
def test_stencil_reference_matches_jax_vpu(reps):
    jm = _jax_script("mxu_conv")
    a = np.random.default_rng(10 + reps).standard_normal((2, 16, 24)).astype(np.float32)
    taps = jm._taps()
    want = _interpret(functools.partial(jm._kernel_vpu, taps=taps, reps=reps), a.shape)(a)
    got = mxu_conv.conv_yz_stencil(t(a), taps, reps)
    assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("reps", [1, 3])
def test_banded_reference_matches_jax_mxu(reps):
    jm = _jax_script("mxu_conv")
    a = np.random.default_rng(20 + reps).standard_normal((2, 16, 24)).astype(np.float32)
    taps = jm._taps()
    cy, cz = jm._band(16, taps), jm._band(24, taps)
    want = _interpret(functools.partial(jm._kernel_mxu, reps=reps), a.shape)(a, cy, cz)
    got = mxu_conv.conv_yz_banded_reference(t(a), t(cy), t(cz), reps)
    assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("reps", [1, 3])
def test_bf16_reference_matches_numpy(reps):
    def bf16(v):
        return np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))

    taps = sobolev_taps(7, 0.1)
    a = np.random.default_rng(30 + reps).standard_normal((2, 16, 32)).astype(np.float32)
    cy, cz = mxu_conv.band(16, taps), mxu_conv.band(32, taps)
    want = a
    for _ in range(reps):
        tmp = np.einsum("yY,xyz->xYz", bf16(cy), bf16(want))
        want = np.einsum("xYz,zZ->xYZ", bf16(tmp), bf16(cz))
    got = mxu_conv.conv_yz_banded_bf16(t(a), t(cy), t(cz), reps)
    assert_close(got, want, rtol=0, atol=1e-5)
    # bf16 operands are a real change from float32, not a no-op.
    f32 = mxu_conv.conv_yz_banded_f32(t(a), t(cy), t(cz), reps)
    assert float(torch.max(torch.abs(got - f32))) > 1e-4


def _extent_matrices():
    """Matrices for band_extents: the Sobolev bands at three sizes and tap
    counts, a dense random one, an all-zero one and one nonzero far off the
    diagonal."""
    rng = np.random.default_rng(40)
    off = np.zeros((128, 128), np.float32)
    off[5, 120] = -0.5
    return {
        **{f"band{k}_{size}": mxu_conv.band(size, sobolev_taps(k, 0.1))
           for size in (16, 48, 128) for k in (3, 7, 15)},
        "dense_48": rng.standard_normal((48, 48)).astype(np.float32),
        "zero_48": np.zeros((48, 48), np.float32),
        "offdiag_128": off,
    }


def _extents_brute(c, cols, step):
    """(first, last) k step holding a nonzero of each column group, by a
    scan of every block; (0, -1) where there is none."""
    out = []
    for g in range(c.shape[1] // cols):
        hit = [s for s in range(c.shape[0] // step)
               if np.any(c[s * step:(s + 1) * step, g * cols:(g + 1) * cols] != 0)]
        out.append((hit[0], hit[-1]) if hit else (0, -1))
    return np.array(out, np.int32)


@pytest.mark.parametrize("step", [8, 16])
@pytest.mark.parametrize("cols", [16, 8])
@pytest.mark.parametrize("name", sorted(_extent_matrices()))
def test_band_extents_match_brute_force(name, cols, step):
    c = _extent_matrices()[name]
    got = mxu_conv.band_extents(t(c), cols, step)
    assert got.dtype == torch.int32 and tuple(got.shape) == (c.shape[1] // cols, 2)
    want = _extents_brute(c, cols, step)
    np.testing.assert_array_equal(n(got), want)
    if name.startswith("dense"):
        assert (want == [0, c.shape[0] // step - 1]).all()
    if name.startswith("zero"):
        assert (want == [0, -1]).all()


def _skipping_product(a, cy, cz, bf16):
    """One conv pass as the banded kernels compute it: each 16-row m-tile of
    the y product and each 8-column n-tile of the z product sums only the
    k steps of its band extent."""
    step = 16 if bf16 else 8
    ey, ez = (n(e) for e in mxu_conv._extents(t(cy), t(cz), bf16))
    tmp = np.zeros(a.shape, np.float64)
    for mt, (first, last) in enumerate(ey):
        k = slice(first * step, (last + 1) * step)
        cols = slice(16 * mt, 16 * mt + 16)
        tmp[:, cols] = np.einsum("yY,xyz->xYz", cy[k, cols].astype(np.float64), a[:, k])
    out = np.zeros(a.shape, np.float64)
    for nt, (first, last) in enumerate(ez):
        k = slice(first * step, (last + 1) * step)
        cols = slice(8 * nt, 8 * nt + 8)
        out[..., cols] = np.einsum("xYz,zZ->xYZ", tmp[..., k], cz[k, cols].astype(np.float64))
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("kind", ["band7", "band15", "dense", "offdiag", "zero"])
def test_skipping_the_extents_keeps_the_product(kind, bf16):
    """The blocks outside the extents are zero, so walking only the extents
    gives the dense product (float64 sums against the float32 plain
    version: 1e-5 abs, outputs O(1))."""
    rng = np.random.default_rng(41)
    a = rng.standard_normal((2, 48, 80)).astype(np.float32)

    def matrix(size):
        if kind.startswith("band"):
            return mxu_conv.band(size, sobolev_taps(int(kind[4:]), 0.1))
        if kind == "dense":
            return (rng.standard_normal((size, size)) / np.sqrt(size)).astype(np.float32)
        c = np.zeros((size, size), np.float32)
        if kind == "offdiag":
            c[size // 8, size - 3] = 1.5
        return c

    cy, cz = matrix(48), matrix(80)
    want = mxu_conv.conv_yz_banded_reference(t(a), t(cy), t(cz), 1)
    assert_close(_skipping_product(a, cy, cz, bf16), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,tf32,bf16", [
    ("band7", 2544, 592), ("dense", 12288, 2048), ("zero", 0, 0)])
def test_mma_count_at_128(kind, tf32, bf16):
    """mma.sync a slice and pass at 128 x 128: the 7-tap band's extents
    (y: 30 TF32 steps over 8 m-tiles, z: 46 over 16 n-tiles) against the
    dense 16 steps a tile."""
    c = {"band7": t(mxu_conv.band(128, sobolev_taps(7, 0.1))),
         "dense": torch.ones(128, 128), "zero": torch.zeros(128, 128)}[kind]
    assert (mxu_conv.mma_count(c, c, False), mxu_conv.mma_count(c, c, True)) == (tf32, bf16)


@pytest.mark.parametrize("name", sorted(conv_yz_sweep.VARIANTS))
def test_conv_yz_sweep_variant_applies(name):
    """Each sweep variant's anchors occur once in csrc/conv_yz.cu."""
    text = conv_yz_sweep.variant_source(name)
    for _, new in conv_yz_sweep.VARIANTS[name]:
        assert new in text


def test_banded_argtypes_match_c_prototype():
    assert [ctypes_kind(a) for a in mxu_conv.BANDED_ARGTYPES] == c_prototype(
        "conv_yz.cu", "lsf_conv_yz_banded")


# ------------------------------------------------------------------ B11


@pytest.mark.parametrize("xb", [8, 16])
@pytest.mark.parametrize("body", fused_io_probe.BODIES)
def test_fused_io_reference_matches_jax(body, xb, monkeypatch):
    jm = interpreted(monkeypatch, "fused_io_probe")
    shape = (32, 16, 16)
    monkeypatch.setattr(jm, "SHAPE", shape)
    monkeypatch.setattr(jm, "CHAIN", 2)
    warped, canon, warp_cm = fused_io_probe.inputs(shape, "cpu")
    want = jm.make(body, xb)(n(warped), n(canon), n(warp_cm))
    got = fused_io_probe.fused_io_probe(*fused_io_probe.pad(warped, canon, warp_cm), body, xb)
    assert got.shape == (3, *shape)
    if body == "copy":
        np.testing.assert_array_equal(n(got), np.asarray(want))
    else:
        # XLA on the CPU contracts u + 0.1 d into an FMA, the port rounds
        # 0.1 d first: one rounding of |0.1 d| < 1, at most 6e-8.
        assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_fused_io_rolls_is_box27_edge_x_periodic_yz():
    rng = np.random.default_rng(5)
    shape = (6, 5, 7)
    w, c = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    u = rng.standard_normal((3,) + shape).astype(np.float32)
    we, ce, ue = fused_io_probe.pad(t(w), t(c), t(u))
    got = fused_io_probe.fused_io_probe(we, ce, ue, "rolls", 3)
    wx = np.pad(w.astype(np.float64), ((1, 1), (0, 0), (0, 0)), mode="edge")
    box = np.zeros(shape)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                box += np.roll(wx[1 + dx:1 + dx + shape[0]], (-dy, -dz), axis=(1, 2))
    assert_close(got, u + 0.1 * (box - c), rtol=0, atol=1e-5)


# ------------------------------------------------------------------ B10


def test_dma_reference_matches_jax_exactly():
    jm = _jax_script("dma_probe")
    a, u = dma_probe.inputs((jm.X, jm.Y, jm.Z), "cpu")
    want = jm.run(jnp.asarray(n(a)), jnp.asarray(n(u)), interpret=True)
    got = dma_probe.run(a, u)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert (dma_probe.XB, dma_probe.YB, dma_probe.HX, dma_probe.HY) == (
        jm.XB, jm.YB, jm.HX, jm.HY)


_PLAN_SHAPES = [(24, 32, 8), (32, 64, 128), (40, 48, 72), (128, 128, 128)]


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_dma_plan_covers_every_voxel_once(shape, sms):
    """The kernel's CTAs, as it reads blockIdx.x, write each output voxel
    once, each from its column's window."""
    p = dma_probe.plan(shape, sms)
    assert p.chunks <= shape[0] and (p.chunks - 1) * p.chunk < shape[0] <= p.chunks * p.chunk
    assert p.ctas <= max(sms, p.columns)
    count = np.zeros(shape, np.int32)
    for b in range(p.ctas):
        c = p.cta(b)
        assert 0 <= c["oy"] <= c["y0"] and c["y0"] + dma_probe.YB <= c["oy"] + dma_probe.YW
        assert c["s0"] == max(c["x0"] - dma_probe.HX, 0)
        assert c["s1"] == min(c["x1"] + dma_probe.HX, shape[0])
        count[c["x0"]:c["x1"], c["y0"]:c["y0"] + dma_probe.YB, c["z0"]:c["z1"]] += 1
    np.testing.assert_array_equal(count, 1)


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_dma_plan_windows_are_the_jax_probes(shape, sms):
    """Each column's y window starts where the JAX probe's ``offs`` clamps
    it: clip(j YB - HY, 0, Y - YW), with the script's constants."""
    jm = _jax_script("dma_probe")
    p = dma_probe.plan(shape, sms)
    for b in range(p.ctas):
        c = p.cta(b)
        j = c["y0"] // jm.YB
        assert c["oy"] == np.clip(j * jm.YB - jm.HY, 0, shape[1] - jm.YW)
    assert (dma_probe.XW, dma_probe.YW) == (jm.XW, jm.YW)


def _ring(p, b):
    """The ring schedule of ``csrc/dma_probe.cu`` for CTA ``b``, a twin of the
    kernel's ``issued`` and ``landed`` counters: yields ``(x, held, landed,
    issued)`` when plane x is computed: the plane in each slot (None if never
    filled), the last plane waited for and the last one issued."""
    c = p.cta(b)
    s0, last = c["s0"], c["s1"] - 1
    held = [None] * p.slots
    issued = s0

    def issue_to(limit):
        nonlocal issued
        while issued <= limit:
            held[(issued - s0) % p.slots] = issued
            issued += 1

    issue_to(min(last, s0 + p.slots - 1))  # before the loop
    landed = s0
    for x in range(c["x0"], c["x1"]):
        landed = max(landed, min(x + dma_probe.HX, p.shape[0] - 1) + 1)
        yield x, tuple(held), landed - 1, issued - 1
        issue_to(min(last, x - dma_probe.HX + p.slots))  # after the step's barrier


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_dma_ring_holds_the_haloed_window(shape, sms):
    """The kernel's ring schedule (``_ring``): when plane x is computed,
    planes x - HX .. x + HX (clamped) have landed and sit in their slots,
    AHEAD more are in flight where the chunk has them (more at X's low face,
    where the clamped window leaves slots free), and each staged plane is
    copied once, in order."""
    p = dma_probe.plan(shape, sms)
    hx, nx = dma_probe.HX, shape[0]
    for b in range(0, p.ctas, p.columns):  # one column's chunks: the rest repeat them
        c = p.cta(b)
        issued = None
        for x, held, landed, issued in _ring(p, b):
            for plane in range(max(x - hx, 0), min(x + hx, nx - 1) + 1):
                assert held[(plane - c["s0"]) % p.slots] == plane and plane <= landed
            assert landed == min(x + hx, nx - 1)
            assert issued - landed >= min(p.ahead, c["s1"] - 1 - landed)
            assert issued - max(x - hx, c["s0"]) < p.slots  # no resident plane overwritten
            assert issued == min(c["s1"] - 1, max(c["s0"] + p.slots - 1, x + hx + p.ahead))
        assert issued == c["s1"] - 1  # every staged plane, none twice (the counter only rises)


def test_dma_plan_moved_bytes_at_128():
    """The hand count at 128³ on 132 SMs: 32 columns (8 y tiles x 4 z tiles
    of 32), 4 chunks of 32 planes staging 37 + 42 + 42 + 37 = 158 planes a
    column; 3 fields x 2 (the y halo) x 158/128 + the output = 8.4
    volumes (70.5 MB)."""
    p = dma_probe.plan((128, 128, 128), 132)
    assert (p.columns, p.chunks, p.chunk, p.slots, p.ahead) == (32, 4, 32, 15, 4)
    assert p.staged_planes == 158
    vol = 4 * 128**3
    assert p.moved_bytes == 3 * 2 * vol * 158 // 128 + vol == 70_516_736


def test_dma_constants_match_the_source():
    src = (_lib.SOURCE_DIR / "dma_probe.cu").read_text()
    for line in (f"constexpr int kXB = {dma_probe.XB}, kYB = {dma_probe.YB}, "
                 f"kZB = {dma_probe.ZB};",
                 f"constexpr int kHX = {dma_probe.HX}, kHY = {dma_probe.HY};",
                 f"constexpr int kZT = {dma_probe.ZT};",
                 f"constexpr int kAhead = {dma_probe.AHEAD};",
                 "constexpr int kSlots = 2 * kHX + 1 + kAhead;"):
        assert line in src


def test_dma_argtypes_match_c_prototype():
    assert [ctypes_kind(a) for a in dma_probe.ARGTYPES] == c_prototype(
        "dma_probe.cu", "lsf_dma_probe")


@pytest.mark.parametrize("name", sorted(dma_probe_sweep.VARIANTS))
def test_dma_probe_sweep_variant_applies(name):
    """Each sweep variant's anchors occur once in csrc/dma_probe.cu."""
    zt, ahead, _, subs = dma_probe_sweep.VARIANTS[name]
    text = dma_probe_sweep.variant_source(name)
    assert f"constexpr int kZT = {zt};" in text and f"constexpr int kAhead = {ahead};" in text
    for _, new in subs:
        assert new in text


def test_dma_probe_sweep_needs_the_gpu():
    with pytest.raises(RuntimeError):
        dma_probe_sweep.main(device="cpu")


# ------------------------------------------------- wrappers on CPU tensors


def _wrapper_calls():
    """(name, counter getter, call on valid CPU inputs) per kernel wrapper."""
    taps = sobolev_taps(7, 0.1)
    a = torch.randn(2, 16, 32)
    cy, cz = t(mxu_conv.band(16, taps)), t(mxu_conv.band(32, taps))
    we, ce, ue = fused_io_probe.pad(*fused_io_probe.inputs((8, 4, 4), "cpu"))
    da, du = dma_probe.inputs((24, 32, 8), "cpu")
    return {
        "conv_yz_stencil": (lambda: mxu_conv.launch_counts["stencil"],
                            lambda: mxu_conv.conv_yz_stencil(a, taps, 2)),
        "conv_yz_banded_f32": (lambda: mxu_conv.launch_counts["banded_f32"],
                               lambda: mxu_conv.conv_yz_banded_f32(a, cy, cz, 2)),
        "conv_yz_banded_bf16": (lambda: mxu_conv.launch_counts["banded_bf16"],
                                lambda: mxu_conv.conv_yz_banded_bf16(a, cy, cz, 2)),
        "fused_io_probe": (lambda: fused_io_probe.launch_count,
                           lambda: fused_io_probe.fused_io_probe(we, ce, ue, "rolls", 4)),
        "dma_probe": (lambda: dma_probe.launch_count, lambda: dma_probe.run(da, du)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_wrapper_cpu_takes_plain_path(name):
    count, call = _wrapper_calls()[name]
    before = count()
    out = call()
    assert out.device.type == "cpu" and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert count() == before == 0


def _bad_calls():
    taps = sobolev_taps(7, 0.1)
    a = torch.randn(2, 16, 32)
    cy, cz = t(mxu_conv.band(16, taps)), t(mxu_conv.band(32, taps))
    we, ce, ue = fused_io_probe.pad(*fused_io_probe.inputs((8, 4, 4), "cpu"))
    da, du = dma_probe.inputs((24, 32, 8), "cpu")
    return {
        "stencil dtype": (TypeError, lambda: mxu_conv.conv_yz_stencil(a.double(), taps, 1)),
        "stencil strided": (ValueError, lambda: mxu_conv.conv_yz_stencil(
            a.transpose(1, 2), taps, 1)),
        "stencil even taps": (ValueError, lambda: mxu_conv.conv_yz_stencil(a, taps[1:], 1)),
        "stencil smem": (ValueError, lambda: mxu_conv.conv_yz_stencil(
            torch.zeros(1, 128, 256), taps, 1)),
        "banded dtype": (TypeError, lambda: mxu_conv.conv_yz_banded_f32(a, cy.double(), cz, 1)),
        "banded shape": (ValueError, lambda: mxu_conv.conv_yz_banded_f32(
            torch.zeros(2, 16, 24), cy, t(mxu_conv.band(24, taps)), 1)),
        "banded plane": (ValueError, lambda: mxu_conv.conv_yz_banded_bf16(
            torch.zeros(1, 256, 128), t(mxu_conv.band(256, taps)), t(mxu_conv.band(128, taps)), 1)),
        "banded band": (ValueError, lambda: mxu_conv.conv_yz_banded_f32(a, cz, cz, 1)),
        "banded strided": (ValueError, lambda: mxu_conv.conv_yz_banded_bf16(
            a, cy.t(), cz, 1)),
        "extents ndim": (ValueError, lambda: mxu_conv.band_extents(cy[0], 8, 8)),
        "extents rows": (ValueError, lambda: mxu_conv.band_extents(cy[:12], 8, 8)),
        "extents cols": (ValueError, lambda: mxu_conv.band_extents(cy, 12, 8)),
        "io dtype": (TypeError, lambda: fused_io_probe.fused_io_probe(
            we.half(), ce, ue, "copy", 4)),
        "io shape": (ValueError, lambda: fused_io_probe.fused_io_probe(
            we, ce, ue[:2], "copy", 4)),
        "io xb": (ValueError, lambda: fused_io_probe.fused_io_probe(we, ce, ue, "copy", 3)),
        "io body": (ValueError, lambda: fused_io_probe.fused_io_probe(we, ce, ue, "fma", 4)),
        "io strided": (ValueError, lambda: fused_io_probe.fused_io_probe(
            we, ce, ue.transpose(2, 3), "arith", 4)),
        "dma dtype": (TypeError, lambda: dma_probe.run(da.double(), du)),
        "dma shape": (ValueError, lambda: dma_probe.run(da, du[:1])),
        "dma x extent": (ValueError, lambda: dma_probe.run(da[:16], du[:, :16])),
        "dma strided": (ValueError, lambda: dma_probe.run(
            torch.zeros(24, 8, 32).transpose(1, 2), du)),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects_bad_input(case):
    error, call = _bad_calls()[case]
    with pytest.raises(error):
        call()


# ----------------------------------------------------- entry points on CPU


def test_mxu_conv_run_cpu():
    out = mxu_conv.run(shape=(2, 16, 16), reps=2, device="cpu")
    assert out["device"] == "cpu" and out["shape"] == [2, 16, 16]
    assert out["parity_max_abs_err"] <= 1e-5
    assert 1e-4 < out["bf16_vs_f32_max_abs_err"] < 0.1
    for key in ("stencil", "tc_f32", "tc_bf16"):
        assert np.isfinite(out[f"{key}_us_per_convpass"])


def test_fused_io_probe_main_cpu(capsys):
    rows = fused_io_probe.main(device="cpu", shape=(8, 4, 4), chain=2, xbs=(4, 8))
    assert [(r["body"], r["xb"]) for r in rows] == [
        (b, x) for b in fused_io_probe.BODIES for x in (4, 8)]
    assert all(r["ms"] > 0 and r["gbs"] > 0 for r in rows)
    assert capsys.readouterr().out.count("[cpu]") == 6
    assert fused_io_probe.plan_bytes((128, 128, 128)) == 70_385_664


def test_dma_probe_main_cpu():
    out = dma_probe.main(device="cpu", timed_shape=(24, 32, 8))
    assert out["max_abs_err"] == 0.0 and out["shape"] == [32, 64, 128]
    p = dma_probe.plan((24, 32, 8), dma_probe.H100_SMS)
    assert out["plan"] == dma_probe.describe(p)
    assert out["moved_gbs"] / out["useful_gbs"] == pytest.approx(
        p.moved_bytes / (16 * 24 * 32 * 8))


def test_fused_ablation_main_cpu():
    out = fused_ablation.main(device="cpu", shape=(12, 12, 12), n1=1, n2=2)
    assert out["shape"] == [12, 12, 12] and out["device"] == "cpu"
    assert list(out["ms_per_kernel_call"]) == [
        "full(kill+ls+sob)", "no_sobolev", "no_levelset", "tikhonov", "data_only"]


def test_fused_gradient_bench_main_cpu():
    out = fused_gradient_bench.main(device="cpu", shape=(12, 12, 12), n1=1, n2=2)
    assert list(out["ms"]) == list(fused_gradient_bench.VARIANTS)
    assert np.isfinite(out["plain_step_ms"]) and "full_speedup_vs_plain" in out


def test_plain_step_matches_fused_reference():
    """The bench's plain step is the fused kernel's full variant."""
    canonical, warped, warp = fused_gradient_bench._fields((10, 9, 8), "cpu")
    rate = torch.tensor(0.3)
    kernel = torch.from_numpy(mxu_conv.sobolev.generate_1d_sobolev_kernel(7, 0.1))
    want = fused_gradient_bench.plain_step(warped, canonical, warp, rate, kernel)
    got, _ = fused_gradient_bench.fused_gradient_update(
        warped, canonical, warp.movedim(-1, 0).contiguous(), rate, w_data=1.0,
        w_smooth=0.1, w_ls=0.1, killing=True, gamma=0.1, band_union=True,
        taps=sobolev_taps(7, 0.1))
    assert_close(got.movedim(0, -1), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("entry", [
    lambda: mxu_conv.run(shape=(2, 16, 16), reps=2),
    lambda: fused_io_probe.main(shape=(8, 4, 4)),
    lambda: dma_probe.main(),
    lambda: fused_ablation.main(shape=(12, 12, 12)),
    lambda: fused_gradient_bench.main(shape=(12, 12, 12)),
], ids=["mxu_conv", "fused_io_probe", "dma_probe", "fused_ablation",
        "fused_gradient_bench"])
def test_entry_point_requires_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the refusal applies only without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


# ---------------------------------------------------------- rebuild rule


def test_lib_is_stale_follows_source_and_headers(tmp_path):
    src, header, lib = tmp_path / "k.cu", tmp_path / "common.cuh", tmp_path / "libk.so"
    for p in (src, header):
        p.write_text("")
    assert _lib.is_stale(lib, src)  # never built
    lib.write_bytes(b"")

    def age(p, seconds):
        os.utime(p, (seconds, seconds))

    age(src, 100), age(header, 100), age(lib, 200)
    assert not _lib.is_stale(lib, src)
    age(src, 300)
    assert _lib.is_stale(lib, src)
    age(src, 100), age(header, 300)
    assert _lib.is_stale(lib, src)  # a header changed: the .so is stale
    (tmp_path / "other.cu").write_text("")
    age(header, 100), age(tmp_path / "other.cu", 300)
    assert not _lib.is_stale(lib, src)  # another kernel's source does not count
