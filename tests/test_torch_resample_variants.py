"""Parity of the port's resample design-space experiments
(levelsetfusion_tpu_torch/experiments/resample_variants.py, v10_xslab.py)
with the JAX scripts experiments/resample_variants.py and v10_xslab.py,
which are loaded by path; their Pallas kernels run in interpret mode on the
CPU, and the port's wrappers take their plain torch versions for CPU
tensors (chip_smoke.py holds the CUDA kernels against the same plain
versions on the card).

Tolerance abs 1e-6 against JAX: both sum the same 37 terms in the same
order, each below 1 in magnitude, but XLA on the CPU may contract a product
and the running sum into one FMA, which skips one rounding (at most 6e-8)
per term. Against the golden ``warp_field`` (the port's, on the clamped
warp) abs 1e-5: the enumeration and the 8-corner trilinear sum round in
another order (4.7e-6 measured at these shapes).

Z must be 128 (the TPU lane width fixes the z bounds), so the shapes are
(4, 16, 128) and (8, 16, 128), and (3, 12, 128) for B3's runtime geometry
(a Y that is not a multiple of its 8-row tiles)."""

import functools

import numpy as np
import pytest
import torch

from levelsetfusion_tpu_torch.experiments import resample_variants as rv
from levelsetfusion_tpu_torch.experiments import resample_variants_sweep, v10_xslab
from levelsetfusion_tpu_torch.ops.interpolation import warp_field
from tests.torch_parity import (
    REPO,
    assert_close,
    c_prototype,
    ctypes_kind,
    interpreted,
    n,
    t,
)

SMALL = (4, 16, 128)
SLAB = (8, 16, 128)
VALUE_PRESERVING = [v for v in rv.KERNELS if v not in rv.TIMING_ONLY] + [
    "vf_fori_yb16", "vf_chunk_yb16", "vf_unroll_yb16", "v7_chunk_yb16", "v7_unroll_yb16"]


@pytest.fixture
def interpret(monkeypatch):
    """The JAX script ``name`` with its Pallas kernels in interpret mode."""
    return functools.partial(interpreted, monkeypatch)


def _inputs(shape, seed, scale=1.5):
    """A field in (-1, 1) and a raw warp with many |ux|, |uy| > 2."""
    rng = np.random.default_rng(seed)
    field = np.tanh(rng.standard_normal(shape) * 0.3).astype(np.float32)
    warp = (rng.standard_normal(shape + (3,)) * scale).astype(np.float32)
    return field, warp


# ------------------------------------------------------ kernels vs JAX


@pytest.mark.parametrize("variant", sorted(rv.KERNELS))
def test_b3_variant_matches_jax(variant, interpret):
    jm = interpret("resample_variants")
    field, warp = _inputs(SMALL, 1)
    want = jm.run_variant(field, warp, variant=variant)
    got = rv.run_variant(t(field), t(warp), variant=variant)
    assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("inner", rv.VMEMFULL_INNERS)
def test_b4_vmemfull_matches_jax(inner, interpret):
    jm = interpret("resample_variants")
    field, warp = _inputs(SMALL, 2)
    want = jm.run_vmemfull(field, warp, inner=inner, yb=16)
    got = rv.run_vmemfull(t(field), t(warp), inner=inner, yb=16)
    assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("structure", rv.V7_STRUCTURES)
def test_b5_v7_matches_jax(structure, interpret):
    jm = interpret("resample_variants")
    field, warp = _inputs(SMALL, 3)
    want = jm.run_v7(field, warp, structure=structure, yb=16)
    got = rv.run_v7(t(field), t(warp), structure=structure, yb=16)
    assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("xb", [2, 4])
def test_b6_v10_matches_jax(xb, chunk, interpret):
    jm = interpret("v10_xslab")
    field, warp = _inputs(SLAB, 4)
    want = jm.run_v10(field, warp, xb=xb, yb=16, chunk=chunk)
    got = v10_xslab.run_v10(t(field), t(warp), xb=xb, yb=16, chunk=chunk)
    assert_close(got, want, rtol=0, atol=1e-6)


def test_b6_smooth_warp_matches_jax(interpret):
    """On a smooth warp the active range is narrower than the full 6 x 6."""
    jm = interpret("v10_xslab")
    field, warp = _inputs(SLAB, 5, scale=0.3)
    want = jm.run_v10(field, warp, xb=4, yb=16, chunk=8)
    got = v10_xslab.run_v10(t(field), t(warp), xb=4, yb=16, chunk=8)
    assert_close(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------- value and semantics


@pytest.mark.parametrize("variant", VALUE_PRESERVING + ["v10"])
def test_value_preserving_variant_is_golden_resample(variant):
    field, warp = (t(a) for a in _inputs(SMALL, 6))
    if variant == "v10":
        got = v10_xslab.run_v10(field, warp, xb=2, yb=16, chunk=4)
    else:
        got = rv.variant_call(variant)(field, warp)
    want = warp_field(field, rv.clamp_warp(warp))
    assert_close(got, want, rtol=0, atol=1e-5)


def test_static00_equals_noslice():
    field, warp = (t(a) for a in _inputs(SMALL, 7))
    a = rv.run_variant(field, warp, "static00")
    b = rv.run_variant(field, warp, "noslice")
    np.testing.assert_array_equal(n(a), n(b))
    # ... and both differ from the resample: the rows are fixed at (0, 0).
    assert float(torch.max(torch.abs(a - rv.run_variant(field, warp, "v6")))) > 0.1


def test_timing_only_bodies_by_formula():
    field, warp = (t(a) for a in _inputs(SMALL, 8))
    ux = warp[..., 0].clamp(-2, 2)
    padded = torch.nn.functional.pad(field, (0, 0, 2, 3, 2, 3), value=1.0)
    assert_close(rv.run_variant(field, warp, "passthrough"),
                 padded[:4, :16] + ux, rtol=0, atol=0)
    # onepair = the full sum restricted to the centre shift with no z shift.
    still = warp.clone()
    still[..., :2] = 0.0
    still[..., 2] = 0.0
    assert_close(rv.run_variant(field, still, "onepair"), padded[:4, :16], rtol=0,
                 atol=0)


# --------------------------------------------------- wrappers on the CPU


def _wrappers():
    return {
        "run_variant": lambda f, w: rv.run_variant(f, w, "unroll"),
        "run_vmemfull": lambda f, w: rv.run_vmemfull(f, w, "chunk", yb=8),
        "run_v7": lambda f, w: rv.run_v7(f, w, "unroll", yb=8),
        "run_v10": lambda f, w: v10_xslab.run_v10(f, w, xb=2, yb=8, chunk=4),
    }


def _counter(name):
    return v10_xslab.launch_count if name == "run_v10" else rv.launch_counts[name]


@pytest.mark.parametrize("name", sorted(_wrappers()))
def test_wrapper_cpu_takes_plain_path(name):
    field, warp = (t(a) for a in _inputs(SMALL, 9))
    out = _wrappers()[name](field, warp)
    assert out.shape == SMALL and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert _counter(name) == 0


def _bad_inputs():
    field, warp = (t(a) for a in _inputs(SMALL, 10))
    zf, zw = (t(a) for a in _inputs((4, 16, 64), 10))
    return {
        "z not 128": (ValueError, zf, zw),
        "y not a multiple of yb": (ValueError, field[:, :12].contiguous(),
                                   warp[:, :12].contiguous()),
        "dtype": (TypeError, field.double(), warp.double()),
        "strided": (ValueError, field, warp.transpose(0, 1).contiguous().transpose(0, 1)),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
@pytest.mark.parametrize("name", sorted(_wrappers()))
def test_wrapper_rejects_bad_input(name, case):
    error, field, warp = _bad_inputs()[case]
    with pytest.raises(error):
        _wrappers()[name](field, warp)


@pytest.mark.parametrize("call", [
    lambda f, w: rv.run_variant(f, w, "v9"),
    lambda f, w: rv.run_vmemfull(f, w, "twolevel"),
    lambda f, w: rv.run_v7(f, w, "fori"),
    lambda f, w: rv.run_variant(f, w, "v6", k=3),
    lambda f, w: v10_xslab.run_v10(f, w, xb=3, yb=16, chunk=4),  # xb does not divide X
    lambda f, w: v10_xslab.run_v10(f, w, xb=4, yb=16, chunk=6),  # chunk not a multiple of xb
    lambda f, w: v10_xslab.run_v10(f, w, xb=4, yb=16, chunk=8),  # chunk does not divide X
], ids=["variant", "inner", "structure", "k", "xb", "chunk xb", "chunk x"])
def test_wrapper_rejects_bad_option(call):
    field, warp = (t(a) for a in _inputs(SMALL, 11))
    with pytest.raises(ValueError):
        call(field, warp)


# ------------------------------------------------- entry points on the CPU


def test_resample_variants_main_cpu(capsys):
    names = list(rv.KERNELS) + ["vf_fori", "vf_unroll_yb8", "v7_chunk"]
    rows = rv.main(device="cpu", names=names, shape=(2, 64, 128))
    assert [r["variant"] for r in rows] == names
    assert capsys.readouterr().out.count('"device": "cpu"') == len(names)
    for r in rows:
        assert r["us_per_call"] > 0
        if r["variant"] in rv.TIMING_ONLY:
            assert r["max_abs_err_vs_golden"] is None
        else:
            assert r["max_abs_err_vs_golden"] <= 1e-5
    assert sum(rv.launch_counts.values()) == 0


def test_resample_variants_inputs_are_the_scripts():
    field, warp = rv.inputs((2, 8, 128), "cpu")
    rng = np.random.default_rng(0)
    want_field = np.tanh(rng.standard_normal((2, 8, 128)) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(n(field), want_field)
    assert warp.shape == (2, 8, 128, 3) and warp.dtype == torch.float32


def test_v10_main_cpu():
    rows = v10_xslab.main(device="cpu", shape=(128, 8, 128), xbs=(4, 8), yb=8,
                          chains=(1, 2))
    assert [(r["warp"], r["xb"]) for r in rows] == [
        (w, x) for w in ("random", "smooth") for x in (4, 8)]
    assert all(r["max_abs_err"] <= 1e-5 and np.isfinite(r["ms_per_call"]) for r in rows)
    assert v10_xslab.launch_count == 0


def test_v10_smooth_warp_is_the_scripts():
    """The smooth warp as the script builds it: uy is the cosine along x."""
    _, warps = v10_xslab.inputs((128, 2, 128), "cpu")
    (tag, scale, random), (tag2, scale2, smooth) = warps
    assert (tag, scale, tag2, scale2) == ("random", 1.5, "smooth", 0.5)
    xs = np.linspace(0, 2 * np.pi, 128, dtype=np.float32)
    np.testing.assert_array_equal(n(smooth[:, 1, 7, 1]), 0.5 * np.cos(xs))
    np.testing.assert_array_equal(n(smooth[3, 0, :, 2]), 0.5 * np.sin(2 * xs))


@pytest.mark.parametrize("entry", [
    lambda: rv.main(names=["v6"], shape=(2, 64, 128)),
    lambda: v10_xslab.main(shape=(128, 8, 128), yb=8),
], ids=["resample_variants", "v10_xslab"])
def test_entry_point_requires_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the refusal applies only without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


@pytest.mark.parametrize("name,argtypes", [
    ("lsf_v10_xslab", v10_xslab.XSLAB_ARGTYPES),
    ("lsf_v10_partials_len", v10_xslab.PARTIALS_ARGTYPES),
    ("lsf_v10_ctas", v10_xslab.CTAS_ARGTYPES),
])
def test_v10_argtypes_match_c_prototype(name, argtypes):
    """A mismatch would pass arguments in the wrong registers at launch,
    which nothing on the CPU can see."""
    assert [ctypes_kind(a) for a in argtypes] == c_prototype("v10_xslab.cu", name)


@pytest.mark.parametrize("name,argtypes", [
    ("lsf_resample_variant", rv.VARIANT_ARGTYPES),
    ("lsf_resample_variant_tiled", rv.TILED_ARGTYPES),
    ("lsf_resample_variant_ring", rv.RING_ARGTYPES),
])
def test_resample_variant_argtypes_match_c_prototype(name, argtypes):
    """A mismatch would pass arguments in the wrong registers at launch,
    which nothing on the CPU can see."""
    assert [ctypes_kind(a) for a in argtypes] == c_prototype("resample_variants.cu", name)


# ----------------------------------------------------- B3's launch geometry

B3_SHAPES = [SMALL, (2, 64, 128), (20, 64, 128), (128, 128, 128), (3, 12, 128), (2, 8, 128),
             (2, 200, 128)]
MAX_DYNAMIC_SMEM = 232448  # bytes of dynamic shared memory a CTA may use on the H100


def _b3_accepts(shape, variant):
    field = torch.empty(shape)
    try:
        rv.check_inputs(field, torch.empty(shape + (3,)), min(rv.KERNELS[variant][2], shape[1]),
                        rv.K)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("shape", B3_SHAPES, ids=str)
def test_b3_geometry_fits_shared_memory(shape):
    """Every accepted shape and variant gets a launch whose staged rows fit
    a CTA's shared memory, covering Y with its tiles."""
    accepted = [v for v in rv.KERNELS if _b3_accepts(shape, v)]
    assert accepted
    for variant in accepted:
        g = rv.b3_geometry(shape, variant)
        assert 0 < g["smem_bytes"] <= MAX_DYNAMIC_SMEM
        assert g["staged_rows"] == g["tile_rows"] + 5 and shape[1] % g["tile_rows"] == 0
        assert g["ctas"] >= shape[0]


def test_b3_geometry_picks_the_compile_time_tiles():
    """The compile-time tiles at 128^3 and at chip_smoke's ragged X (their Y
    is a multiple of 8: the geometry does not depend on X); the runtime
    geometry where Y is not."""
    full = rv.b3_geometry((128, 128, 128))
    assert full == {"kernel": "tiled", "tile_rows": 8, "staged_rows": 13,
                    "smem_bytes": 79872, "ctas": 256}
    assert rv.b3_geometry((20, 64, 128))["kernel"] == "tiled"
    for shape, variant in (((3, 12, 128), "v6"), ((3, 4, 128), "unroll"),
                           ((3, 20, 128), "yb128")):
        g = rv.b3_geometry(shape, variant)
        assert g["kernel"] == "window" and g["tile_rows"] == shape[1]
        assert g["smem_bytes"] == 6 * (shape[1] + 5) * 512 and g["ctas"] == 3


def test_b3_geometry_matches_the_kernel_source():
    """The wrapper's tile constants are the kernel's."""
    src = (REPO / "levelsetfusion_tpu_torch" / "csrc" / "resample_variants.cu").read_text()
    assert f"constexpr int kTileRows = {rv.B3_TILE_ROWS};" in src
    assert f"constexpr int kCtaRows = {rv.B3_CTA_ROWS};" in src
    assert f"{rv.b3_geometry((128, 128, 128))['smem_bytes']:,} B" in src


def test_b3_ragged_y_matches_jax(interpret):
    """A Y that is not a multiple of 8 (yb = Y), the runtime geometry's
    shape, through the JAX script and the port."""
    jm = interpret("resample_variants")
    field, warp = _inputs((3, 12, 128), 12)
    want = jm.run_variant(field, warp, variant="v6")
    got = rv.run_variant(t(field), t(warp), variant="v6")
    assert_close(got, want, rtol=0, atol=1e-6)


# ----------------------------------------------------- B4's launch geometry

B4_SHAPES = [SMALL, (2, 64, 128), (20, 64, 128), (128, 128, 128), (3, 12, 128), (5, 6, 128),
             (2, 8, 128), (2, 200, 128), (3, 4, 128)]


def _b4_accepts(shape, yb):
    try:
        rv.check_inputs(torch.empty(shape), torch.empty(shape + (3,)), yb, rv.K)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("shape", B4_SHAPES, ids=str)
def test_b4_geometry_fits_shared_memory(shape):
    """Every accepted shape and y block (the script's 8, 16, 64, 128, or Y)
    gets a launch whose staged rows fit a CTA's shared memory, covering Y
    with its tiles."""
    ybs = [yb for yb in sorted({8, 16, 64, 128, shape[1]}) if _b4_accepts(shape, yb)]
    assert ybs
    for yb in ybs:
        for inner in rv.VMEMFULL_INNERS:
            g = rv.b4_geometry(shape, yb, inner)
            assert 0 < g["smem_bytes"] <= MAX_DYNAMIC_SMEM
            assert g["smem_bytes"] == 7 * g["staged_rows"] * rv.LANE * 4
            assert g["staged_rows"] == g["tile_rows"] + 5 and shape[1] % g["tile_rows"] == 0
            assert g["ctas"] >= 1


def test_b4_geometry_picks_the_ring():
    """The compile-time ring at 128^3 and at chip_smoke's ragged X, one wave
    of CTAs (at most one a (tile, x row) step); the runtime geometry where Y
    is not a multiple of the ring's tile."""
    assert rv.b4_geometry((128, 128, 128)) == {
        "kernel": "ring", "tile_rows": 8, "staged_rows": 13, "smem_bytes": 46592, "ctas": 528}
    assert rv.b4_geometry((128, 128, 128), 64, "unroll")["ctas"] == 264
    assert rv.b4_geometry((20, 64, 128))["kernel"] == "ring"
    assert rv.b4_geometry((2, 16, 128), 16)["ctas"] == 4
    assert rv.b4_geometry((5, 6, 128), 6) == {
        "kernel": "window", "tile_rows": 2, "staged_rows": 7, "smem_bytes": 7 * 7 * 512,
        "ctas": 3}
    assert rv.b4_geometry((3, 12, 128), 12)["kernel"] == "window"


def test_b4_geometry_matches_the_kernel_source():
    """The wrapper's ring constants are the kernel's."""
    src = (REPO / "levelsetfusion_tpu_torch" / "csrc" / "resample_variants.cu").read_text()
    ctas = rv.B4_CTAS_PER_SM
    assert set(ctas) == set(rv.VMEMFULL_INNERS) and ctas["chunk"] == ctas["unroll"]
    assert f"constexpr int kRingTY = {rv.B4_TILE_ROWS};" in src
    assert f"constexpr int kRingCtas = L == kPairLoop ? {ctas['fori']} : {ctas['chunk']};" in src
    assert f"{rv.b4_geometry((128, 128, 128))['smem_bytes']:,} B" in src


@pytest.mark.parametrize("inner", rv.VMEMFULL_INNERS)
def test_b4_window_shape_matches_jax(inner, interpret):
    """A Y that is not a multiple of the ring's tile (yb = Y), the runtime
    geometry's shape, through the JAX script and the port."""
    jm = interpret("resample_variants")
    field, warp = _inputs((3, 6, 128), 13)
    assert rv.b4_geometry(field.shape, 6, inner)["kernel"] == "window"
    want = jm.run_vmemfull(field, warp, inner=inner, yb=6)
    got = rv.run_vmemfull(t(field), t(warp), inner=inner, yb=6)
    assert_close(got, want, rtol=0, atol=1e-6)


# ----------------------------------------------------- B5's launch geometry


@pytest.mark.parametrize("shape", B4_SHAPES, ids=str)
def test_b5_geometry_fits_shared_memory(shape):
    """Every accepted shape and y block gets a B5 launch whose staged rows
    fit a CTA's shared memory, covering Y with its tiles."""
    ybs = [yb for yb in sorted({8, 16, 64, 128, shape[1]}) if _b4_accepts(shape, yb)]
    assert ybs
    for yb in ybs:
        for structure in rv.V7_STRUCTURES:
            g = rv.b5_geometry(shape, yb, structure)
            assert 0 < g["smem_bytes"] <= MAX_DYNAMIC_SMEM
            assert g["staged_rows"] == g["tile_rows"] + 5 and shape[1] % g["tile_rows"] == 0
            assert g["ctas"] >= 1


def test_b5_geometry_picks_the_ring():
    """B5 takes the ring at 128^3 and at chip_smoke's ragged X (two CTAs an
    SM for chunk and unroll), the runtime window kernel where Y is not a
    multiple of 8."""
    for structure in rv.V7_STRUCTURES:
        assert rv.b5_geometry((128, 128, 128), 64, structure) == {
            "kernel": "ring", "tile_rows": 8, "staged_rows": 13, "smem_bytes": 46592,
            "ctas": 264}
        assert rv.b5_geometry((20, 64, 128), 64, structure)["kernel"] == "ring"
        assert rv.b5_geometry((5, 6, 128), 6, structure) == {
            "kernel": "window", "tile_rows": 2, "staged_rows": 7, "smem_bytes": 7 * 7 * 512,
            "ctas": 3}
        assert rv.b5_geometry((3, 12, 128), 12, structure) == {
            "kernel": "window", "tile_rows": 4, "staged_rows": 9, "smem_bytes": 7 * 9 * 512,
            "ctas": 3}
    with pytest.raises(ValueError):
        rv.b5_geometry((128, 128, 128), 64, "fori")


def test_b5_geometry_matches_the_kernel_source():
    """B5's ring is B4's, its chunk loop summing a thread's voxels together
    and its launch bounds those of B4's chunk and unroll."""
    src = (REPO / "levelsetfusion_tpu_torch" / "csrc" / "resample_variants.cu").read_text()
    assert "constexpr bool kRingPaired = L == kChunk;" in src
    assert "template <int L, bool kTentsOnce>\n__global__ void __launch_bounds__(kThreads, " \
           "kRingCtas<L>) ring_kernel(Params p)" in src
    assert "if (loop == kChunk) return launch_ring<kChunk, true>(p, s);" in src
    assert "if (loop == kUnroll) return launch_ring<kUnroll, true>(p, s);" in src
    ctas = rv.b5_geometry((128, 128, 128))["ctas"] // rv.H100_SMS
    assert f"constexpr int kRingCtas = L == kPairLoop ? 4 : {ctas};" in src


@pytest.mark.parametrize("structure", rv.V7_STRUCTURES)
def test_b5_window_shape_matches_jax(structure, interpret):
    """A Y that is not a multiple of the ring's tile (yb = Y), B5's runtime
    geometry, through the JAX script and the port."""
    jm = interpret("resample_variants")
    field, warp = _inputs((3, 6, 128), 14)
    assert rv.b5_geometry(field.shape, 6, structure)["kernel"] == "window"
    want = jm.run_v7(field, warp, structure=structure, yb=6)
    got = rv.run_v7(t(field), t(warp), structure=structure, yb=6)
    assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(resample_variants_sweep.VARIANTS))
def test_ring_sweep_variant_applies_to_the_kernel_source(name):
    """Every substitution of the ring sweep finds its anchor exactly once in
    csrc/resample_variants.cu with resample_z.cuh inlined, so each variant
    built on the card is the one the sweep names."""
    text = resample_variants_sweep.variant_source(name)
    assert "__global__" in text and "pair_sum" in text
    assert '#include "resample_z.cuh"' not in text and "#pragma once" not in text
    assert (text != resample_variants_sweep.variant_source("base")) == (name != "base")
    for _, new in resample_variants_sweep.VARIANTS[name]:
        assert new in text
    # B5's variants: its chunk one voxel at a time, its unroll paired too.
    loops = resample_variants_sweep.sass_loops(name)
    assert loops["ring_kernel<2,1>"] == (6, 1 if name == "v7_single" else
                                         {"ty4": 1, "ty16": 4}.get(name, 2))
    assert loops["ring_kernel<3,1>"][1] == (2 if name == "v7_unroll_paired" else 1)


def test_ring_sweep_needs_the_gpu():
    with pytest.raises(RuntimeError):
        resample_variants_sweep.main(device="cpu")
