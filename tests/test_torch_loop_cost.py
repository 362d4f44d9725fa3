"""Parity of the port's pair-loop cost experiment
(levelsetfusion_tpu_torch/experiments/loop_cost.py) with the JAX script
experiments/loop_cost.py, which is loaded by path; its Pallas kernel runs in
interpret mode on the CPU, and the port's wrapper takes its plain torch
version for CPU tensors (chip_smoke.py holds the CUDA kernel,
csrc/stack_bodies.cu, against the same plain version on the card).

Tolerance abs 1e-6 against JAX: the bodies add stack values, or products of
stack values with 0.5 and 0.25, which are exact, so a product contracted
into an FMA by XLA rounds as the separate operations do, and both sum in the
same order (max|Δ| 0 measured). The script fixes X = 128 and Z = 128; Y is
16 at yb 8 and 16.

Also: the wrapper's input checks and launch counter, the entry point on the
CPU, and the script's inputs drawn number for number."""

import functools
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from levelsetfusion_tpu_torch.experiments import _sweep
from levelsetfusion_tpu_torch.experiments import loop_cost as lc
from tests.torch_parity import (
    REPO,
    assert_close,
    c_enum,
    c_prototype,
    ctypes_kind,
    interpreted,
    n,
    t,
)

X, Y = 128, 16


@pytest.fixture
def interpret(monkeypatch):
    """The JAX script ``name`` with its Pallas kernels in interpret mode."""
    return functools.partial(interpreted, monkeypatch)


def _stack_inputs(nx, ny, seed, xpad=None):
    """A random stack (6, xpad, Y, 128) with independent planes, as the
    script's, and a 1.5 N(0, 1) warp."""
    rng = np.random.default_rng(seed)
    stacked = rng.standard_normal((lc.N, xpad or nx + lc.N, ny, lc.LANE)).astype(np.float32)
    warp = (rng.standard_normal((nx, ny, lc.LANE, 3)) * 1.5).astype(np.float32)
    return stacked, warp


@pytest.mark.parametrize("yb", [8, 16])
@pytest.mark.parametrize("loop", lc.LOOP_KINDS)
@pytest.mark.parametrize("body", lc.BODY_KINDS)
def test_body_matches_jax(body, loop, yb, interpret):
    jm = interpret("loop_cost")
    stacked, warp = _stack_inputs(X, Y, 1)
    want = jm.run(stacked, warp, body, loop, yb)
    got = lc.run(t(stacked), t(warp), body, loop, yb)
    assert_close(got, want, rtol=0, atol=1e-6)


def test_bodies_by_formula():
    """nothing is 36; slice the sum of the 36 shifted rows of independent
    planes; slice0 and gather 36 times one value of plane 0 (36 float32
    additions: within 36 · 2⁻²⁴ ≈ 2.1e-6 of the exact sum, relative)."""
    stacked, warp = (t(a) for a in _stack_inputs(4, 8, 2))
    np.testing.assert_array_equal(n(lc.run(stacked, warp, "nothing", "fori", 8)), 36.0)
    want = sum(stacked[cy, cx:cx + 4].double() for cy in range(6) for cx in range(6))
    assert_close(lc.run(stacked, warp, "slice", "static", 8), want, rtol=0, atol=1e-4)
    assert_close(lc.run(stacked, warp, "slice0", "fori", 8), 36.0 * stacked[0, :4].double(),
                 rtol=4e-6)
    z0c = (torch.arange(128) + torch.floor(warp[..., 2]).long()).clamp(0, 127)
    gathered = torch.gather(stacked[0, :4], 2, z0c)
    assert_close(lc.run(stacked, warp, "gather", "fori", 8), 36.0 * gathered.double(),
                 rtol=4e-6)


def test_planes_are_read_independently():
    """Plane cy at row y, not plane 0 at row y + cy: changing plane 3 alone
    changes the slice body by the change of its six x shifts."""
    stacked, warp = (t(a) for a in _stack_inputs(4, 8, 3))
    before = lc.run(stacked, warp, "slice", "fori", 8)
    bumped = stacked.clone()
    bumped[3] += 1.0
    after = lc.run(bumped, warp, "slice", "fori", 8)
    assert_close(after - before, torch.full_like(before, 6.0), rtol=0, atol=1e-4)


@pytest.mark.parametrize("body", lc.BODY_KINDS)
def test_loop_does_not_change_value(body):
    stacked, warp = (t(a) for a in _stack_inputs(5, 8, 4))
    a = lc.run(stacked, warp, body, "fori", 8)
    b = lc.run(stacked, warp, body, "static", 8)
    np.testing.assert_array_equal(n(a), n(b))


def test_ragged_x_and_wider_stack():
    """X comes from the warp, and the stack may have more x rows than
    X + 5 (the script's has X + 6)."""
    stacked, warp = (t(a) for a in _stack_inputs(20, 8, 5, xpad=30))
    got = lc.run(stacked, warp, "full", "fori", 8)
    assert got.shape == (20, 8, 128)
    assert_close(got, lc.run(stacked[:, :25].contiguous(), warp, "full", "fori", 8),
                 rtol=0, atol=0)


def test_wrapper_cpu_takes_plain_path():
    stacked, warp = (t(a) for a in _stack_inputs(4, 8, 6))
    out = lc.run(stacked, warp, "full", "static", 8)
    assert out.shape == (4, 8, 128) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert lc.launch_count == 0


def _bad_inputs():
    stacked, warp = (t(a) for a in _stack_inputs(4, 16, 7))
    return {
        "stack too short in x": (ValueError, stacked[:, :8].contiguous(), warp, 8),
        "stack planes": (ValueError, stacked[:5].contiguous(), warp, 8),
        "stack y": (ValueError, stacked[:, :, :8].contiguous(), warp, 8),
        "z not 128": (ValueError, stacked[..., :64].contiguous(),
                      warp[:, :, :64].contiguous(), 8),
        "yb does not divide Y": (ValueError, stacked, warp, 12),
        "Y not a multiple of 4": (ValueError, stacked[:, :, :6].contiguous(),
                                  warp[:, :6].contiguous(), 6),
        "yb not an int": (ValueError, stacked, warp, 8.0),
        "dtype": (TypeError, stacked.double(), warp.double(), 8),
        "strided": (ValueError, stacked, warp.transpose(0, 1).contiguous().transpose(0, 1), 8),
        "warp channels": (ValueError, stacked, warp[..., :2].contiguous(), 8),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_rejects_bad_input(case):
    error, stacked, warp, yb = _bad_inputs()[case]
    with pytest.raises(error):
        lc.run(stacked, warp, "full", "fori", yb)


@pytest.mark.parametrize("body, loop", [("fuller", "fori"), ("full", "unroll")])
def test_wrapper_rejects_unknown_body_or_loop(body, loop):
    stacked, warp = (t(a) for a in _stack_inputs(4, 8, 8))
    with pytest.raises(ValueError):
        lc.run(stacked, warp, body, loop, 8)


def test_inputs_are_the_scripts():
    stacked, warp = lc.inputs("cpu", (128, 2))
    rng = np.random.default_rng(0)
    want_stack = rng.standard_normal((6, 134, 2, 128)).astype(np.float32)
    want_warp = (rng.standard_normal((128, 2, 128, 3)) * 1.5).astype(np.float32)
    np.testing.assert_array_equal(n(stacked), want_stack)
    np.testing.assert_array_equal(n(warp), want_warp)


def test_main_cpu(capsys):
    rows = lc.main(device="cpu", shape=(4, 64))
    assert [r["case"] for r in rows] == list(lc.DEFAULT_CASES)
    assert capsys.readouterr().out.count('"device": "cpu"') == len(rows)
    for r in rows:
        assert r["us_per_call"] > 0 and r["yb"] == 64
        assert r["us_per_body"] == pytest.approx(r["us_per_call"] / (4 * 36))
    assert lc.launch_count == 0


def test_main_cpu_case_strings():
    rows = lc.main(device="cpu", cases=["gather/static/8", "slice/fori/16"], shape=(2, 16))
    assert [(r["body"], r["loop"], r["yb"]) for r in rows] == [
        ("gather", "static", 8), ("slice", "fori", 16)]
    assert rows[0]["us_per_body"] == pytest.approx(rows[0]["us_per_call"] / (2 * 2 * 36))
    with pytest.raises(ValueError):
        lc.parse_case("full")


def test_entry_point_requires_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the refusal applies only without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lc.main(shape=(2, 64))


@pytest.mark.parametrize("name,argtypes", [("lsf_stack_body", lc.STACK_BODY_ARGTYPES)])
def test_stack_body_argtypes_match_c_prototype(name, argtypes):
    """A mismatch would pass arguments in the wrong registers at launch,
    which nothing on the CPU can see."""
    assert [ctypes_kind(a) for a in argtypes] == c_prototype("stack_bodies.cu", name)


@pytest.mark.parametrize("enum,codes", [("Loop", lc.LOOPS), ("Body", lc.BODIES)])
def test_codes_match_the_c_enums(enum, codes):
    """The wrapper passes each loop and body as its index in these tuples,
    which must be the kernel's enum values."""
    assert [e.lower() for e in c_enum("stack_bodies.cu", enum)] == list(codes)


def test_loop_kinds_are_the_scripts():
    """B9 keeps the script's two loops; the frame loop code is
    bisect_kernel's."""
    assert lc.LOOP_KINDS == ("fori", "static") and lc.LOOPS == (*lc.LOOP_KINDS, "frame")
    with pytest.raises(ValueError):
        lc.run(*(t(a) for a in _stack_inputs(4, 8, 12)), "full", "frame", 8)


def test_frame_tiles_divide_the_wrappers_y_rule():
    """Every tile of table_kernel (the levels', v8's, v8c's) divides the Y
    rule the wrappers check (a multiple of TILE_Y), so that no shape they
    accept is refused at launch."""
    src = (REPO / "levelsetfusion_tpu_torch" / "csrc" / "stack_bodies.cu").read_text()
    for name in ("kLevelTY", "kV8TY", "kV8cTY"):
        ty = int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
        assert lc.TILE_Y % ty == 0, name
    assert f"constexpr int kTY = {lc.TILE_Y};" in src


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_112stack_kernelILi4ELi0EEEvNS_6ParamsE", "stack_kernel<4,0>"),
    ("_ZN12_GLOBAL__N_112table_kernelILi10ELi1EEEvNS_6ParamsE", "table_kernel<10,1>"),
    ("_ZN12_GLOBAL__N_111tile_kernelILi0ELi0EEEvNS_6ParamsE", "tile_kernel<0,0>"),
    ("_ZN12_GLOBAL__N_111ring_kernelILi2ELb1EEEvNS_6ParamsE", "ring_kernel<2,1>"),
    ("_ZN12_GLOBAL__N_120warp_field_cm_kernelIjEEvPKfS2_Pfiiiii", "warp_field_cm_kernel<uint32_t>"),
    ("_Z6kernelPf", "_Z6kernelPf"),
])
def test_kernel_name_demangles_the_instantiation(mangled, name):
    assert _sweep.kernel_name(mangled) == name


def test_ptxas_report_gives_registers_spills_and_stack_frame():
    """chip_smoke phase 7 and the sweeps read each kernel's stack frame,
    where a table indexed by the runtime pair shows as local memory."""
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112table_kernelILi10ELi1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112table_kernelILi10ELi1EEEvNS_6ParamsE
    144 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'
ptxas info    : Function properties for _Z1kv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers, 1024 bytes smem, 352 bytes cmem[0]
"""
    assert _sweep.ptxas(log) == {
        "_ZN12_GLOBAL__N_112table_kernelILi10ELi1EEEvNS_6ParamsE": (40, 12, 144, 0),
        "_Z1kv": (8, 0, 0, 1024),
    }
    assert _sweep.registers(log, _sweep.kernel_name) == {
        "table_kernel<10,1>": "40r/12B/144B", "_Z1kv": "8r/0B/0B"}


_SASS = """\t\tFunction : _ZN12_GLOBAL__N_111ring_kernelILi2ELb1EEEvNS_6ParamsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0030*/                   LDS R6, [R2] ;
        /*0040*/                   LDS R7, [R2+0x800] ;
        /*0050*/                   FADD R8, R6, R7 ;
        /*0060*/                   STL [R1], R8 ;
        /*0070*/               @P0 BRA 0x30 ;
        /*0080*/                   STG.E desc[UR4][R10.64], R8 ;
        /*0090*/                  @!PT LDS RZ, [RZ] ;
        /*00a0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00b0*/                   EXIT ;
"""


@pytest.mark.parametrize("loops,want", [
    (None, {"instructions": 7 + 5 * 35, "stl": 36}),  # a pair loop: 36 trips a voxel
    ({"ring_kernel<2,1>": (6, 2)}, {"instructions": (7 + 5 * 5) / 2, "stl": 3}),  # B5's chunk
], ids=["pairs", "cy loop, two voxels"])
def test_sass_per_voxel_counts_the_step_and_its_loop(monkeypatch, loops, want):
    """chip_smoke phase 7's SASS counts on a listing: the code between the
    step's barriers once, its innermost loop with shared loads as many
    times as it runs, over the voxels it sums at once; padding (@!PT) not
    counted."""
    monkeypatch.setattr(_sweep.shutil, "which", lambda _: sys.executable)
    monkeypatch.setattr(_sweep.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=_SASS))
    got = _sweep.sass_per_voxel(Path("lib.so"), {"ring_kernel<2,1>"}, loops)
    assert got == {"ring_kernel<2,1>": {**want, "pair_loop": 5, "pair_loop_lds": 2, "ldl": 0}}
