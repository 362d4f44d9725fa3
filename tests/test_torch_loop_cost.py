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
16 at yb 8 and 16, and 12 (a multiple of 4, not of 8) at yb 12 and 4.

Also: the wrapper's input checks and launch counter, the entry point on the
CPU, the script's inputs drawn number for number, and the kernel's launch
(``b9_geometry``, ``b9_ranges``): its constants against the source, its
ranges covering every (tile, x row) step once, and an emulation of its ring
and shared addresses that must give each body's plain value exactly."""

import functools
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from levelsetfusion_tpu_torch.experiments import _sweep, loop_cost_sweep
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


def _source():
    return (REPO / "levelsetfusion_tpu_torch" / "csrc" / "stack_bodies.cu").read_text()


def _c_int(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_frame_tiles_divide_the_wrappers_y_rule():
    """Every tile of table_kernel (the levels', v8's, v8c's) and of
    loop_kernel (B9's) divides the Y rule the wrappers check (a multiple of
    TILE_Y), so that no shape they accept is refused at launch; B9's
    voxels a thread divide its tile."""
    src = _source()
    for name in ("kLevelTY", "kV8TY", "kV8cTY", "kLoopTY"):
        assert lc.TILE_Y % _c_int(src, name) == 0, name
    assert _c_int(src, "kLoopTY") % _c_int(src, "kLoopV") == 0
    assert f"constexpr int kYRule = {lc.TILE_Y};" in src


def test_b9_geometry_matches_the_kernel_source():
    """The wrapper's twin of B9's launch takes the kernel's constants."""
    src = _source()
    assert _c_int(src, "kLoopTY") == lc.B9_TILE_ROWS
    assert _c_int(src, "kLoopV") == lc.B9_VOXELS
    assert _c_int(src, "kLoopAhead") == lc.B9_AHEAD
    assert "std::min(233472 / (kSmemB + 1024), 2048 / kThreadsL)" in src
    assert "static constexpr int kThreadsL = TY * kLane / V;" in src
    assert "constexpr int kLoopSlots = kN + kLoopAhead;" in src
    assert "kSmemB = kLoopSlots * kSlotF * (int)sizeof(float);" in src
    g = lc.b9_geometry(lc.SHAPE)
    assert f"kLoopTY = {g['tile_rows']} y rows, V = {g['voxels']} voxels a thread" in src
    assert f"{g['threads']} threads), the {round(g['smem_bytes'] / 1000)} KB ring" in src


B9_SHAPES = [(1, 4), (2, 8), (3, 12), (5, 8), (7, 12), (20, 64), (128, 128), (4, 200),
             (128, 4), (33, 20)]


@pytest.mark.parametrize("shape", B9_SHAPES, ids=str)
def test_b9_geometry_fits_shared_memory(shape):
    """Every accepted Y (a multiple of 4, of 8 or not) gets a tile that
    divides it, a ring that fits a CTA's shared memory (227 KB) with at
    least one CTA an SM, and at most one CTA a (tile, x row) step."""
    g = lc.b9_geometry(shape)
    nx, ny = shape
    assert ny % g["tile_rows"] == 0 and g["tile_rows"] % g["voxels"] == 0
    assert 0 < g["smem_bytes"] <= lc.MAX_DYNAMIC_SMEM
    assert g["smem_bytes"] == (6 + lc.B9_AHEAD) * 6 * g["tile_rows"] * lc.LANE * 4
    assert g["threads"] * g["voxels"] == g["tile_rows"] * lc.LANE
    assert g["ctas_per_sm"] * (g["smem_bytes"] + 1024) <= lc.SM_SHARED_BYTES
    assert g["ctas_per_sm"] >= 1 and 1 <= g["ctas"] <= nx * (ny // g["tile_rows"])
    assert g["kernel"] == f"loop_kernel<*,*,{lc.B9_TILE_ROWS},{lc.B9_VOXELS}>"


def test_b9_geometry_at_the_scripts_shape():
    """128^3: one wave of two 256-thread CTAs an SM on 132 SMs, staging
    68.0 MB of stack rows (the function uses 52.3 MB); the first frame's
    8-x-row CTAs staged 13 rows for 8 outputs, 81.8 MB."""
    assert lc.b9_geometry(lc.SHAPE) == {
        "kernel": "loop_kernel<*,*,4,2>", "tile_rows": 4, "voxels": 2, "threads": 256,
        "smem_bytes": 86016, "ctas_per_sm": 2, "ctas": 264}
    assert lc.b9_staged_bytes(lc.SHAPE) == 68026368
    assert 6 * 133 * 128 * 128 * 4 == 52297728
    assert 6 * 13 * 16 * 128 * 128 * 4 == 81788928
    assert lc.b9_geometry((3, 12), 132)["ctas"] == 9


def _ring_schedule(xn, ahead):
    """``loop_kernel``'s staging of a run of xn steps on a ring of kN +
    ``ahead`` slots: [(slot, row)] before the first step, then each step's
    [(slot, row)] (rows relative to x0): the first kN rows, ahead - 1 more,
    then at step xi row xi + slots - 1 into the slot row xi - 1 used, while
    xi + ahead < xn."""
    slots = lc.N + ahead
    first = [(c, c) for c in range(lc.N)]
    first += [(lc.N - 1 + d, lc.N - 1 + d) for d in range(1, ahead) if d < xn]
    steps = []
    for xi in range(xn):
        slot0 = xi % slots
        steps.append([((slot0 - 1) % slots, xi + slots - 1)] if xi + ahead < xn else [])
    return first, steps


def _ring_holds(runs, nx, ahead):
    """Replays a CTA's ring: at step xi slot (xi + cx) mod slots must hold
    row xi + cx, staged no later than ahead steps before; the slot a step
    refills must not be one it reads; a run stages rows x0 .. x0 + xn + 4,
    each once, inside the stack (XP >= X + 5)."""
    slots = lc.N + ahead
    for y0, x0, xn in runs:
        first, steps = _ring_schedule(xn, ahead)
        ring = dict(first)  # a fresh ring: nothing kept from the last run
        staged = [row for _, row in first]
        for xi, fills in enumerate(steps):
            reads = {(xi + cx) % slots for cx in range(lc.N)}
            for slot, row in fills:
                assert slot not in reads
                ring[slot] = row
                staged.append(row)
            for cx in range(lc.N):
                assert ring[(xi + cx) % slots] == xi + cx
        assert sorted(staged) == list(range(xn + lc.N - 1))
        assert x0 + xn + lc.N - 1 <= nx + lc.N - 1


@pytest.mark.parametrize("shape,sms", [
    ((128, 128), 132), ((3, 12), 132), ((5, 8), 1), ((2, 4), 3), ((20, 64), 132),
    ((7, 12), 1), ((1, 4), 1), ((128, 128), 1), ((9, 16), 5), ((4, 200), 7)], ids=str)
def test_b9_ranges_cover_every_step_once(shape, sms):
    """The one-wave split: ``ctas`` ranges of equal steps (±1), x fastest,
    covering every (tile, x row) step exactly once; a range's runs each lie
    in one tile, and a run after a range's first starts a new tile at x 0,
    with a fresh ring."""
    nx, ny = shape
    g = lc.b9_geometry(shape, sms)
    tile = g["tile_rows"]
    ranges = lc.b9_ranges(shape, g["ctas"], tile)
    assert len(ranges) == g["ctas"]
    sizes = [sum(xn for _, _, xn in runs) for runs in ranges]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    seen = {}
    for runs in ranges:
        for i, (y0, x0, xn) in enumerate(runs):
            assert y0 % tile == 0 and 0 <= x0 and xn >= 1 and x0 + xn <= nx
            assert i == 0 or x0 == 0
            for x in range(x0, x0 + xn):
                seen[(y0, x)] = seen.get((y0, x), 0) + 1
        for ahead in (lc.B9_AHEAD, 2, 3):
            _ring_holds(runs, nx, ahead)
    assert seen == {(y0, x): 1 for y0 in range(0, ny, tile) for x in range(nx)}
    if (shape, sms) in (((7, 12), 1), ((128, 128), 1), ((9, 16), 5)):
        assert any(len(runs) > 1 for runs in ranges)  # a range that crosses a tile


def _pair_row(s0, t, slots):
    """resample_z.cuh pair_table<slots>(slots, kN): pair t's row from start
    slot s0, in units of a plane's tile rows."""
    cy, cx = divmod(t, lc.N)
    return (s0 + cx) % slots * lc.N + cy


def _emulate_loop_kernel(stacked, warp, body, loop, sms):
    """``loop_kernel`` in numpy: its ranges and ring (shared memory as one
    float32 array, unstaged words NaN), each thread's V voxels at their
    slot-0 addresses, pair t's offset from the pair table (fori) or the
    step's slot offsets plus cy tile rows (static), each voxel's float32
    sum in t order."""
    nx, ny = warp.shape[:2]
    g = lc.b9_geometry((nx, ny), sms)
    ty = g["tile_rows"]
    unit, slots = ty * lc.LANE, lc.N + lc.B9_AHEAD
    slot_f = lc.N * unit
    smem = np.full(slots * slot_f, np.nan, np.float32)
    out = np.full((nx, ny, lc.LANE), np.nan, np.float32)
    z = np.arange(lc.LANE)

    def stage(slot, px, y0):
        smem[slot * slot_f:(slot + 1) * slot_f] = stacked[:, px, y0:y0 + ty].reshape(-1)

    for runs in lc.b9_ranges((nx, ny), g["ctas"], ty):
        for y0, x0, xn in runs:
            smem[:] = np.nan
            first, steps = _ring_schedule(xn, lc.B9_AHEAD)
            for slot, row in first:
                stage(slot, x0 + row, y0)
            for xi in range(xn):
                slot0 = xi % slots
                for slot, row in steps[xi]:
                    stage(slot, x0 + row, y0)
                for rr in range(ty):  # thread row rr % (ty / V), voxel rr // (ty / V)
                    x, y = x0 + xi, y0 + rr
                    z0 = z + np.floor(warp[x, y, :, 2]).astype(np.int64)
                    z0c, z1c = np.clip(z0, 0, 127), np.clip(z0 + 1, 0, 127)
                    row = rr * lc.LANE
                    if body in ("slice0", "gather"):
                        row += slot0 * slot_f
                    a0 = row + (z0c if body in ("gather", "full") else z)
                    a1 = row + z1c
                    acc = np.zeros(lc.LANE, np.float32)
                    for t in range(lc.NBODY):
                        cy, cx = divmod(t, lc.N)
                        if body in ("slice", "full"):
                            off = (_pair_row(slot0, t, slots) * unit if loop == "fori"
                                   else (slot0 + cx) % slots * slot_f + cy * unit)
                        else:
                            off = 0
                        if body == "nothing":
                            acc = acc + np.float32(1.0)
                        elif body == "full":
                            acc = acc + (np.float32(0.5) * smem[a0 + off]
                                         + np.float32(0.25) * smem[a1 + off])
                        else:
                            acc = acc + smem[a0 + off]
                    out[x, y] = acc
    return out


@pytest.mark.parametrize("shape,sms", [((3, 12), 132), ((7, 12), 1), ((9, 8), 4)], ids=str)
@pytest.mark.parametrize("loop", lc.LOOP_KINDS)
@pytest.mark.parametrize("body", lc.BODY_KINDS)
def test_loop_kernel_emulation_is_exact(body, loop, shape, sms):
    """The kernel's ring and addressing, replayed on the CPU, give the plain
    version bit for bit, including ranges that cross a tile and X < 6."""
    stacked, warp = _stack_inputs(*shape, 14)
    got = _emulate_loop_kernel(stacked, warp, body, loop, sms)
    want = lc.loop_cost_reference(t(stacked), t(warp), body)
    np.testing.assert_array_equal(got, n(want))


@pytest.mark.parametrize("body,loop,yb", [
    *((b, lp, 12) for lp in lc.LOOP_KINDS for b in lc.BODY_KINDS),
    *(("full", lp, 4) for lp in lc.LOOP_KINDS)])
def test_body_matches_jax_off_the_8_row_tiles(body, loop, yb, interpret):
    """Y = 12, a multiple of 4 but not of 8, through the JAX script (X =
    128, as it fixes) and the port: the ten cases at yb 12, full at yb 4."""
    jm = interpret("loop_cost")
    stacked, warp = _stack_inputs(X, 12, 15)
    want = jm.run(stacked, warp, body, loop, yb)
    got = lc.run(t(stacked), t(warp), body, loop, yb)
    assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("body", lc.BODY_KINDS)
def test_small_x_off_the_8_row_tiles(body):
    """(X, Y) = (3, 12): fewer x rows than a ring holds; the wrapper takes
    it (yb 12, 4) and both loops give the plain version."""
    stacked, warp = (t(a) for a in _stack_inputs(3, 12, 16))
    want = lc.loop_cost_reference(stacked, warp, body)
    for loop in lc.LOOP_KINDS:
        for yb in (12, 4):
            np.testing.assert_array_equal(n(lc.run(stacked, warp, body, loop, yb)), n(want))
    assert lc.launch_count == 0


def test_shared_wavefronts_count_each_banks_distinct_words():
    """One warp load's wavefronts: the most distinct words any of the 32
    banks holds; repeated words are broadcast."""
    uz = np.zeros((1, 1, lc.LANE), np.float32)
    uz[0, 0, :32] = np.where(np.arange(32) % 2, 31.0, 0.0)  # lanes 1, 3, ..: z + 31
    uz[0, 0, 32:64] = -np.arange(32)  # every lane reads z0c 32 (z1c 33)
    uz[0, 0, 64:96] = 96 - np.arange(64, 96)  # z0c 96 on every lane
    warp = np.stack([uz, uz, uz], -1)
    got = lc.shared_wavefronts(warp)
    # z0c loads, then z1c loads, of the 4 warps
    lane = np.arange(32)
    z0 = np.where(lane % 2, lane + 31, lane)
    want0 = max(len({w for w in z0 if w % 32 == b}) for b in range(32))
    assert want0 == 2
    assert list(got) == [want0, 1, 1, 1, 2, 1, 1, 1]


def test_shared_floor_in_the_kernel_header():
    """The header's shared-memory floor comes from the script's warp:
    1.444 wavefronts a warp load, 26.1 us at 1.98 GHz, 29.4 at 1.755."""
    _, warp = lc.inputs("cpu")
    wf = lc.shared_wavefronts(warp)
    assert round(float(wf.mean()), 3) == 1.444
    assert round(float((wf == 1).mean()) * 100, 1) == 55.6
    src = _source()
    assert "a warp's load takes 1.444 wavefronts on average" in src
    assert f"{lc.shared_floor_us(warp, 1.98e9):.1f} us at 1.98 GHz" in src
    assert f"({lc.shared_floor_us(warp, 1.755e9):.1f} at 1.755)" in src
    assert f"the staged stack is {lc.b9_staged_bytes(lc.SHAPE) / 1e6:.1f} MB" in src


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_111loop_kernelILi4ELi0ELi4ELi2EEEvNS_6ParamsE", "loop_kernel<4,0,4,2>"),
    ("_ZN12_GLOBAL__N_111loop_kernelILi0ELi1ELi8ELi1EEEvNS_6ParamsE", "loop_kernel<0,1,8,1>"),
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


_SASS = """\t\tFunction : {mangled}
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
_MANGLED = {"ring_kernel<2,1>": "_ZN12_GLOBAL__N_111ring_kernelILi2ELb1EEEvNS_6ParamsE",
            "loop_kernel<4,0,4,2>": "_ZN12_GLOBAL__N_111loop_kernelILi4ELi0ELi4ELi2EEEvNS_6ParamsE"}


@pytest.mark.parametrize("name,loops,want", [
    ("ring_kernel<2,1>", None, {"instructions": 7 + 5 * 35, "stl": 36}),  # a pair loop: 36 trips
    ("ring_kernel<2,1>", {"ring_kernel<2,1>": (6, 2)},
     {"instructions": (7 + 5 * 5) / 2, "stl": 3}),  # B5's chunk
    ("loop_kernel<4,0,4,2>", {"loop_kernel<4,0,4,2>": (36, 2)},
     {"instructions": (7 + 5 * 35) / 2, "stl": 18}),  # B9's fori, two voxels a trip
], ids=["pairs", "cy loop, two voxels", "pair loop, two voxels"])
def test_sass_per_voxel_counts_the_step_and_its_loop(monkeypatch, name, loops, want):
    """chip_smoke phase 7's SASS counts on a listing: the code between the
    step's barriers once, its innermost loop with shared loads as many
    times as it runs, over the voxels it sums at once; padding (@!PT) not
    counted."""
    monkeypatch.setattr(_sweep.shutil, "which", lambda _: sys.executable)
    monkeypatch.setattr(_sweep.subprocess, "run", lambda *a, **k: types.SimpleNamespace(
        stdout=_SASS.format(mangled=_MANGLED[name])))
    got = _sweep.sass_per_voxel(Path("lib.so"), {name}, loops)
    assert got == {name: {**want, "pair_loop": 5, "pair_loop_lds": 2, "ldl": 0}}


@pytest.mark.parametrize("name", list(loop_cost_sweep.VARIANTS))
def test_sweep_variant_applies_to_the_kernel_source(name):
    """Every substitution of the B9 sweep finds its anchor exactly once in
    csrc/stack_bodies.cu, and the variant's tile and voxels a thread are
    the ones its source sets, so each variant built on the card is the one
    the sweep names."""
    text = loop_cost_sweep.variant_source(name)
    _, tile, voxels = loop_cost_sweep.VARIANTS[name]
    assert (_c_int(text, "kLoopTY"), _c_int(text, "kLoopV")) == (tile, voxels)
    assert (text != loop_cost_sweep.SOURCE.read_text()) == (name != "base")


def test_sweep_base_is_the_shipped_launch():
    _, tile, voxels = loop_cost_sweep.VARIANTS["base"]
    assert (tile, voxels) == (lc.B9_TILE_ROWS, lc.B9_VOXELS)


def test_sweep_needs_the_gpu():
    with pytest.raises(RuntimeError):
        loop_cost_sweep.main(device="cpu")
