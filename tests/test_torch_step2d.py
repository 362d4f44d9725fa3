"""The 2D step (``ops/kernels/step2d.py``, ``csrc/step2d.cu``): one call for
the resample, the terms, the optional Sobolev filter, the update and the
stats of a 2D solver iteration.

On the CPU the wrapper is its plain version, which must give what the 2D
solve loop computed before the kernel existed (``warp_field_cm``, then
``energy_gradient``, u' = u − rate·g and the stats) exactly; the wrapper's
checks and the C prototypes are held here too. On the card (tests marked
``card``, skipped without one) the kernel is held to the plain version:

- the new warp and the per-voxel maxes within 4.768e-7, B2's standard: each
  voxel's float steps are the plain version's, in its order, but the level-
  set term's H·∇Φ, an einsum (a batched product) on the plain side;
- the energies and Σ‖δu‖ within rtol 1e-5: the kernel sums in double, the
  plain version in float32 in another order (~log2(V) roundings of 6e-8 on
  up to 2·10⁴ terms);
- a captured chunk replays exactly what the eager loop computes, and
  config1's 32 pool pairs take the plain loop's iterations with a warp
  within 1e-6 voxels.
"""

import ctypes

import numpy as np
import pytest
import torch

from levelsetfusion_tpu_torch.models import single_level
from levelsetfusion_tpu_torch.models.params import SmoothingMode, SolverParams
from levelsetfusion_tpu_torch.models.single_level import SolveLoop, fused_step_kwargs
from levelsetfusion_tpu_torch.ops.gradient import energy_gradient
from levelsetfusion_tpu_torch.ops.kernels import fused_gradient, loop_tail, resample, step2d
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import sobolev_taps
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from torch_parity import c_prototype, ctypes_kind, n  # tests/ is on sys.path under pytest

TERMS = {
    "data": dict(smoothing_term_weight=0.0),
    "tikhonov": dict(),
    "killing": dict(smoothing_mode=SmoothingMode.KILLING),
    "tikhonov_ls": dict(level_set_term_weight=0.1),
    "killing_ls": dict(smoothing_mode=SmoothingMode.KILLING, level_set_term_weight=0.1),
}
CASES = [(terms, sobolev, band) for terms in TERMS for sobolev in (False, True)
         for band in (True, False)]
WARP_TOL = 4.768e-7  # B2's standard
SUM_RTOL = 1e-5


def _case_id(case):
    terms, sobolev, band = case
    return f"{terms}-{'sobolev' if sobolev else 'nofilter'}-{'band' if band else 'all'}"


def _params(terms, sobolev, band, **kw):
    return SolverParams(learning_rate=0.5, sobolev_smoothing=sobolev, band_union_only=band,
                        **TERMS[terms], **kw)


def _inputs(shape, seed=0, device="cpu"):
    """(live, canonical, warp_cm, rate): TSDF-like fields, truncated to
    exactly ±1 on a share of voxels (so that the band-union mask bites),
    and a warp that reaches a few voxels out of the volume at its faces."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = np.clip(base * 0.8, -1.0, 1.0)
    live = np.clip(np.roll(base, 2, axis=0) * 0.8, -1.0, 1.0)
    warp = (rng.standard_normal((2, *shape)) * 1.0).astype(np.float32)
    t = [torch.from_numpy(a).to(device) for a in (live, canonical, warp)]
    return (*t, torch.tensor(0.5, device=device))


def _former_step(live, canonical, src, dst, rate, flag, p: SolverParams):
    """The 2D iteration as the solve loop ran it before the kernel: B1 (its
    plain version on the CPU), ``energy_gradient``, the gated update into
    ``dst`` and the stats in B2's layout."""
    kernel = (torch.tensor(sobolev_taps(p.sobolev_kernel_size, p.sobolev_strength))
              if p.sobolev_smoothing else None)
    warped = warp_field_cm(live, src, active=flag)
    res = energy_gradient(
        canonical, warped, src.movedim(0, -1), p.data_term_weight, p.smoothing_term_weight,
        p.level_set_term_weight, p.smoothing_mode, p.rigidity_enforcement_factor,
        p.band_union_only, kernel)
    update = -rate * res.gradient
    torch.where(flag, src + update.movedim(-1, 0), dst, out=dst)
    length = torch.sqrt(torch.sum(update * update, dim=-1))
    e = res.energies
    return torch.cat([
        torch.stack([e.data, e.smoothing, e.level_set, torch.sum(length), torch.amax(length)]),
        torch.amax(torch.abs(dst), dim=(1, 2)),
    ])


# --- the plain version and the wrapper, on the CPU -------------------------


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_version_is_the_former_loop_step(case):
    live, canonical, warp, rate = _inputs((13, 9), seed=len(_case_id(case)))
    p = _params(*case)
    flag = torch.tensor(True)
    want_warp = torch.full_like(warp, 7.0)
    want_stats = _former_step(live, canonical, warp, want_warp, rate, flag, p)
    out, stats = torch.full_like(warp, 3.0), torch.zeros(7)
    before = (step2d.launch_count, step2d.captured_count)
    new, got = step2d.step2d(live, canonical, warp, rate, out=out, stats=stats, active=flag,
                             **fused_step_kwargs(p))
    assert new is out and got is stats
    assert (step2d.launch_count, step2d.captured_count) == before  # CPU: the plain version
    np.testing.assert_array_equal(n(out), n(want_warp))
    np.testing.assert_array_equal(n(stats), n(want_stats))
    new, got = step2d.step2d(live, canonical, warp, rate, **fused_step_kwargs(p))
    np.testing.assert_array_equal(n(new), n(want_warp))
    np.testing.assert_array_equal(n(got), n(want_stats))


def test_flag_off_computes_nothing():
    live, canonical, warp, rate = _inputs((8, 6))
    off = torch.tensor(False)
    out, stats = torch.full_like(warp, 7.0), torch.full((7,), 3.0)
    new, got = step2d.step2d(live, canonical, warp, rate, out=out, stats=stats, active=off)
    assert new is out and got is stats
    assert bool((out == 7.0).all()) and bool((stats == 3.0).all())
    new, got = step2d.step2d(live, canonical, warp, rate, active=off)
    assert torch.isnan(new).all() and torch.isnan(got).all() and got.shape == (7,)


def _bad(kind):
    live, canonical, warp, rate = _inputs((8, 6))
    args, kw = [live, canonical, warp, rate], {}
    if kind == "dtype":
        args[1] = canonical.double()
    elif kind == "device":
        args[1] = torch.empty(canonical.shape, device="meta")
    elif kind == "layout":
        args[2] = warp.transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "shape":
        args[2] = warp[:, :, :5].contiguous()
    elif kind == "field_3d":
        args[0], args[1] = live[:, None], canonical[:, None]
    elif kind == "rate":
        args[3] = torch.tensor([0.5])
    elif kind == "out_is_warp":
        kw["out"] = warp
    elif kind == "out_shape":
        kw["out"] = torch.zeros(2, 8, 5)
    elif kind == "stats":
        kw["stats"] = torch.zeros(8)
    elif kind == "taps":
        kw["taps"] = (0.25, 0.5, 0.25, 0.0)
    elif kind == "flag":
        kw["active"] = torch.tensor(1.0)
    elif kind == "ticket":
        kw["ticket"] = torch.zeros(1)
    elif kind == "partial":
        kw["partial"] = torch.zeros(64)
    return args, kw


@pytest.mark.parametrize("kind,error", [
    ("dtype", TypeError), ("device", ValueError), ("layout", ValueError),
    ("shape", ValueError), ("field_3d", ValueError), ("rate", TypeError),
    ("out_is_warp", ValueError), ("out_shape", ValueError), ("stats", ValueError),
    ("taps", ValueError), ("flag", TypeError), ("ticket", ValueError),
    ("partial", ValueError),
])
def test_wrapper_refuses(kind, error):
    args, kw = _bad(kind)
    with pytest.raises(error):
        step2d.step2d(*args, **kw)


def test_argtypes_match_the_c_prototypes():
    assert [ctypes_kind(a) for a in step2d.TILES_ARGTYPES] == c_prototype(
        "step2d.cu", "lsf_step2d_tiles")
    assert [ctypes_kind(a) for a in step2d.ARGTYPES] == c_prototype("step2d.cu", "lsf_step2d")
    assert step2d.ARGTYPES[18] == ctypes.POINTER(ctypes.c_float)


def test_2d_loop_calls_the_step_and_nothing_else(monkeypatch):
    """Every 2D iteration, frozen ones included, is one ``step2d`` call with
    the loop's flag, ticket and stats buffer, then one ``loop_tail`` call on
    the step's stats with the loop's flag and state buffers; B1 and B2 are
    not called."""
    calls, tails = [], []
    real, real_tail = step2d.step2d, loop_tail.loop_tail

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    def spy_tail(*args, **kw):
        tails.append((len(calls), args))
        return real_tail(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("a 2D iteration called B1 or B2")

    monkeypatch.setattr(step2d, "step2d", spy)
    monkeypatch.setattr(loop_tail, "loop_tail", spy_tail)
    monkeypatch.setattr(single_level, "warp_field_cm", refuse)
    monkeypatch.setattr(single_level, "fused_gradient_update", refuse)
    live, canonical, warp, _ = _inputs((10, 8))
    loop = SolveLoop((10, 8), _params("tikhonov", True, True, max_iterations=5,
                                      convergence_threshold=0.0), "cpu", check_every=4)
    res = loop.solve(canonical, live, warp.movedim(0, -1))
    assert res.iterations == 5 and len(calls) == 8  # two chunks of 4
    assert all(kw["active"] is loop.active and kw["ticket"] is loop.ticket
               and kw["stats"] is loop._stats and kw["partial"] is loop._partial
               for kw in calls)
    state = (loop._stats, loop.active, loop.rate, loop.prev_energy, loop.telemetry,
             loop.max_disp, loop.max_update, loop.iteration, loop.active)
    assert [k for k, _ in tails] == list(range(1, 9))  # one tail after each step
    assert all(len(args) == len(state) and all(a is b for a, b in zip(args, state))
               for _, args in tails)


# --- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda", torch.cuda.current_device())


# The main path's grids (config1; config2's three levels), ragged ones (tiles
# of 8 x 16 with ragged last tiles), and one of a single tile (no fold).
CARD_SHAPES = [(96, 48), (96, 64), (48, 32), (24, 16), (37, 23), (150, 130), (7, 12)]


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_equals_plain_version_on_the_card(shape, case):
    dev = _card()
    p = _params(*case)
    live, canonical, warp, rate = _inputs(shape, seed=shape[0] + shape[1])
    want_warp, want_stats = step2d.step2d(live, canonical, warp, rate,
                                          **fused_step_kwargs(p))
    flag = torch.tensor(True, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.full(warp.shape, 7.0, device=dev)
    before = step2d.launch_count
    new, stats = step2d.step2d(*(a.to(dev) for a in (live, canonical, warp, rate)), out=out,
                               active=flag, ticket=ticket, **fused_step_kwargs(p))
    torch.cuda.synchronize()
    assert new is out and step2d.launch_count == before + 1 and int(ticket) == 0
    warp_err = float((new.cpu() - want_warp).abs().max())
    max_err = float((stats[4:].cpu() - want_stats[4:]).abs().max())
    print(shape, _case_id(case), "warp", warp_err, "maxes", max_err, "sums",
          n(stats[:4]), n(want_stats[:4]))
    assert warp_err <= WARP_TOL and max_err <= WARP_TOL
    np.testing.assert_allclose(n(stats[:4]), n(want_stats[:4]), rtol=SUM_RTOL, atol=1e-7)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(96, 48), (150, 130)])
def test_flag_off_leaves_the_buffers_on_the_card(shape):
    dev = _card()
    live, canonical, warp, rate = (a.to(dev) for a in _inputs(shape))
    out, stats = torch.full_like(warp, 7.0), torch.full((7,), 3.0, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    step2d.step2d(live, canonical, warp, rate, out=out, stats=stats, ticket=ticket,
                  active=torch.tensor(False, device=dev), taps=sobolev_taps(7, 0.1))
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and bool((stats == 3.0).all()) and int(ticket) == 0


@pytest.mark.card
@pytest.mark.parametrize("shape,terms,sobolev", [
    ((96, 48), "tikhonov", False), ((96, 64), "killing_ls", True),
    ((150, 130), "killing_ls", True)])
def test_captured_chunk_replays_the_eager_loop(shape, terms, sobolev):
    """A captured chunk's replays give the eager loop's results exactly; the
    capture records 16 launches of the step and of the loop tail and none of
    B1 or B2, and each replay adds them to ``launch_count``."""
    dev = _card()
    p = _params(terms, sobolev, True, max_iterations=40, convergence_threshold=0.0)
    live, canonical, warp, _ = (a.to(dev) for a in _inputs(shape, seed=5))
    counts = lambda: [(m.launch_count, m.captured_count)  # noqa: E731
                      for m in (step2d, loop_tail, resample, fused_gradient)]
    eager = SolveLoop(shape, p, dev, graph=False).solve(canonical, live, warp.movedim(0, -1))
    before = counts()
    loop = SolveLoop(shape, p, dev)
    got = loop.solve(canonical, live, warp.movedim(0, -1))
    torch.cuda.synchronize()
    after = counts()
    assert loop.graph_launches == {step2d: 16, resample: 0, fused_gradient: 0, loop_tail: 16}
    for kernel in (0, 1):  # the step's and the tail's: + the warm-up
        assert after[kernel] == (before[kernel][0] + 1 + 16 * loop.replays,
                                 before[kernel][1] + 16)
    assert after[2:] == before[2:] and loop.replays == 3
    assert got.iterations == eager.iterations == 40
    assert torch.equal(got.warp, eager.warp)
    for a, b in zip(got.telemetry, eager.telemetry):
        assert torch.equal(a, b)
    assert torch.equal(got.max_abs_displacement, eager.max_abs_displacement)
    assert int(loop.ticket) == 0


@pytest.mark.card
def test_config1_pool_takes_the_plain_loops_iterations():
    """config1 at its preset over all 32 pairs of the benchmark's scanline
    pool: the card's solve (the kept loop, captured) takes the plain loop's
    iterations on every pair, with a warp within 1e-6 voxels."""
    from portbench.drivers import common
    from portbench.drivers.pair_solve_2d import scan_camera
    from portbench.lib import cells
    from portbench.lib import traffic as gen

    from levelsetfusion_tpu_torch.core.camera import Camera2d
    from levelsetfusion_tpu_torch.ops.tsdf import generate_tsdf_2d

    dev = _card()
    cell = cells.cell("config1-pairs")
    cfg = common.program_config(cell.config)
    grid = common.grid(cfg)
    cam = scan_camera(cell.traffic["camera"])
    camera = Camera2d(fx=cam.fx, cx=cam.cx, image_width=cam.width)
    pool = gen.generate(cell.traffic, 4294967311)
    plain = SolveLoop(tuple(grid.shape), cfg.solver, "cpu")
    worst = 0.0
    for k, pair in enumerate(pool):
        canonical, live = (generate_tsdf_2d(torch.from_numpy(row), camera, grid,
                                            narrow_band_width_voxels=cfg.narrow_band_width_voxels,
                                            method=cfg.generation_method)
                           for row in (pair.canonical, pair.live))
        want = plain.solve(canonical, live)
        got = single_level.solve_single_level(canonical.to(dev), live.to(dev), cfg.solver)
        err = float((got.warp.cpu() - want.warp).abs().max())
        worst = max(worst, err)
        assert got.iterations == want.iterations, (k, got.iterations, want.iterations)
        assert err <= 1e-6, (k, err)
    print("config1 pool: worst warp gap", worst)
    single_level.release_kept_loops()
