"""Parity of the port's single-level solve with the JAX package's, on the
golden path and on the fused Pallas path (interpret mode), and of its
device-side loop (a done flag read every ``check_every`` iterations) with
the serial loop that reads ``max_update`` every iteration, in 3D and in 2D
(JAX's unfused step; config1 at its full preset).

Tolerances are those of tests/test_fused_gradient.py's solver test: warp
rtol 3e-4 atol 3e-6, telemetry rtol 2e-4 atol 1e-8; iteration counts and
``converged`` exactly. The device loop equals the serial loop exactly: the
same plain versions run the same float operations in the same order."""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.models import params as jparams
from levelsetfusion_tpu.models.single_level import solve_single_level as jsolve
from levelsetfusion_tpu_torch.models import params as tparams
from levelsetfusion_tpu_torch.models import single_level
from levelsetfusion_tpu_torch.models.single_level import SolveLoop, release_kept_loops
from levelsetfusion_tpu_torch.models.single_level import solve_single_level as tsolve
from levelsetfusion_tpu_torch.ops import sobolev
from levelsetfusion_tpu_torch.ops.gradient import energy_gradient
from levelsetfusion_tpu_torch.ops.kernels import fused_gradient, resample
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import (
    fused_gradient_update,
    fused_gradient_update_reference,
    sobolev_taps,
    to_component_major,
)
from levelsetfusion_tpu_torch.ops.kernels.resample import (
    warp_field_cm,
    warp_field_cm_reference,
)
from torch_parity import assert_close, n, t, tsdf_like  # tests/ is on sys.path under pytest

CONFIG3 = dict(
    learning_rate=0.5, smoothing_term_weight=0.1,
    smoothing_mode="KILLING", rigidity_enforcement_factor=0.1,
    level_set_term_weight=0.1, sobolev_smoothing=True, adaptive_learning_rate=True,
)


def _params(**kw):
    kw = {**CONFIG3, **kw}
    mode = kw.pop("smoothing_mode")
    return (jparams.SolverParams(smoothing_mode=jparams.SmoothingMode[mode], **kw),
            tparams.SolverParams(smoothing_mode=tparams.SmoothingMode[mode], **kw))


def _compare(got, want, max_iterations):
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    assert got.warp.shape == want.warp.shape
    assert_close(got.warp, want.warp, rtol=3e-4, atol=3e-6)
    assert_close(got.max_abs_displacement, want.max_abs_displacement, rtol=3e-4, atol=3e-6)
    for name in want.telemetry._fields:
        a, b = getattr(got.telemetry, name), getattr(want.telemetry, name)
        assert a.shape == (max_iterations,)
        assert_close(a, b, rtol=2e-4, atol=1e-8)
        assert not np.any(n(a)[got.iterations:])


@pytest.mark.parametrize(
    "case",
    [
        dict(max_iterations=12, convergence_threshold=0.0),  # the config3 energy
        dict(max_iterations=10, convergence_threshold=0.0, smoothing_mode="TIKHONOV",
             smoothing_term_weight=0.2, level_set_term_weight=0.0,
             sobolev_smoothing=False, adaptive_learning_rate=False, learning_rate=0.3),
        dict(max_iterations=8, convergence_threshold=0.0, level_set_term_weight=0.0,
             sobolev_smoothing=False, adaptive_learning_rate=False),
    ],
)
def test_matches_jax_golden_solve(case):
    canonical, live, _ = tsdf_like((12, 10, 8), 30)
    jp, tp = _params(**case)
    want = jsolve(jnp.asarray(canonical), jnp.asarray(live), jp)
    got = tsolve(t(canonical), t(live), tp)
    _compare(got, want, case["max_iterations"])


def test_warm_start_and_early_stop_match_jax():
    """A warm start (which seeds max_abs_displacement) and a threshold that
    stops the loop before the iteration cap."""
    canonical, live, warp = tsdf_like((12, 10, 8), 31, warp_scale=0.3)
    jp, tp = _params(max_iterations=60, convergence_threshold=0.03)
    want = jsolve(jnp.asarray(canonical), jnp.asarray(live), jp, jnp.asarray(warp))
    got = tsolve(t(canonical), t(live), tp, t(warp))
    assert got.converged and 0 < got.iterations < 60
    _compare(got, want, 60)


def test_matches_jax_fused_pallas_solve():
    """Against the JAX solve that runs both Pallas kernels (interpret mode)
    at (16, 16, 128), the shape the TPU kernels take."""
    canonical, live, _ = tsdf_like((16, 16, 128), 32)
    jp, tp = _params(max_iterations=6, convergence_threshold=0.0, learning_rate=0.3)
    jp = jp.replace(use_pallas_resample=True, use_pallas_gradient=True,
                    pallas_interpret=True)
    want = jsolve(jnp.asarray(canonical), jnp.asarray(live), jp)
    got = tsolve(t(canonical), t(live), tp)
    _compare(got, want, 6)


def test_zero_iterations():
    """No iteration runs: not converged, zero telemetry, and the per-axis
    max |u| of the warm start."""
    _, _, warp = tsdf_like((5, 4, 3), 33)
    res = tsolve(torch.zeros(5, 4, 3), torch.zeros(5, 4, 3),
                 tparams.SolverParams(max_iterations=0), t(warp))
    assert res.iterations == 0 and res.converged is False
    assert all(b.shape == (0,) for b in res.telemetry)
    np.testing.assert_array_equal(n(res.max_abs_displacement),
                                  np.abs(warp).max(axis=(0, 1, 2)))
    np.testing.assert_array_equal(n(res.warp), warp)


def test_solve_takes_2d_or_3d():
    for shape in ((8,), (2, 3, 4, 5)):
        with pytest.raises(ValueError, match="2D or 3D"):
            SolveLoop(shape, tparams.SolverParams(), "cpu")


def _jax_presets():
    """The JAX package's presets, imported where a test uses them:
    ``levelsetfusion_tpu.utils`` imports matplotlib, which the machine that
    runs the card tests may lack, so the module keeps it out of collection."""
    from levelsetfusion_tpu.utils.config import PRESETS

    return PRESETS


def test_solver_params_from_jax_drops_tpu_fields():
    JPRESETS = _jax_presets()
    for name, cfg in JPRESETS.items():
        d = dataclasses.asdict(cfg.solver)
        got = tparams.solver_params_from_jax(d)
        for f in dataclasses.fields(got):
            want = d[f.name]
            have = getattr(got, f.name)
            assert getattr(have, "value", have) == getattr(want, "value", want), (name, f.name)
        for field in tparams.JAX_ONLY_FIELDS:
            assert not hasattr(got, field)
    # config.json form: the enum as its string value
    d = {**dataclasses.asdict(JPRESETS["config3_3d_full_energy"].solver),
         "smoothing_mode": "killing"}
    assert tparams.solver_params_from_jax(d).smoothing_mode is tparams.SmoothingMode.KILLING


def _serial(canonical, live, p, initial_warp):
    """The serial loop: the host reads ``max_update`` after every iteration
    (the port's loop before the device flag)."""
    warp_cm = to_component_major(initial_warp)
    kw = dict(w_data=p.data_term_weight, w_smooth=p.smoothing_term_weight,
              w_ls=p.level_set_term_weight,
              killing=p.smoothing_mode is tparams.SmoothingMode.KILLING,
              gamma=p.rigidity_enforcement_factor, band_union=p.band_union_only,
              taps=sobolev_taps(p.sobolev_kernel_size, p.sobolev_strength)
              if p.sobolev_smoothing else ())
    n = p.max_iterations
    threshold = float(np.float32(p.convergence_threshold))
    telemetry = torch.zeros((5, n))
    rate = torch.tensor(p.learning_rate)
    prev = torch.tensor(float("inf"))
    max_disp = torch.amax(torch.abs(warp_cm), dim=(1, 2, 3))
    max_update, it = float("inf"), 0
    while it < n and max_update >= threshold:
        warp_cm, stats = fused_gradient_update(warp_field_cm(live, warp_cm), canonical,
                                               warp_cm, rate, **kw)
        energy = stats[0] + stats[1] + stats[2]
        if p.adaptive_learning_rate:
            rate = torch.where(energy > prev, rate * 0.5, rate)
        prev = energy
        telemetry[:, it] = torch.stack([stats[0], stats[1], stats[2], stats[4],
                                        stats[3] / float(canonical.numel())])
        max_disp = torch.maximum(max_disp, stats[5:8])
        max_update = float(stats[4])
        it += 1
    max_disp = torch.maximum(max_disp, torch.amax(torch.abs(warp_cm), dim=(1, 2, 3)))
    return warp_cm.movedim(0, -1), it, max_update < threshold, telemetry, max_disp, rate


LOOP_CASES = {
    "cap5": dict(max_iterations=5, convergence_threshold=0.0),
    "cap37": dict(max_iterations=37, convergence_threshold=0.0, level_set_term_weight=0.0,
                  sobolev_smoothing=False),
    "converges": dict(max_iterations=60, convergence_threshold=0.03),
    "halving": dict(max_iterations=20, convergence_threshold=0.0, learning_rate=2.5,
                    sobolev_smoothing=False),
    "zero": dict(max_iterations=0),
}


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_device_loop_equals_serial_loop_and_jax(case, k):
    """Any check interval gives the serial loop's results exactly: the
    iteration count, ``converged``, the warp, the telemetry (zero past the
    count) and max |u|; the adaptive rate halves where the serial loop's
    does. And the JAX solve's, within the solver tolerances."""
    canonical, live, warp = tsdf_like((12, 10, 8), 31, warp_scale=0.3)
    jp, tp = _params(**LOOP_CASES[case])
    loop = SolveLoop(canonical.shape, tp, "cpu", check_every=k)
    got = loop.solve(t(canonical), t(live), t(warp))
    w, it, conv, tel, md, rate = _serial(t(canonical), t(live), tp, t(warp))
    assert (got.iterations, got.converged) == (it, conv)
    np.testing.assert_array_equal(n(got.warp), n(w))
    np.testing.assert_array_equal(np.stack([n(b) for b in got.telemetry]), n(tel))
    np.testing.assert_array_equal(n(got.max_abs_displacement), n(md))
    assert float(loop.rate) == float(rate)
    if case == "converges":
        assert got.converged and 0 < it < 60 and (k == 1 or it % k)  # stops mid-chunk
    if case == "halving":
        assert float(rate) < tp.learning_rate
    if tp.max_iterations:  # JAX's solve does not trace with 0 (an index into size 0)
        want = jsolve(jnp.asarray(canonical), jnp.asarray(live), jp, jnp.asarray(warp))
        _compare(got, want, tp.max_iterations)


def test_loop_serves_a_sequence_of_solves():
    """One SolveLoop reused for solves of other inputs gives what a new one
    gives each time (no state carried over)."""
    tp = _params(max_iterations=12, convergence_threshold=0.02)[1]
    loop = SolveLoop((12, 10, 8), tp, "cpu", check_every=4)
    for seed in (40, 41, 42):
        canonical, live, warp = (t(a) for a in tsdf_like((12, 10, 8), seed, warp_scale=0.3))
        got, want = loop.solve(canonical, live, warp), tsolve(canonical, live, tp, warp)
        assert (got.iterations, got.converged) == (want.iterations, want.converged)
        np.testing.assert_array_equal(n(got.warp), n(want.warp))
        for a, b in zip(got.telemetry, want.telemetry):
            np.testing.assert_array_equal(n(a), n(b))


def _kept_pairs(shape, seeds):
    pairs = [tuple(t(a) for a in tsdf_like(shape, seed, warp_scale=0.3)) for seed in seeds]
    return [(c, l, w if i % 2 == 0 else None) for i, (c, l, w) in enumerate(pairs)]


def _assert_same(got, want):
    assert (got.iterations, got.converged) == (want.iterations, want.converged)
    for a, b in zip((got.warp, got.max_abs_displacement, *got.telemetry),
                    (want.warp, want.max_abs_displacement, *want.telemetry)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(12, 10, 8), (14, 10)])
def test_kept_loop_gives_a_new_loops_results(shape):
    """Three solves in a row with one key, a warm start and then none, each
    equal to a new loop's exactly: nothing of one call leaks into the next,
    and a result returned earlier does not change after later calls."""
    release_kept_loops()
    tp = _params(max_iterations=20, convergence_threshold=0.02)[1]
    pairs = _kept_pairs(shape, (70, 71, 72))
    got, copies = [], []
    for c, l, w in pairs:
        got.append(tsolve(c, l, tp, w))
        copies.append([x.clone() for x in (got[-1].warp, got[-1].max_abs_displacement,
                                           *got[-1].telemetry)])
    for res, (c, l, w), copy in zip(got, pairs, copies):
        _assert_same(res, SolveLoop(shape, tp, "cpu", graph=False).solve(c, l, w))
        assert all(torch.equal(a, b) for a, b in zip(
            (res.warp, res.max_abs_displacement, *res.telemetry), copy))


def _counted(fn, tmp_path):
    """``fn()``'s result, the counters and the span names recorded while it ran."""
    from levelsetfusion_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path)):
        out = fn()
    return out, profiling.counters(), set(profiling.spans())


def test_kept_loop_is_reused_and_replaced(tmp_path):
    """A call with a kept loop's key builds nothing (counted as kept, no
    capture); one of another shape builds a loop kept beside the first, the
    last used first; one of other params releases both and builds its own;
    ``release_kept_loops`` empties the slot."""
    release_kept_loops()
    assert single_level._kept_loops() == {}
    tp = _params(max_iterations=8, convergence_threshold=0.0)[1]
    (c, l, _), = _kept_pairs((12, 10, 8), (80,))
    (c2, l2, _), = _kept_pairs((10, 10, 8), (81,))
    cpu = torch.device("cpu")

    def kept():
        return single_level._kept_loops()[cpu]

    _, counts, _ = _counted(lambda: tsolve(c, l, tp), tmp_path)
    first, = kept()
    assert counts == {"solve.loop_built": 1} and first.shape == (12, 10, 8)
    _, counts, spans = _counted(lambda: tsolve(c, l, tp), tmp_path)
    assert counts == {"solve.loop_kept": 1} and kept() == [first]
    assert "lsf.solve.capture" not in spans
    _, counts, _ = _counted(lambda: tsolve(c2, l2, tp), tmp_path)
    second = kept()[0]
    assert counts == {"solve.loop_built": 1} and kept() == [second, first]
    assert second.shape == (10, 10, 8)
    _, counts, _ = _counted(lambda: tsolve(c, l, tp), tmp_path)
    assert counts == {"solve.loop_kept": 1} and kept() == [first, second]
    other = tp.replace(learning_rate=0.2)
    _, counts, _ = _counted(lambda: tsolve(c, l, other), tmp_path)
    assert counts == {"solve.loop_built": 1} and len(kept()) == 1
    assert kept()[0] is not first and kept()[0].params == other
    assert len(single_level._kept_loops()) == 1
    release_kept_loops()
    assert single_level._kept_loops() == {}


def test_each_thread_keeps_its_own_loop():
    """Two threads solving with one key at once each build and keep a loop
    of their own, and give the answers of solving one after the other."""
    tp = _params(max_iterations=12, convergence_threshold=0.0)[1]
    pairs = _kept_pairs((12, 10, 8), (90, 91))
    serial = [SolveLoop((12, 10, 8), tp, "cpu").solve(c, l, w) for c, l, w in pairs]
    barrier, got, loops = threading.Barrier(2), [None, None], [None, None]

    def solve(i):
        barrier.wait(timeout=60)
        got[i] = tsolve(*pairs[i][:2], tp, pairs[i][2])
        loops[i] = single_level._kept_loops()[torch.device("cpu")][0]

    threads = [threading.Thread(target=solve, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert loops[0] is not None and loops[0] is not loops[1]
    for res, want in zip(got, serial):
        _assert_same(res, want)


@pytest.mark.card
def test_kept_loop_captures_once_on_the_card(tmp_path):
    """On the card the second call of one key replays the kept graph:
    no capture, ``captured_count`` unchanged, the first call's answer, also
    from another stream than the first call's; its counters are the kept
    loop's and its three replays' kernels and iterations."""
    from levelsetfusion_tpu_torch.ops.kernels import loop_tail

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    release_kept_loops()
    tp = _params(max_iterations=40, convergence_threshold=0.0)[1]
    (c, l, w), = _kept_pairs((32, 32, 24), (95,))
    c, l, w = c.cuda(), l.cuda(), w.cuda()
    first = tsolve(c, l, tp, w)
    kernels = (fused_gradient, resample, loop_tail)
    captured = [m.captured_count for m in kernels]
    loop = single_level.loop_for(tuple(c.shape), tp, c.device)
    replays = loop.replays
    with torch.cuda.stream(torch.cuda.Stream()):
        again, counts, spans = _counted(lambda: tsolve(c, l, tp, w), tmp_path)
        torch.cuda.current_stream().synchronize()
    assert [m.captured_count for m in kernels] == captured
    replays = loop.replays - replays
    assert replays == 3 and loop.chunk_kernels == 4 * 16  # B1, B2's two, the tail
    assert counts == {"solve.loop_kept": 1, "solve.graph_kernels": loop.chunk_kernels * replays,
                      "solve.graph_iterations": 16 * replays}
    assert "lsf.solve.capture" not in spans
    _assert_same(again, first)
    release_kept_loops()


def test_flag_off_leaves_outputs_unwritten():
    """With the flag false the plain versions compute nothing: the resample
    and the stats come back NaN (the kernels' unwritten outputs) and ``out``
    keeps what it held; with it true they equal the calls without it."""
    canonical, live, warp = (t(a) for a in tsdf_like((6, 5, 4), 50))
    warp_cm = to_component_major(warp)
    on, off = torch.tensor(True), torch.tensor(False)
    assert torch.isnan(warp_field_cm_reference(live, warp_cm, off)).all()
    np.testing.assert_array_equal(n(warp_field_cm(live, warp_cm, active=on)),
                                  n(warp_field_cm(live, warp_cm)))
    rate = torch.tensor(0.3)
    out = torch.full_like(warp_cm, 7.0)
    new, stats = fused_gradient_update_reference(live, canonical, warp_cm, rate, out=out,
                                                 active=off)
    assert new is out and bool((out == 7.0).all()) and torch.isnan(stats).all()
    new, stats = fused_gradient_update(live, canonical, warp_cm, rate, out=out, active=on)
    want_w, want_s = fused_gradient_update(live, canonical, warp_cm, rate)
    assert new is out
    np.testing.assert_array_equal(n(out), n(want_w))
    np.testing.assert_array_equal(n(stats), n(want_s))
    with pytest.raises(ValueError, match="apart from warp_cm"):
        fused_gradient_update(live, canonical, warp_cm, rate, out=warp_cm)
    with pytest.raises(TypeError, match="0-d bool"):
        warp_field_cm(live, warp_cm, active=torch.tensor(1.0))


def test_each_loop_brings_its_own_ticket(monkeypatch):
    """B2's completion ticket is the loop's own: a captured graph replays on
    whatever stream is current, so two loops must never share one, and
    every B2 call a loop makes passes its ticket."""
    from levelsetfusion_tpu_torch.models import single_level

    tp = _params(max_iterations=5, convergence_threshold=0.0)[1]
    a, b = (SolveLoop((6, 5, 4), tp, "cpu", check_every=2) for _ in range(2))
    assert a.ticket.data_ptr() != b.ticket.data_ptr()
    assert a.ticket.dtype == torch.int32 and a.ticket.numel() == 1 and int(a.ticket) == 0
    tickets = []

    def spy(*args, ticket=None, **kw):
        tickets.append(ticket)
        return fused_gradient_update(*args, ticket=ticket, **kw)

    monkeypatch.setattr(single_level, "fused_gradient_update", spy)
    canonical, live, _ = (t(x) for x in tsdf_like((6, 5, 4), 60))
    a.solve(canonical, live)
    assert len(tickets) == 6 and all(x is a.ticket for x in tickets)  # 3 chunks of 2
    with pytest.raises(ValueError, match="one int32"):
        fused_gradient_update(live, canonical, to_component_major(torch.zeros(6, 5, 4, 3)),
                              torch.tensor(0.1), ticket=torch.zeros(1))


def test_3d_loop_calls_b1_b2_and_the_tail(monkeypatch):
    """Every 3D iteration, frozen ones included, is B1, then B2 on B1's
    warped field, then one ``loop_tail`` call on B2's stats with the loop's
    flag and state buffers, in that order; the 2D step is not called."""
    from levelsetfusion_tpu_torch.ops.kernels import loop_tail, step2d

    events = []

    def spy(name, real, pick):
        def call(*args, **kw):
            out = real(*args, **kw)
            events.append((name, args, kw, pick(out)))
            return out
        return call

    def refuse(*args, **kw):
        raise AssertionError("a 3D iteration called the 2D step")

    monkeypatch.setattr(single_level, "warp_field_cm",
                        spy("b1", warp_field_cm, lambda out: out))
    monkeypatch.setattr(single_level, "fused_gradient_update",
                        spy("b2", fused_gradient_update, lambda out: out[1]))
    monkeypatch.setattr(loop_tail, "loop_tail", spy("tail", loop_tail.loop_tail, lambda out: out))
    monkeypatch.setattr(step2d, "step2d", refuse)
    tp = _params(max_iterations=5, convergence_threshold=0.0)[1]
    loop = SolveLoop((6, 5, 4), tp, "cpu", check_every=4)
    canonical, live, warp = (t(x) for x in tsdf_like((6, 5, 4), 61))
    res = loop.solve(canonical, live, warp)
    assert res.iterations == 5
    assert [e[0] for e in events] == ["b1", "b2", "tail"] * 8  # two chunks of 4
    state = (loop.active, loop.rate, loop.prev_energy, loop.telemetry, loop.max_disp,
             loop.max_update, loop.iteration, loop.active)
    for b1, b2, tail in zip(events[0::3], events[1::3], events[2::3]):
        assert b1[2]["active"] is loop.active and b2[2]["active"] is loop.active
        assert b2[1][0] is b1[3]  # B2 takes B1's warped field
        assert tail[1][0] is b2[3]  # the tail takes B2's stats
        assert all(a is b for a, b in zip(tail[1][1:], state)) and len(tail[1]) == 9
        assert tail[2] == dict(threshold=loop.threshold, voxels=6 * 5 * 4,
                               adaptive=tp.adaptive_learning_rate)


def test_loop_device_is_required():
    """The loop has no default device: a caller names the CPU to get it."""
    with pytest.raises(TypeError):
        SolveLoop((6, 5, 4), tparams.SolverParams())


def _serial_2d(canonical, live, p, initial_warp):
    """The 2D serial loop: B1's plain version, the gradient assembly and
    the update as the JAX twin's unfused step, and a host read of
    ``max_update`` after every iteration."""
    warp_cm = to_component_major(initial_warp)
    kw = dict(data_term_weight=p.data_term_weight,
              smoothing_term_weight=p.smoothing_term_weight,
              level_set_term_weight=p.level_set_term_weight, smoothing_mode=p.smoothing_mode,
              rigidity_enforcement_factor=p.rigidity_enforcement_factor,
              band_union_only=p.band_union_only,
              sobolev_kernel=torch.as_tensor(sobolev.generate_1d_sobolev_kernel(
                  p.sobolev_kernel_size, p.sobolev_strength)) if p.sobolev_smoothing else None)
    n = p.max_iterations
    threshold = float(np.float32(p.convergence_threshold))
    telemetry = torch.zeros((5, n))
    rate = torch.tensor(p.learning_rate)
    prev = torch.tensor(float("inf"))
    max_disp = torch.amax(torch.abs(warp_cm), dim=(1, 2))
    max_update, it = float("inf"), 0
    while it < n and max_update >= threshold:
        res = energy_gradient(canonical, warp_field_cm(live, warp_cm), warp_cm.movedim(0, -1),
                              **kw)
        update = -rate * res.gradient
        warp_cm = warp_cm + update.movedim(-1, 0)
        length = torch.sqrt(torch.sum(update * update, dim=-1))
        energy = res.energies.data + res.energies.smoothing + res.energies.level_set
        if p.adaptive_learning_rate:
            rate = torch.where(energy > prev, rate * 0.5, rate)
        prev = energy
        telemetry[:, it] = torch.stack([*res.energies, torch.amax(length),
                                        torch.sum(length) / float(canonical.numel())])
        max_disp = torch.maximum(max_disp, torch.amax(torch.abs(warp_cm), dim=(1, 2)))
        max_update = float(torch.amax(length))
        it += 1
    max_disp = torch.maximum(max_disp, torch.amax(torch.abs(warp_cm), dim=(1, 2)))
    return warp_cm.movedim(0, -1), it, max_update < threshold, telemetry, max_disp, rate


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_2d_loop_equals_serial_loop_and_jax(case, k):
    """The 2D loop (B1, then the plain gradient and update, gated by the
    done flag) gives the serial loop's results exactly for any check
    interval, and JAX's unfused 2D solve's within the solver tolerances."""
    canonical, live, warp = tsdf_like((14, 10), 34, warp_scale=0.3)
    jp, tp = _params(**LOOP_CASES[case])
    loop = SolveLoop(canonical.shape, tp, "cpu", check_every=k)
    got = loop.solve(t(canonical), t(live), t(warp))
    w, it, conv, tel, md, rate = _serial_2d(t(canonical), t(live), tp, t(warp))
    assert (got.iterations, got.converged) == (it, conv)
    assert got.warp.shape == (14, 10, 2) and got.max_abs_displacement.shape == (2,)
    np.testing.assert_array_equal(n(got.warp), n(w))
    np.testing.assert_array_equal(np.stack([n(b) for b in got.telemetry]), n(tel))
    np.testing.assert_array_equal(n(got.max_abs_displacement), n(md))
    assert float(loop.rate) == float(rate)
    if case == "converges":
        assert got.converged and 0 < it < 60 and (k == 1 or it % k)  # stops mid-chunk
    if case == "halving":
        assert float(rate) < tp.learning_rate
    if tp.max_iterations:
        want = jsolve(jnp.asarray(canonical), jnp.asarray(live), jp, jnp.asarray(warp))
        _compare(got, want, tp.max_iterations)


def test_config1_preset_matches_jax():
    """config1 at its full preset (96 x 48, <= 600 iterations, Tikhonov, no
    Sobolev) on its CLI inputs: the iteration count to the 1e-3 gate, the
    warp and the telemetry as JAX's unfused 2D solve gives them."""
    from levelsetfusion_tpu.cli import _grid as jgrid
    from levelsetfusion_tpu.cli import _pair_2d as jpair

    cfg = _jax_presets()["config1_2d_pair"]
    canonical, live, _ = jpair(cfg, jgrid(cfg))
    want = jsolve(canonical, live, cfg.solver)
    got = tsolve(t(canonical), t(live), tparams.solver_params_from_jax(
        dataclasses.asdict(cfg.solver)))
    assert got.converged and 300 < got.iterations < 600
    _compare(got, want, 600)
