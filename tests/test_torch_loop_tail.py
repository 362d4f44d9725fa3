"""The loop tail (``ops/kernels/loop_tail.py``, ``csrc/loop_tail.cu``): the
solve loop's bookkeeping after an iteration's step in one call.

On the CPU the wrapper is its plain version, which must leave in the loop's
buffers the values worked out here in numpy float32 from the state before
the call, exactly, in 2D and 3D: with the adaptive rate on and off, the
energy rising, falling or tied, NaN in the stats, the iteration reaching its
cap, ``max_update`` crossing the threshold, and the flag off past the gate
and in the capture's warm-up; the wrapper's checks and the C prototype are
held here too. On the card (tests marked ``card``, skipped without one):

- the kernel equals the plain version bit for bit over sequences of random
  stats fed back through the flag, as the loop feeds them;
- with the flag off it writes nothing;
- the solve loop with the kernel, eager and captured, gives exactly what it
  gives with the plain version on the card, at config1's 96 x 48 and
  config3's 128³ with their presets' params.
"""

import numpy as np
import pytest
import torch

from levelsetfusion_tpu_torch.cli import _grid, _pair_2d, _pair_3d
from levelsetfusion_tpu_torch.models.single_level import SolveLoop
from levelsetfusion_tpu_torch.ops.kernels import fused_gradient, loop_tail, resample, step2d
from levelsetfusion_tpu_torch.utils.config import PRESETS
from torch_parity import c_prototype, ctypes_kind, n  # tests/ is on sys.path under pytest

CAP = 10  # the iteration cap of the CPU cases
THRESHOLD = 1e-3


def _state(dim, seed, device="cpu"):
    """The loop's buffers in the middle of a solve: iteration 3 of CAP, a
    rate of 0.5, a telemetry whose entries are all set (so an unwritten
    column shows), and the stats of one iteration: energies about 1, an
    update above the threshold."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    stats = np.concatenate([rng.uniform(0.2, 0.5, 3), [rng.uniform(1.0, 9.0)],
                            [rng.uniform(2.0, 4.0) * THRESHOLD], rng.uniform(0.5, 3.0, dim)])
    return dict(
        stats=torch.tensor(stats, **f32),
        rate=torch.tensor(0.5, **f32),
        prev_energy=torch.tensor(float(stats[:3].sum()), **f32),
        telemetry=torch.tensor(rng.uniform(-1.0, 1.0, (5, CAP + 1)), **f32),
        max_disp=torch.tensor(rng.uniform(0.5, 3.0, dim), **f32),
        max_update=torch.tensor(0.5, **f32),
        iteration=torch.tensor(3, dtype=torch.int64, device=device),
        active=torch.tensor(True, device=device),
    )


def _scenario(s, name):
    """Set up one case on the buffers ``s``."""
    stats, energy = s["stats"], float(s["stats"][0] + s["stats"][1] + s["stats"][2])
    if name == "rising":
        s["prev_energy"].fill_(energy * 0.9)
    elif name == "falling":
        s["prev_energy"].fill_(energy * 1.1)
    elif name == "tied":
        s["prev_energy"].copy_(stats[0] + stats[1] + stats[2])
    elif name == "first":
        s["prev_energy"].fill_(float("inf"))
    elif name == "nan_energy":
        stats[1] = float("nan")
    elif name == "nan_maxes":
        stats[4] = float("nan")
        stats[5] = float("nan")
        s["max_disp"][-1] = float("nan")
    elif name == "reaches_cap":
        s["iteration"].fill_(CAP - 1)
    elif name == "converges":
        stats[4] = THRESHOLD * 0.5
    elif name == "at_threshold":
        stats[4] = float(np.float32(THRESHOLD))
    elif name == "converged":  # an earlier iteration's update fell below the threshold
        s["max_update"].fill_(THRESHOLD * 0.5)


# (scenario, flag, adaptive rate). The flag ``on`` is the loop's ``active``
# buffer, as in a chunk; ``frozen`` the same, false, past the gate of a
# converged solve; ``warm_up`` a separate false flag while ``active`` is
# true, as in the capture's frozen warm-up iteration.
CASES = [
    ("rising", "on", True), ("rising", "on", False), ("falling", "on", True),
    ("tied", "on", True), ("first", "on", True), ("nan_energy", "on", True),
    ("nan_maxes", "on", True), ("reaches_cap", "on", True), ("converges", "on", True),
    ("at_threshold", "on", True), ("converged", "frozen", True), ("rising", "warm_up", True),
]


def _flag(s, kind):
    if kind == "on":
        return s["active"]
    if kind == "frozen":
        s["active"].fill_(False)
        return s["active"]
    return torch.zeros((), dtype=torch.bool, device=s["active"].device)


def _worked(s, on, adaptive, voxels):
    """The buffers the tail must leave, worked out in numpy float32 from
    ``s`` before the call: with the flag on, the energy (s0 + s1) + s2, the
    rate halved where it exceeds the previous energy (never on NaN), the
    telemetry column ``iteration`` (s0, s1, s2, s4, s3 / voxels), the
    per-axis maxes with NaN winning, the update s4, one more iteration; off,
    the entries in the spare column CAP and nothing else; then the done
    rule on what the buffers hold."""
    want = {k: n(v).copy() for k, v in s.items()}
    st = want["stats"]
    it = int(want["iteration"])
    entries = np.array([st[0], st[1], st[2], st[4], st[3] / np.float32(voxels)], np.float32)
    if on:
        energy = (st[0] + st[1]) + st[2]
        if adaptive and energy > want["prev_energy"]:
            want["rate"] = want["rate"] * np.float32(0.5)
        want["prev_energy"] = energy
        want["telemetry"][:, it] = entries
        want["max_disp"] = np.maximum(want["max_disp"], st[5:])
        want["max_update"] = st[4]
        it += 1
        want["iteration"] = np.int64(it)
    else:
        want["telemetry"][:, CAP] = entries
    want["active"] = np.bool_(it < CAP and want["max_update"] >= np.float32(THRESHOLD))
    return want


def _call(fn, s, flag, adaptive, voxels):
    fn(s["stats"], flag, s["rate"], s["prev_energy"], s["telemetry"], s["max_disp"],
       s["max_update"], s["iteration"], s["active"], threshold=float(np.float32(THRESHOLD)),
       voxels=voxels, adaptive=adaptive)


def _assert_same(got, want, columns=None):
    """Every buffer equal, NaN where NaN; the telemetry's first ``columns``."""
    for key in want:
        a, b = n(got[key]), n(want[key])
        if key == "telemetry" and columns is not None:
            a, b = a[:, :columns], b[:, :columns]
        np.testing.assert_array_equal(a, b, err_msg=key)


def _voxels(dim):
    return 96 * 48 if dim == 2 else 128 ** 3


# --- the plain version and the wrapper, on the CPU -------------------------


@pytest.mark.parametrize("scenario,flag,adaptive", CASES,
                         ids=[f"{c}-{f}-{'adaptive' if a else 'fixed'}" for c, f, a in CASES])
@pytest.mark.parametrize("dim", [2, 3])
def test_plain_version_gives_the_worked_values(dim, scenario, flag, adaptive):
    s = _state(dim, seed=dim + 10 * len(scenario))
    _scenario(s, scenario)
    gate = _flag(s, flag)
    want = _worked(s, flag == "on", adaptive, _voxels(dim))
    before = (loop_tail.launch_count, loop_tail.captured_count)
    _call(loop_tail.loop_tail, s, gate, adaptive, _voxels(dim))
    assert (loop_tail.launch_count, loop_tail.captured_count) == before  # CPU: plain version
    _assert_same(s, want)
    if scenario == "rising":
        assert float(s["rate"]) == (0.25 if adaptive and flag == "on" else 0.5)
    if scenario in ("tied", "nan_energy"):
        assert float(s["rate"]) == 0.5
    if flag == "on" and scenario in ("nan_maxes", "reaches_cap", "converges"):
        assert not bool(s["active"])
    if scenario == "at_threshold":
        assert bool(s["active"])


def test_argtypes_match_the_c_prototype():
    assert [ctypes_kind(a) for a in loop_tail.ARGTYPES] == c_prototype(
        "loop_tail.cu", "lsf_loop_tail")


def _bad(kind):
    s = _state(3, seed=1)
    if kind == "stats_len":
        s["stats"] = s["stats"][:7].clone()
    elif kind == "stats_dtype":
        s["stats"] = s["stats"].double()
    elif kind == "max_disp_dim":
        s["max_disp"], s["stats"] = torch.zeros(4), torch.zeros(9)
    elif kind == "max_disp_2d":
        s["max_disp"] = torch.zeros(1, 3)
    elif kind == "telemetry_rows":
        s["telemetry"] = torch.zeros(4, CAP + 1)
    elif kind == "telemetry_layout":
        s["telemetry"] = torch.zeros(CAP + 1, 5).t()
    elif kind == "rate_shape":
        s["rate"] = torch.tensor([0.5])
    elif kind == "prev_dtype":
        s["prev_energy"] = torch.tensor(1.0, dtype=torch.float64)
    elif kind == "iteration_dtype":
        s["iteration"] = torch.tensor(3, dtype=torch.int32)
    elif kind == "active_dtype":
        s["active"] = torch.tensor(1.0)
    elif kind == "device":
        s["max_update"] = torch.empty((), device="meta")
    return s


@pytest.mark.parametrize("kind,error", [
    ("stats_len", ValueError), ("stats_dtype", TypeError), ("max_disp_dim", ValueError),
    ("max_disp_2d", ValueError), ("telemetry_rows", ValueError),
    ("telemetry_layout", ValueError), ("rate_shape", TypeError), ("prev_dtype", TypeError),
    ("iteration_dtype", TypeError), ("active_dtype", TypeError), ("device", ValueError),
])
def test_wrapper_refuses(kind, error):
    s = _bad(kind)
    with pytest.raises(error):
        _call(loop_tail.loop_tail, s, s["active"], True, 100)


def test_wrapper_refuses_a_flag_that_is_not_a_bool():
    s = _state(2, seed=2)
    for flag in (None, torch.tensor(1.0), torch.tensor([True])):
        with pytest.raises(TypeError):
            _call(loop_tail.loop_tail, s, flag, True, 100)


# --- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda", torch.cuda.current_device())


def _random_stats(rng, dim, step):
    """One iteration's stats: energies that mostly fall and sometimes rise,
    updates around the threshold, now and then a NaN or an infinity."""
    energies = rng.uniform(0.2, 0.4, 3) * (1.0 + 0.05 * rng.standard_normal()) / (1 + step)
    stats = np.concatenate([energies, [rng.uniform(1.0, 9.0)],
                            [rng.uniform(0.6, 3.0) * THRESHOLD], rng.uniform(0.5, 3.0, dim)])
    odd = rng.uniform()
    if odd < 0.04:
        stats[rng.integers(len(stats))] = float("nan")
    elif odd < 0.06:
        stats[rng.integers(len(stats))] = float("inf")
    return stats.astype(np.float32)


@pytest.mark.card
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed"])
@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_equals_plain_version_on_the_card(dim, adaptive):
    """Sequences of random stats through both, each fed back through the
    flag as the loop feeds it (the flag is ``active``); after every call
    every buffer is the plain version's, the telemetry's first CAP columns
    (the plain version writes a frozen call's column into column CAP)."""
    dev = _card()
    rng = np.random.default_rng(dim * 7 + adaptive)
    before = loop_tail.launch_count
    calls = 0
    for seq in range(12):
        want = _state(dim, seed=100 + seq)
        want["prev_energy"].fill_(float("inf"))
        want["iteration"].zero_()
        got = {k: v.to(dev) for k, v in want.items()}
        for step in range(CAP + 3):
            stats = _random_stats(rng, dim, step)
            want["stats"].copy_(torch.from_numpy(stats))
            got["stats"].copy_(torch.from_numpy(stats))
            _call(loop_tail.loop_tail, want, want["active"], adaptive, _voxels(dim))
            _call(loop_tail.loop_tail, got, got["active"], adaptive, _voxels(dim))
            calls += 1
            torch.cuda.synchronize()
            _assert_same(got, want, columns=CAP)
    assert loop_tail.launch_count == before + calls


@pytest.mark.card
@pytest.mark.parametrize("alias", [True, False], ids=["frozen", "warm_up"])
@pytest.mark.parametrize("dim", [2, 3])
def test_flag_off_leaves_every_buffer_on_the_card(dim, alias):
    dev = _card()
    s = {k: v.to(dev) for k, v in _state(dim, seed=7).items()}
    flag = _flag(s, "frozen" if alias else "warm_up")
    before = {k: v.clone() for k, v in s.items()}
    _call(loop_tail.loop_tail, s, flag, True, _voxels(dim))
    torch.cuda.synchronize()
    for key in s:
        assert torch.equal(s[key], before[key]), key


def _preset_pair(name, dev):
    cfg = PRESETS[name]
    make = _pair_2d if len(cfg.grid_shape) == 2 else _pair_3d
    canonical, live, *_ = make(cfg, _grid(cfg), dev)
    return cfg.solver, canonical, live


@pytest.mark.card
@pytest.mark.parametrize("preset", ["config1_2d_pair", "config3_3d_full_energy"])
def test_captured_chunk_replays_the_former_loop(preset, monkeypatch):
    """The preset's pair at its shape and params: the loop with the tail
    kernel, eager and captured, gives exactly what the eager loop gives with
    the plain version's ops on the card (the same step kernels), and the
    capture records 16 tail launches a chunk, one an iteration."""
    dev = _card()
    params, canonical, live = _preset_pair(preset, dev)
    shape = tuple(canonical.shape)
    with monkeypatch.context() as m:
        m.setattr(loop_tail, "loop_tail", loop_tail.loop_tail_reference)
        former = SolveLoop(shape, params, dev, graph=False).solve(canonical, live)
    eager = SolveLoop(shape, params, dev, graph=False).solve(canonical, live)
    before = loop_tail.launch_count
    loop = SolveLoop(shape, params, dev)
    got = loop.solve(canonical, live)
    torch.cuda.synchronize()
    three = len(shape) == 3
    assert loop.graph_launches == {resample: 16 * three, fused_gradient: 16 * three,
                                   step2d: 16 * (not three), loop_tail: 16}
    assert loop_tail.launch_count == before + 1 + 16 * loop.replays  # + the warm-up
    print(preset, "iterations", former.iterations, "replays", loop.replays)
    for res in (eager, got):
        assert (res.iterations, res.converged) == (former.iterations, former.converged)
        assert torch.equal(res.warp, former.warp)
        for a, b in zip(res.telemetry, former.telemetry):
            assert torch.equal(a, b)
        assert torch.equal(res.max_abs_displacement, former.max_abs_displacement)
