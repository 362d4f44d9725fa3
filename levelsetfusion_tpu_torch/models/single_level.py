"""Single-level non-rigid warp solver. Twin of
``levelsetfusion_tpu/models/single_level.py`` (its fused path).

Gradient descent on the warp aligning ``live`` to ``canonical``, 2D or 3D.
The warp is carried component-major ``(D, *spatial)``, the layout the
kernels take. A 3D iteration is one resample (B1,
``ops/kernels/resample.py``) and one fused gradient/update (B2,
``ops/kernels/fused_gradient.py``). A 2D iteration is one call of the 2D
step (``ops/kernels/step2d.py``): the resample, the JAX twin's unfused
``_solver_step`` (the gradient of the warped field, the terms, the optional
Sobolev filter) and u' = u − rate·g with its statistics; B2 does not take
2D, since its zero-padded Sobolev pass along a y axis of length 1 would
scale g by the centre tap. After the step, one call of the loop tail
(``ops/kernels/loop_tail.py``) updates the loop's state from the step's
statistics, in 2D and 3D. The same loop runs on every device: the kernel
wrappers launch the CUDA kernels for CUDA tensors and their plain versions
for CPU tensors.

Semantics kept from the JAX twin:

- the loop runs while ``iteration < max_iterations`` and the last
  ``max_update >= convergence_threshold`` (the first iteration always runs);
- with ``adaptive_learning_rate`` the rate halves when the total energy
  exceeds the previous iteration's (the first comparison is against +inf);
- five telemetry buffers of length ``max_iterations``, zero past
  ``iterations``; mean update = Σ‖δu‖ / voxel count;
- ``converged = max_update < convergence_threshold``;
- ``max_abs_displacement`` is the per-axis max |u| over the warm start,
  every updated warp and the final warp (in 2D JAX takes each entering
  warp and the final one: the same set).

The loop lives on the device, as JAX's ``lax.while_loop`` does. The done
test is a device flag, ``active = (iteration < n) & (max_update >=
threshold)``, that every iteration recomputes; once it is false the state
stays frozen: the kernels, the loop tail's among them, read the flag and
return at once (the tail's plain version takes the scalar state and the
telemetry column's new values only where it is true, with ``torch.where``,
and writes a frozen iteration's column into the spare column ``n``). The
host reads the flag once every ``check_every``
iterations (a chunk), so a solve runs as many iterations as the serial loop
and gives its results exactly, whatever ``check_every``. The warp lives in
two buffers that the iterations ping-pong; after ``iterations`` active
iterations it lies in buffer ``iterations % 2``.

On CUDA the chunk is captured once as a CUDA graph and replayed: the
Python work of the iterations' calls leaves the loop, and a replay runs two
kernels an iteration in 2D (the step, the tail) and four in 3D (B1, B2's
two, the tail). On the CPU, or with ``SolveLoop(..., graph=False)``, the
same chunk runs eagerly. A capture or replay that fails raises. Under
``utils.debug.nan_checks`` every solve runs serially instead, checked for
NaN and Inf each iteration.

``loop_for`` owns the loop of every ``solve_single_level`` call, and so of
every fusion frame and hierarchical level, which solve through it: each
thread keeps, a device, the loops of one ``SolverParams``, one a shape. A
call of a kept loop's shape and params reuses it (no build, no capture); a
new shape under those params builds a loop kept beside the others; other
params release every loop of the device first. So the loops, their state
buffers and on CUDA their graphs and graph pools, stay on the device after
the call returns, until a call of other params or ``release_kept_loops``
(a thread that alternates shapes under one params keeps one loop a shape
until then). ``solve`` resets every state buffer and returns copies, so a
reused loop gives a new loop's results exactly.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from levelsetfusion_tpu_torch.models.params import SmoothingMode, SolverParams
from levelsetfusion_tpu_torch.ops.kernels import fused_gradient, loop_tail, resample, step2d
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import (
    from_component_major,
    fused_gradient_update,
    sobolev_taps,
    to_component_major,
)
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm
from levelsetfusion_tpu_torch.utils.profiling import count, graph_kernel_nodes, span

# Iterations between two host reads of the done flag (one chunk, one graph
# replay). Even, so that every replay starts from the same warp buffer.
CHECK_EVERY = 16


def fused_step_kwargs(params: SolverParams) -> dict:
    """B2's (``fused_gradient_update``'s) and the 2D step's (``step2d``'s)
    energy and filter arguments for a solve with ``params``."""
    return dict(
        w_data=params.data_term_weight,
        w_smooth=params.smoothing_term_weight,
        w_ls=params.level_set_term_weight,
        killing=params.smoothing_mode is SmoothingMode.KILLING,
        gamma=params.rigidity_enforcement_factor,
        band_union=params.band_union_only,
        taps=(sobolev_taps(params.sobolev_kernel_size, params.sobolev_strength)
              if params.sobolev_smoothing else ()),
    )


class SolveTelemetry(NamedTuple):
    """Per-iteration log: energy components and warp-update statistics;
    entries past ``iterations`` are 0."""

    data_energy: torch.Tensor
    smoothing_energy: torch.Tensor
    level_set_energy: torch.Tensor
    max_warp_update: torch.Tensor
    mean_warp_update: torch.Tensor


class SolveResult(NamedTuple):
    warp: torch.Tensor  # (*spatial, D)
    iterations: int
    converged: bool
    telemetry: SolveTelemetry
    # Per-axis running max of |u| (voxel units) over every warp the solve
    # resampled with, the warm start included, and the final warp.
    max_abs_displacement: torch.Tensor


class SolveLoop:
    """The device-side solve loop for one volume shape, device and
    ``SolverParams``: the state buffers and, on CUDA, the captured chunk.
    ``solve`` copies its inputs into the buffers, so one loop serves a
    sequence of solves (the fusion frames) with one capture.

    Capture hazards, each handled here:
    - B2's and the tiled 2D step's completion ticket is this loop's own
      (``self.ticket``): the graph replays on whatever stream is current,
      so a ticket kept per stream handle could be shared with another
      loop's graph or a direct call on that stream.
    - The kernels' shared memory opt-in and occupancy are cached per device
      (``csrc/occupancy.cuh``): one frozen iteration on the capture stream
      before the capture creates both outside it, and loads every kernel
      the chunk launches.
    - B1's and B2's scratch (the warped field, g, the partial rows, the
      stats) is allocated per call; inside the capture it comes from the
      graph's pool, where each iteration reuses the last one's, so the graph
      holds one iteration's scratch whatever ``check_every``; the two warps
      and the 2D step's stats and partial rows are this object's, so that a
      2D chunk allocates nothing.
    - The wrappers launch on ``torch.cuda.current_stream``, which is the
      capture stream inside ``torch.cuda.graph``.
    - The Sobolev taps go by value in a struct; nothing in the chunk reads
      a value back to the host.
    - A wrapper called while capturing adds to its ``captured_count``, not
      its ``launch_count``; ``_capture`` keeps what each kernel's count rose
      by (``graph_launches``), and ``_replay`` adds that to its
      ``launch_count`` each replay.
    - ``_capture`` also keeps the kernel nodes of the captured graph, every
      kernel a chunk replays and not only the wrappers' (``chunk_kernels``:
      the graph is kept until they are counted, then instantiated);
      ``_replay`` adds them to counter ``solve.graph_kernels``, the
      chunk's iterations to ``solve.graph_iterations`` and the 2D step's
      launches its capture recorded, if any, to ``solve.step2d_iterations``
      while a profiler runs.
    """

    def __init__(self, shape, params: SolverParams, device, *,
                 check_every: int = CHECK_EVERY, graph: bool = True):
        if len(shape) not in (2, 3):
            raise ValueError(f"the solve takes a 2D or 3D volume, got {tuple(shape)}")
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.graphed = graph and self.device.type == "cuda"
        if self.graphed and check_every % 2:
            raise ValueError(
                f"a captured chunk needs an even check_every, got {check_every}: "
                "each replay must start from the same warp buffer"
            )
        self.shape = tuple(shape)
        self.dim = len(shape)
        self._spatial = tuple(range(1, self.dim + 1))
        self.params = params
        self.check_every = check_every
        self.n = params.max_iterations
        # The JAX twin compares its f32 max_update against the threshold
        # rounded to f32; compare the same way.
        self.threshold = float(np.float32(params.convergence_threshold))
        self.replays = 0
        self.stream = None  # the CUDA stream of its last call through loop_for
        self._graph = None
        self.graph_launches = None  # {kernel module: calls its capture recorded}
        self.chunk_kernels = None  # kernel nodes of the captured chunk
        self._build()

    def _build(self) -> None:
        """The state buffers and the kernels' fixed arguments."""
        params = self.params
        f32 = dict(dtype=torch.float32, device=self.device)
        self.canonical = torch.zeros(self.shape, **f32)
        self.live = torch.zeros(self.shape, **f32)
        self.warps = (torch.zeros((self.dim, *self.shape), **f32),
                      torch.zeros((self.dim, *self.shape), **f32))
        self.telemetry = torch.zeros((5, self.n + 1), **f32)
        self.rate = torch.zeros((), **f32)
        self.prev_energy = torch.zeros((), **f32)
        self.max_update = torch.zeros((), **f32)
        self.max_disp = torch.zeros(self.dim, **f32)
        self.iteration = torch.zeros((), dtype=torch.int64, device=self.device)
        self.active = torch.zeros((), dtype=torch.bool, device=self.device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._kw = dict(fused_step_kwargs(params), ticket=self.ticket)
        self._tail_kw = dict(threshold=self.threshold, voxels=int(np.prod(self.shape)),
                             adaptive=params.adaptive_learning_rate)
        if self.dim == 2:  # the 2D step's outputs and scratch
            self._stats = torch.zeros(len(step2d.STATS_FIELDS), **f32)
            self._partial = torch.zeros(
                step2d.partial_len(self.shape, len(self._kw["taps"]), self.device),
                dtype=torch.float64, device=self.device)

    def _iteration(self, parity: int, flag: torch.Tensor) -> None:
        """One iteration from warp buffer ``parity`` into the other, gated
        by ``flag``; then the flag of the next iteration."""
        src, dst = self.warps[parity], self.warps[1 - parity]
        if self.dim == 3:
            warped = warp_field_cm(self.live, src, active=flag)
            _, stats = fused_gradient_update(warped, self.canonical, src, self.rate,
                                             out=dst, active=flag, **self._kw)
        else:
            _, stats = step2d.step2d(self.live, self.canonical, src, self.rate, out=dst,
                                     stats=self._stats, partial=self._partial, active=flag,
                                     **self._kw)
        loop_tail.loop_tail(stats, flag, self.rate, self.prev_energy, self.telemetry,
                            self.max_disp, self.max_update, self.iteration, self.active,
                            **self._tail_kw)

    def _chunk(self, first: int) -> None:
        for j in range(first, first + self.check_every):
            self._iteration(j % 2, self.active)

    def _checked_iterations(self, error) -> None:
        """``utils.debug.nan_checks``' loop: the serial loop, one iteration
        and one host read at a time, raising NonFiniteError at the first
        iteration whose telemetry or new warp holds a NaN or Inf."""
        j = 0
        while bool(self.active):
            self._iteration(j % 2, self.active)
            column = self.telemetry[:, j]
            finite = torch.cat([torch.isfinite(column),
                                torch.isfinite(self.warps[(j + 1) % 2]).all().view(1)])
            if not bool(finite.all()):
                names = [*SolveTelemetry._fields, "warp"]
                bad = [n for n, ok in zip(names, finite.tolist()) if not ok]
                raise error(
                    f"solve: iteration {j}: non-finite {', '.join(bad)} (nan_checks)")
            j += 1

    def _capture(self) -> None:
        with span("lsf.solve.capture"):
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                # The frozen warm-up iteration: it changes no state.
                self._iteration(0, torch.zeros((), dtype=torch.bool, device=self.device))
            torch.cuda.current_stream(self.device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            kernels = (resample, fused_gradient, step2d, loop_tail)
            before = [m.captured_count for m in kernels]
            with torch.cuda.graph(graph, stream=stream):
                self._chunk(0)
            self.graph_launches = {m: m.captured_count - b for m, b in zip(kernels, before)}
            self.chunk_kernels = graph_kernel_nodes(graph)
            graph.instantiate()
            self._graph = graph

    def _replay(self) -> None:
        self._graph.replay()
        for module, calls in self.graph_launches.items():
            module.launch_count += calls
        count("solve.graph_kernels", self.chunk_kernels)
        count("solve.graph_iterations", self.check_every)
        if self.graph_launches.get(step2d):
            count("solve.step2d_iterations", self.graph_launches[step2d])
        self.replays += 1

    def solve(self, canonical: torch.Tensor, live: torch.Tensor,
              initial_warp: torch.Tensor | None = None) -> SolveResult:
        """Optimize the warp aligning ``live`` to ``canonical`` (both
        ``self.shape``, float32, on ``self.device``) from ``initial_warp``
        (``(*self.shape, D)``, else zeros)."""
        with span("lsf.solve"):
            return self._solve(canonical, live, initial_warp)

    def _solve(self, canonical, live, initial_warp) -> SolveResult:
        for name, t in (("canonical", canonical), ("live", live)):
            if tuple(t.shape) != self.shape or t.device != self.device:
                raise ValueError(f"{name} {tuple(t.shape)} on {t.device}: this loop takes "
                                 f"{self.shape} on {self.device}")
        self.canonical.copy_(canonical)
        self.live.copy_(live)
        if initial_warp is None:
            self.warps[0].zero_()
        else:
            self.warps[0].copy_(to_component_major(initial_warp))
        self.telemetry.zero_()
        self.rate.fill_(self.params.learning_rate)
        self.prev_energy.fill_(float("inf"))
        self.max_update.fill_(float("inf"))
        self.iteration.zero_()
        torch.amax(torch.abs(self.warps[0]), dim=self._spatial, out=self.max_disp)
        loop_tail.next_flag(self.iteration, self.max_update, self.n, self.threshold,
                            out=self.active)
        from levelsetfusion_tpu_torch.utils import debug  # utils imports the solvers

        if debug.nan_checks_enabled():
            self._checked_iterations(debug.NonFiniteError)
        chunks = 0
        while self._flag():  # the host's one read a chunk
            if not self.graphed:
                self._chunk(chunks * self.check_every)
            else:
                if self._graph is None:
                    self._capture()
                self._replay()
            chunks += 1
        with span("lsf.solve.result_read"):
            iterations, converged = torch.stack(
                [self.iteration, (self.max_update < self.threshold).long()]).tolist()
            final = self.warps[iterations % 2]
            return SolveResult(
                warp=from_component_major(final.clone()),
                iterations=iterations,
                converged=bool(converged),
                telemetry=SolveTelemetry(*self.telemetry[:, :self.n].clone()),
                max_abs_displacement=torch.maximum(
                    self.max_disp, torch.amax(torch.abs(final), dim=self._spatial)
                ),
            )

    def _flag(self) -> bool:
        """The host's read of the done flag."""
        with span("lsf.solve.flag_read"):
            return bool(self.active)


_kept = threading.local()  # .loops: {device: [SolveLoop, ...], last used first}


def _kept_loops() -> dict:
    """The calling thread's kept loops: a device's, all of one
    ``SolverParams``, most recently used first."""
    if not hasattr(_kept, "loops"):
        _kept.loops = {}
    return _kept.loops


def loop_for(shape, params: SolverParams, device) -> SolveLoop:
    """The calling thread's kept loop that solves ``shape`` with ``params``
    on ``device`` (a tensor's, so a CUDA one carries its index); where none
    is kept, a new loop kept beside the device's others, which are released
    first if they solve other ``params``. A reused loop's last call may have
    run on another CUDA stream, still reading its buffers: this call's
    stream waits for it."""
    kept = _kept_loops()
    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
    with span("lsf.solve.build"):
        loops = kept.get(device, [])
        if loops and loops[0].params != params:
            del kept[device]
            loops = []  # freed before the new loop allocates
        loop = next((x for x in loops if x.shape == shape), None)
        if loop is not None:
            loops.remove(loop)
            if loop.stream != stream:
                stream.wait_stream(loop.stream)
            count("solve.loop_kept")
        else:
            loop = SolveLoop(shape, params, device)
            count("solve.loop_built")
        loop.stream = stream
        kept[device] = [loop, *loops]
        return loop


def release_kept_loops() -> None:
    """Release the calling thread's kept loops: their state buffers and, on
    CUDA, their graphs and graph pools."""
    with span("lsf.solve.release"):
        _kept_loops().clear()


def solve_single_level(
    canonical: torch.Tensor,
    live: torch.Tensor,
    params: SolverParams = SolverParams(),
    initial_warp: torch.Tensor | None = None,
) -> SolveResult:
    """Optimize the warp aligning ``live`` to ``canonical``.

    Args:
      canonical: scalar TSDF field ``(X, Z)`` or ``(X, Y, Z)``, float32.
      live: scalar TSDF field, same shape and device.
      params: solver parameters.
      initial_warp: optional warm start ``(*spatial, D)``, else zeros.

    Runs on ``canonical``'s device, in ``loop_for``'s loop there (on CUDA
    through its captured graph).
    """
    return loop_for(tuple(canonical.shape), params, canonical.device).solve(
        canonical, live, initial_warp)
