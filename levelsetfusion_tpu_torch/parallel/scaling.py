"""Static communication accounting and a scaling model for the sharded
solvers. Twin of ``levelsetfusion_tpu/parallel/scaling.py``, counting the
port's own sends.

Every exchange of the port's solvers is ``parallel/halo.py::halo_exchange``:
one ``dist.batch_isend_irecv`` (a round) of ``P2POp`` isends of ``width``
slices to each side along one mesh axis, from as many ranks away as hold
them where a block is thinner than the halo (multi-hop); every reduction is
one ``all_reduce``. Nothing depends on the data, so the volumes are known
from the shapes. ``comm_bytes_per_iteration`` counts the sends of the
busiest rank: the one with the most neighbours along each axis (two where
the axis holds three or more ranks, one where it holds two, none where
one), which on a large mesh is every interior rank.

Per solver (``fused`` is the port's only path):

- **sync** (``parallel/sharded.py``, 1D): an iteration exchanges the warp's
  ``stencil_halo`` rows (3 components; issued before B1 and waited for
  before B2, so it overlaps B1: ``bytes_overlappable_per_iteration``) and
  the warped field's (1 channel): JAX's bytes and 2 rounds. A round of k
  iterations reduces once with ``pmax``, and once more with ``psum`` under
  the adaptive rate (JAX fuses the two into one round).
- **sync on the 2D mesh** (``parallel/sharded2d.py``): the warp's rows,
  then its columns of the row-extended block, (n0 + 2 hx) rows (the
  corners come from the diagonal neighbour); the warped field's rows and
  columns the same way: 4 rounds, as JAX's, but the column planes carry
  the extended rows (JAX counts x_local). Only the warp's rows overlap B1.
- **schur** (``parallel/schur.py``): an outer step of T inner iterations
  exchanges 2 frozen warp rows and 1 row of interface directions (3
  components each), and reduces twice (``psum``, ``pmax``; JAX once).
- **schur2d** (``parallel/schur2d.py``): per outer step the axis-0 warp
  rows and interface row, 2 reductions; per inner iteration one axis-1
  exchange of ``stencil_halo`` warp columns of the (n0 + 4)-row block
  (JAX: 8 columns on its fused path, the TPU's sublane rule).
- Once per solve: the live field's halo (``min(live_halo, block)`` slices,
  1 channel; both axes on the 2D mesh); the sync solvers also exchange the
  canonical's ``stencil_halo`` (JAX's does not count it), schur2d the
  canonical's columns; after the loop the sync solvers reduce 3 times
  (per-axis max |u|, the telemetry's sums and max), the Schur solvers once.

``predict_efficiency`` and ``predict_efficiency_2d`` price these sends for
H100s. Assumptions, none measured here: NVLink 4 between the GPUs of a
host at 450 GB/s each way per GPU, shared by all its neighbours (JAX priced
one 45 GB/s ICI link per torus direction, its two sides on two links);
InfiniBand NDR across hosts at 50 GB/s each way per NIC, one NIC a GPU
(JAX: 25 GB/s DCN); a round's latency 10 µs on NVLink and 20 µs across
hosts (NCCL's launch and handshake; JAX: 5 and 100 µs). The compute side
is a measured single-rank iteration: config5_512 at 512³ ran 9285.3 to
9345.7 µs/iter on one NVIDIA H100 80GB HBM3 at its 700 W limit
(``chip_smoke.py`` phase 23; ``CONFIG5_512_S_PER_ITER``).
"""

from __future__ import annotations

import dataclasses
import math

from levelsetfusion_tpu_torch.models.params import SolverParams

F32 = 4
NVLINK_BYTES_PER_S = 4.5e11  # assumption: NVLink 4, each way, per GPU
NVLINK_ROUND_S = 1e-5  # assumption: one NCCL send/recv round within a host
IB_BYTES_PER_S = 5e10  # assumption: InfiniBand NDR, each way, one NIC a GPU
IB_ROUND_S = 2e-5  # assumption: one NCCL round across hosts
CONFIG5_512_S_PER_ITER = 9.2853e-3  # measured: config5_512, one H100 (see above)


@dataclasses.dataclass(frozen=True)
class CommBudget:
    """The busiest rank's communication, send direction only (the matching
    receives ride the other direction)."""

    bytes_per_iteration: int  # halo sends, steady state
    bytes_once_per_solve: int  # the live (and canonical) halos
    ppermute_rounds_per_iteration: float  # batch_isend_irecv calls (Schur: x/T)
    reduction_rounds_per_iteration: float  # all_reduce calls
    # Of bytes_per_iteration, what is in flight while B1 runs (the sync
    # solvers' warp rows).
    bytes_overlappable_per_iteration: int = 0
    rounds_once_per_solve: int = 0
    reductions_once_per_solve: int = 0

    def total_bytes(self, iterations: int) -> int:
        return self.bytes_per_iteration * iterations + self.bytes_once_per_solve


def sent_slices(width: int, extent: int, size: int) -> int:
    """The slices the busiest rank along an axis of ``size`` ranks, blocks
    of ``extent`` slices, sends in one ``halo_exchange`` of ``width``: what
    each peer within reach holds of the halo, both sides."""
    if size == 1:
        return 0
    hops = -(-width // extent)
    parts = [min(extent, width - (k - 1) * extent) for k in range(1, hops + 1)]
    return max(sum(w * ((i - k >= 0) + (i + k < size)) for k, w in enumerate(parts, 1))
               for i in range(size))


def _rounds(size: int) -> int:
    """Rounds of one exchange along an axis of ``size`` ranks."""
    return int(size > 1)


def comm_bytes_per_iteration(
    shape,
    mesh_shape,
    params: SolverParams,
    *,
    live_halo: int = 8,
    solver_kind: str = "sync",
    inner_iterations: int = 8,
    fused: bool = True,
    dtype_bytes: int = F32,
) -> CommBudget:
    """The busiest rank's sends for one iteration of the port's solver (see
    the module docstring).

    Args:
      shape: global (X, Y, Z) voxel volume.
      mesh_shape: (n0,) for the 1D group or (n0, n1) for the 2D mesh.
      solver_kind: "sync" (either mesh), "schur" (1D) or "schur2d" (2D).
      fused: kept for JAX's signature; the port has only the fused path.
    """
    if not fused:
        raise ValueError("the port's solvers have only the fused path")
    s0, s1 = (mesh_shape[0], 1) if len(mesh_shape) == 1 else tuple(mesh_shape)
    two_d = len(mesh_shape) == 2
    d = len(shape)
    n0 = shape[0] // s0
    n1 = shape[1] // s1 if two_d else shape[1]
    z = shape[2] if d > 2 else 1
    plane0 = n1 * z  # voxels in one axis-0 slice of a block
    hx = params.stencil_halo
    b = dtype_bytes

    def rows(width, channels):
        return sent_slices(width, n0, s0) * channels * plane0 * b

    def cols(width, channels, x_extent):
        return sent_slices(width, n1, s1) * channels * x_extent * z * b

    reduces = int(s0 * s1 > 1)  # an all_reduce over one rank is skipped
    lh = min(live_halo, n0, n1) if two_d else min(live_halo, n0)
    live_once = rows(lh, 1) + (cols(lh, 1, n0 + 2 * lh) if two_d else 0)
    live_rounds = _rounds(s0) + (_rounds(s1) if two_d else 0)
    if solver_kind == "schur":
        if two_d:
            raise ValueError("the 1D Schur solver runs on the 1D group; use "
                             "solver_kind='schur2d' on a 2D mesh")
        t = inner_iterations
        per_outer = rows(2, d) + rows(1, d)  # frozen warp rows + interface directions
        return CommBudget(
            bytes_per_iteration=math.ceil(per_outer / t),
            bytes_once_per_solve=live_once,
            ppermute_rounds_per_iteration=2.0 * _rounds(s0) / t,
            reduction_rounds_per_iteration=2.0 * reduces / t,
            rounds_once_per_solve=live_rounds,
            reductions_once_per_solve=reduces,
        )
    if solver_kind == "schur2d":
        if not two_d:
            raise ValueError("schur2d needs a 2D mesh")
        t = inner_iterations
        slow = rows(2, d) + rows(1, d)
        fast = cols(hx, d, n0 + 4)
        return CommBudget(
            bytes_per_iteration=math.ceil(slow / t) + fast,
            bytes_once_per_solve=live_once + cols(hx, 1, n0 + 4),
            ppermute_rounds_per_iteration=2.0 * _rounds(s0) / t + _rounds(s1),
            reduction_rounds_per_iteration=2.0 * reduces / t,
            rounds_once_per_solve=live_rounds + _rounds(s1),
            reductions_once_per_solve=reduces,
        )
    if solver_kind != "sync":
        raise ValueError(f"unknown solver kind {solver_kind!r}")
    k = max(1, params.termination_check_interval)
    warp_rows = rows(hx, d)
    per_iter = warp_rows + rows(hx, 1)
    once = live_once + rows(hx, 1)
    rounds = 2 * _rounds(s0)
    if two_d:
        per_iter += cols(hx, d, n0 + 2 * hx) + cols(hx, 1, n0 + 2 * hx)
        once += cols(hx, 1, n0 + 2 * hx)
        rounds += 2 * _rounds(s1)
    reductions = (1 + params.adaptive_learning_rate) * reduces / k
    return CommBudget(
        bytes_per_iteration=per_iter,
        bytes_once_per_solve=once,
        ppermute_rounds_per_iteration=float(rounds),
        reduction_rounds_per_iteration=reductions,
        bytes_overlappable_per_iteration=warp_rows,
        rounds_once_per_solve=2 * live_rounds,
        reductions_once_per_solve=3 * reduces,
    )


@dataclasses.dataclass(frozen=True)
class ScalingPrediction:
    n_devices: int
    compute_s_per_iteration: float
    comm_s_per_iteration: float
    latency_s_per_iteration: float
    efficiency: float
    assumptions: dict


def predict_efficiency(
    shape,
    mesh_shape,
    params: SolverParams,
    compute_s_per_iteration: float = CONFIG5_512_S_PER_ITER,
    *,
    live_halo: int = 8,
    solver_kind: str = "sync",
    inner_iterations: int = 8,
    fused: bool = True,
    link_bytes_per_s: float = NVLINK_BYTES_PER_S,
    round_latency_s: float = NVLINK_ROUND_S,
    overlap: float = 0.0,
) -> ScalingPrediction:
    """Predicted scaling efficiency of the 1D-group solvers on N GPUs of one
    host: t_compute / (t_compute + t_comm + t_latency) per iteration.

    The busiest rank's sends go out over its NVLink bandwidth, which all its
    neighbours share, so t_comm is the whole send volume over
    ``link_bytes_per_s``; ``overlap`` in [0, 1] credits the part in flight
    while B1 runs (the warp's rows) and nothing else. Each round
    (``batch_isend_irecv``) and reduction costs ``round_latency_s``. The
    compute per rank is constant in N at a fixed block (weak scaling); the
    once-per-solve halos are left out (steady state)."""
    if solver_kind == "schur2d":
        raise ValueError("use predict_efficiency_2d for schur2d")
    b = comm_bytes_per_iteration(shape, mesh_shape, params, live_halo=live_halo,
                                 solver_kind=solver_kind, inner_iterations=inner_iterations,
                                 fused=fused)
    critical = b.bytes_per_iteration - b.bytes_overlappable_per_iteration
    t_comm = (critical + (1.0 - overlap) * b.bytes_overlappable_per_iteration) \
        / link_bytes_per_s
    t_lat = (b.ppermute_rounds_per_iteration + b.reduction_rounds_per_iteration) \
        * round_latency_s
    n = math.prod(mesh_shape)
    return ScalingPrediction(
        n_devices=n,
        compute_s_per_iteration=compute_s_per_iteration,
        comm_s_per_iteration=t_comm,
        latency_s_per_iteration=t_lat,
        efficiency=compute_s_per_iteration / (compute_s_per_iteration + t_comm + t_lat),
        assumptions={
            "link_bytes_per_s": link_bytes_per_s,
            "round_latency_s": round_latency_s,
            "overlap": overlap,
            "bytes_per_iteration_send": b.bytes_per_iteration,
            "ppermute_rounds": b.ppermute_rounds_per_iteration,
        },
    )


def predict_efficiency_2d(
    shape,
    mesh_shape,
    params: SolverParams,
    compute_s_per_iteration: float = CONFIG5_512_S_PER_ITER,
    *,
    solver_kind: str = "sync",
    inner_iterations: int = 8,
    fused: bool = True,
    live_halo: int = 8,
    link0_bytes_per_s: float = IB_BYTES_PER_S,
    round0_latency_s: float = IB_ROUND_S,
    link1_bytes_per_s: float = NVLINK_BYTES_PER_S,
    round1_latency_s: float = NVLINK_ROUND_S,
    overlap: float = 0.0,
) -> ScalingPrediction:
    """Per-axis priced efficiency on a (hosts, GPUs) mesh: mesh axis 0
    crosses hosts (InfiniBand), axis 1 stays inside one (NVLink), the
    regime the Schur-outer x sync-inner solver is for. Each axis's sends go
    over that axis's link, its rounds pay its latency; the reductions span
    both axes and pay the slow one's. ``overlap`` credits the sync solver's
    axis-0 warp rows only."""
    s0, s1 = mesh_shape
    b = comm_bytes_per_iteration(shape, (s0, s1), params, live_halo=live_halo,
                                 solver_kind=solver_kind, inner_iterations=inner_iterations,
                                 fused=fused)
    # Split the volume by axis: the same accounting with one axis switched off.
    only1 = comm_bytes_per_iteration(
        (shape[0] // s0, *shape[1:]), (1, s1), params, live_halo=live_halo,
        solver_kind=solver_kind, inner_iterations=inner_iterations, fused=fused)
    b1 = only1.bytes_per_iteration
    b0 = b.bytes_per_iteration - b1
    rounds1 = only1.ppermute_rounds_per_iteration
    rounds0 = b.ppermute_rounds_per_iteration - rounds1
    ov0 = b.bytes_overlappable_per_iteration
    t_comm = ((b0 - ov0) + (1.0 - overlap) * ov0) / link0_bytes_per_s + b1 / link1_bytes_per_s
    t_lat = (rounds0 + b.reduction_rounds_per_iteration) * round0_latency_s \
        + rounds1 * round1_latency_s
    return ScalingPrediction(
        n_devices=s0 * s1,
        compute_s_per_iteration=compute_s_per_iteration,
        comm_s_per_iteration=t_comm,
        latency_s_per_iteration=t_lat,
        efficiency=compute_s_per_iteration / (compute_s_per_iteration + t_comm + t_lat),
        assumptions={
            "solver_kind": solver_kind,
            "inner_iterations": inner_iterations,
            "link0_bytes_per_s": link0_bytes_per_s,
            "round0_latency_s": round0_latency_s,
            "link1_bytes_per_s": link1_bytes_per_s,
            "round1_latency_s": round1_latency_s,
            "overlap": overlap,
            "slow_axis_rounds_per_iteration": rounds0 + b.reduction_rounds_per_iteration,
            "fast_axis_rounds_per_iteration": rounds1,
        },
    )
