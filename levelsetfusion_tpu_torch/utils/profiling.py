"""Tracing and profiling hooks. Twin of ``levelsetfusion_tpu/utils/profiling.py``.

- ``sync``: ``torch.cuda.synchronize`` (JAX's fetched a scalar, since
  ``block_until_ready`` did nothing on its remote TPU).
- ``trace``: a ``torch.profiler`` trace (CUDA activity where CUDA is up)
  written as a Chrome trace into a directory (the CLI's ``--profile``).
- ``span`` and ``count``: the program's own spans and counters, recorded
  only while a ``torch.profiler`` runs (``trace``, or any other profiler of
  the process). A span is a profiler range (``RecordFunctionFast``: a
  host event on the profiler's own clock, beside the device events it
  launched, kept in memory until the profiler stops, with no device-side
  copy of itself); it also adds its call and its host seconds to
  ``spans()``. With no profiler running a span is one
  ``_profiler_enabled()`` check and a shared no-op context, and a count
  adds nothing. ``counters()`` and ``spans()`` give what was recorded;
  ``trace`` clears both on entry. Spans sit at request, chunk and exchange
  boundaries, never inside a solver iteration or a captured chunk; their
  names start with ``lsf.``. The CLI's ``--profile`` writes both.
- ``graph_kernel_nodes``: the kernel nodes of a captured CUDA graph, read
  through ``libcuda.so.1`` (the solve loop counts its chunk's once, at
  capture).
- ``solver_roofline``: one solver iteration's time against the least time
  the card could take for its bytes, priced for the H100 (NVIDIA H100
  80GB HBM3 at a 700 W power limit: 3.35 TB/s).

The program's spans:

- ``lsf.tsdf``: one TSDF generation, 2D or 3D;
- ``lsf.pyramid``: one pyramid of a hierarchical solve,
  ``models/hierarchical.py::build_pyramid_from_depth`` (holding its
  levels' ``lsf.tsdf`` spans) or ``ops/pyramid.py::build_pyramid``;
  ``lsf.prolongate``: one hand-off between levels,
  ``hierarchical.py::_solve_over_pyramids``' ``prolongate_warp``;
- ``lsf.solve``: one solve; inside it ``lsf.solve.capture`` (the CUDA
  graph's warm-up, capture and instantiation), ``lsf.solve.flag_read`` (a
  host read of the done flag) and ``lsf.solve.result_read``;
- ``lsf.solve.build``: ``single_level.loop_for``'s look-up of a solve's
  loop, one a solve (where it misses: the release of loops of other
  params and the new loop's state buffers); ``lsf.solve.release``:
  ``release_kept_loops``;
- ``lsf.frame.next``: waiting for a frame; ``lsf.frame.blend``: a frame's
  resample, blend and stats pack; ``lsf.frame.report_read``: its stats read;
- ``lsf.io.prefetch_wait``: blocked on the native decode queue;
- ``lsf.halo.exchange``, ``lsf.halo.wait``, ``lsf.reduce``: the sharded
  solvers' halo exchanges, their waits and ``all_reduce`` calls.

Its counters:

- ``halo.bytes_sent``: the bytes the halo exchanges handed to ``isend``;
- ``solve.loop_kept`` and ``solve.loop_built``: the ``loop_for`` look-ups
  that reused a kept solve loop and those that built one;
- on CUDA ``solve.graph_kernels`` and ``solve.graph_iterations``: the
  kernels and the iterations of the captured chunks replayed (the kernels:
  an iteration's step, B1 and B2's two in 3D or the 2D step, and its loop
  tail, ``ops/kernels/loop_tail.py``), and ``solve.step2d_iterations``: the
  2D step's launches among them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch

H100_HBM_BYTES_PER_S = 3.35e12
F32 = 4


def sync(device=None) -> None:
    """Wait for the card's queued work (``torch.cuda.synchronize``)."""
    torch.cuda.synchronize(device)


_NO_SPAN = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}
_SPANS: Dict[str, List[float]] = {}  # name -> [calls, host seconds]


class _Span:
    """A profiler range ``name`` that adds its call and host time to
    ``spans()``."""

    __slots__ = ("_name", "_range", "_t0")

    def __init__(self, name: str):
        self._name = name
        self._range = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        total = _SPANS.setdefault(self._name, [0, 0.0])
        total[0] += 1
        total[1] += seconds


def span(name: str):
    """A profiler range ``name`` while a profiler runs, else a shared no-op
    context."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler runs."""
    if torch._C._autograd._profiler_enabled():
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """The counts made while a profiler ran (since ``trace`` last began)."""
    return dict(_COUNTS)


def spans() -> Dict[str, Dict[str, float]]:
    """Each span name's ``calls`` and ``host_s`` while a profiler ran (since
    ``trace`` last began)."""
    return {name: {"calls": int(c), "host_s": s} for name, (c, s) in _SPANS.items()}


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the scope, CPU and (where CUDA is up) CUDA
    activity; on exit the Chrome trace is written to
    ``<log_dir>/trace.json``. The program's counters and span totals start
    from zero."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _COUNTS.clear()
    _SPANS.clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# CUgraphNodeType's kernel node (the runtime's cudaGraphNodeTypeKernel).
CU_GRAPH_NODE_TYPE_KERNEL = 0


def graph_kernel_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The kernel nodes of ``graph``, captured with ``keep_graph=True`` and
    not yet instantiated or reset: ``cuGraphGetNodes`` and
    ``cuGraphNodeGetType`` of ``libcuda.so.1`` on its ``raw_cuda_graph()``,
    which is a ``CUgraph``. Memory copies, memsets and event nodes are not
    counted."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    ptr, size = ctypes.c_void_p, ctypes.c_size_t
    cu.cuGraphGetNodes.argtypes = [ptr, ctypes.POINTER(ptr), ctypes.POINTER(size)]
    cu.cuGraphNodeGetType.argtypes = [ptr, ctypes.POINTER(ctypes.c_int)]

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    raw, n = ptr(graph.raw_cuda_graph()), size(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ptr * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes[:n.value]:
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        kernels += kind.value == CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def solver_roofline(shape, seconds_per_iter: float, dim: int = 3) -> Dict[str, float]:
    """One solver iteration at ``shape`` against the card's memory roofline:
    the bytes it must move, as the kernel table's bound column counts them
    (each input read once, each output written once, f32), over 3.35 TB/s.
    B1 reads the live field and the D-component warp and writes the warped
    field; B2 reads the warped field, the canonical and the warp and writes
    the new warp (its few statistics aside): at 128³ 12.5 µs + 20.0 µs.
    ``dim`` is kept for JAX's signature; the shape gives it."""
    voxels = 1
    for s in shape:
        voxels *= s
    d = len(shape)
    resample_bytes = (1 + d + 1) * voxels * F32
    fused_bytes = (1 + 1 + d + d) * voxels * F32
    mem_bound_s = (resample_bytes + fused_bytes) / H100_HBM_BYTES_PER_S
    return {
        "voxels": float(voxels),
        "seconds_per_iter": seconds_per_iter,
        "voxel_updates_per_s": voxels / seconds_per_iter,
        "memory_bound_seconds": mem_bound_s,
        "fraction_of_memory_roofline": mem_bound_s / seconds_per_iter,
    }
