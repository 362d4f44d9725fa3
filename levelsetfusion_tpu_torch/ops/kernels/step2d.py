"""One 2D solver iteration in one call: the resample of the live field at
``v + u(v)``, the energy-term gradients, the optional Sobolev filter, the
update ``u' = u − rate·g`` and the iteration's energies and statistics.

It replaces no TPU kernel: the JAX package's 2D step is plain jnp that XLA
fuses, and B2 (``fused_gradient.py``) takes 3D only. The CUDA kernel,
``csrc/step2d.cu``, does in one launch what the 2D solve loop ran as B1 on
an (X, 1, Z) view and ~95 small PyTorch kernels. ``step2d`` launches it for
CUDA tensors and uses the plain version ``step2d_reference`` only for CPU
tensors: ``resample.warp_field_cm_reference``, then
``ops/gradient.py::energy_gradient`` and the update, as the loop ran them.

Returns ``(new_warp_cm, stats)``: the updated component-major warp
``(2, X, Z)`` and 7 float32 values in ``STATS_FIELDS`` order (B2's with one
per-axis max for each of the two axes), the energies weighted. Both versions
take ``out=`` (the buffer the new warp goes to), ``stats=`` (a buffer for the
stats) and the solve loop's ``active`` flag: where it is false nothing is
computed and both keep what they held (a new stats tensor is NaN in the
plain version).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from levelsetfusion_tpu_torch.ops.gradient import SmoothingMode, energy_gradient
from levelsetfusion_tpu_torch.ops.kernels import _lib
from levelsetfusion_tpu_torch.ops.kernels.resample import warp_field_cm_reference

STATS_FIELDS = (
    "data_energy", "smoothing_energy", "level_set_energy",
    "sum_update", "max_update", "max_abs_u_x", "max_abs_u_z",
)

MAX_TAPS = 15  # kMaxTaps of csrc/step2d.cu
PARTIAL_COLS = 8  # kPartialCols: doubles of a tile's partial row

# Kernel launches (calls that ran the CUDA kernel) since import or the last
# reset; callers set it to 0 to count the launches of one run. A call made
# while its stream is being captured into a CUDA graph launches nothing: it
# adds one to ``captured_count`` instead, and the code that replays the graph
# adds the calls its capture recorded to ``launch_count`` at each replay.
launch_count = 0
captured_count = 0


def step2d_reference(live, canonical, warp_cm, rate, *, w_data=1.0, w_smooth=0.2, w_ls=0.0,
                     killing=False, gamma=0.1, band_union=True, taps=(), out=None,
                     stats=None, active=None):
    """Plain torch version: the golden resample, the term assembly of
    ``energy_gradient`` on the warped field, then the update and its
    statistics."""
    nan = float("nan")
    if active is not None and not bool(active):
        new = out if out is not None else torch.full_like(warp_cm, nan)
        return new, stats if stats is not None else torch.full(
            (len(STATS_FIELDS),), nan, dtype=warp_cm.dtype, device=warp_cm.device)
    warped = warp_field_cm_reference(live, warp_cm)
    kernel = torch.tensor(taps, dtype=warped.dtype, device=warped.device) if taps else None
    res = energy_gradient(
        canonical, warped, warp_cm.movedim(0, -1), w_data, w_smooth, w_ls,
        SmoothingMode.KILLING if killing else SmoothingMode.TIKHONOV, gamma, band_union,
        kernel)
    update = -rate * res.gradient
    new = warp_cm + update.movedim(-1, 0)
    if out is not None:
        new = out.copy_(new)
    length = torch.sqrt(torch.sum(update * update, dim=-1))
    e = res.energies
    got = torch.cat([
        torch.stack([e.data, e.smoothing, e.level_set, torch.sum(length), torch.amax(length)]),
        torch.amax(torch.abs(new), dim=(1, 2)),
    ])
    return new, got if stats is None else stats.copy_(got)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The prototypes of lsf_step2d_tiles and lsf_step2d in csrc/step2d.cu
# (tests/test_torch_step2d.py holds them together).
TILES_ARGTYPES = (_I, _I, _I)  # nx, nz, ntaps
ARGTYPES = (
    _P, _P, _P, _P, _P, _P,  # live, canonical, warp_cm, rate, new_warp, stats
    _P, _P,  # the fold's scratch: partial, ticket
    _P,  # active flag (null: always on)
    _I, _I,  # nx, nz
    _F, _F, _F, _I,  # w_data, w_smooth, w_ls, killing
    _F, _F, _I,  # -(1 + gamma), gamma, band_union
    ctypes.POINTER(ctypes.c_float), _I,  # taps (host), ntaps
    _P,  # stream
)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _lib.load("step2d")
    lib.lsf_step2d_tiles.argtypes = list(TILES_ARGTYPES)
    lib.lsf_step2d_tiles.restype = _I
    lib.lsf_step2d.argtypes = list(ARGTYPES)
    lib.lsf_step2d.restype = _I
    lib.lsf_step2d_error_string.argtypes = [_I]
    lib.lsf_step2d_error_string.restype = ctypes.c_char_p
    return lib


def partial_len(shape, ntaps: int, device) -> int:
    """Doubles of the partial rows that a call on an ``(X, Z)`` grid with
    ``ntaps`` taps folds on ``device``: 0 on the CPU, and where the grid is
    one tile. The tiles are the kernel's (``lsf_step2d_tiles``)."""
    if torch.device(device).type != "cuda":
        return 0
    tiles = _library().lsf_step2d_tiles(*shape, ntaps)
    if tiles <= 0:
        raise ValueError(f"step2d: no grid for {tuple(shape)} with {ntaps} taps")
    return 0 if tiles == 1 else tiles * PARTIAL_COLS


def step2d(live, canonical, warp_cm, rate, *, w_data=1.0, w_smooth=0.2, w_ls=0.0,
           killing=False, gamma=0.1, band_union=True, taps=(), out=None, stats=None,
           active=None, ticket=None, partial=None):
    """One 2D solver iteration from warp ``warp_cm``.

    Args:
      live: the live field ``(X, Z)``, resampled at ``v + u(v)``.
      canonical: the canonical field, same shape.
      warp_cm: component-major warp ``(2, X, Z)``.
      rate: learning rate, a 0-d tensor on the same device (read by the
        kernel from device memory).
      taps: Sobolev kernel taps (odd count); empty = no filter.
      out: optional ``(2, X, Z)`` buffer for the new warp, not ``warp_cm``'s;
        else a new tensor.
      stats: optional buffer of 7 for the stats; else a new tensor.
      active: None, or a 0-d bool tensor on the same device; the kernel reads
        it and returns at once where it is false.
      ticket: None, or a zeroed 1-element int32 tensor on the same device
        that no call running at the same time uses: the completion counter
        of the fold of the tiles' partial rows, which the kernel leaves at
        0. The solve loop brings its own, since its graph replays on any
        stream.
      partial: None, or a float64 buffer of at least ``partial_len`` values
        on the same device for the tiles' partial rows, not used by a call
        running at the same time.

    All tensors float32 (``partial`` float64), contiguous, one device. CUDA
    tensors run the kernel, CPU tensors the plain version. A call allocates
    only what it is not given: the outputs, and a grid of more than one tile
    its ticket and partial rows.
    """
    global launch_count, captured_count
    if live.ndim != 2 or tuple(canonical.shape) != tuple(live.shape) \
            or tuple(warp_cm.shape) != (2, *live.shape):
        raise ValueError(
            f"want live and canonical (X, Z) and warp_cm (2, X, Z), got {tuple(live.shape)}, "
            f"{tuple(canonical.shape)} and {tuple(warp_cm.shape)}")
    if not isinstance(rate, torch.Tensor) or rate.ndim != 0:
        raise TypeError("rate must be a 0-d tensor")
    if taps and (len(taps) % 2 == 0 or len(taps) > MAX_TAPS):
        raise ValueError(f"taps must be an odd count <= {MAX_TAPS}, got {len(taps)}")
    device = live.device
    for name, t in (("live", live), ("canonical", canonical), ("warp_cm", warp_cm),
                    ("rate", rate)):
        _lib.require_f32_contiguous(name, t, device)
    if out is not None:
        _lib.require_f32_contiguous("out", out, device)
        if out.shape != warp_cm.shape or out.data_ptr() == warp_cm.data_ptr():
            raise ValueError(f"out must be a {tuple(warp_cm.shape)} buffer apart from warp_cm")
    if stats is not None:
        _lib.require_f32_contiguous("stats", stats, device)
        if tuple(stats.shape) != (len(STATS_FIELDS),):
            raise ValueError(f"stats must hold {len(STATS_FIELDS)} values, got "
                             f"{tuple(stats.shape)}")
    _lib.require_flag(active, device)
    if ticket is not None and (ticket.dtype != torch.int32 or ticket.numel() != 1
                               or ticket.device != device):
        raise ValueError(f"ticket must be one int32 on {device}, got {ticket.dtype} "
                         f"{tuple(ticket.shape)} on {ticket.device}")
    if partial is not None and (partial.dtype != torch.float64 or partial.device != device
                                or not partial.is_contiguous()):
        raise ValueError(f"partial must be contiguous float64 on {device}, got "
                         f"{partial.dtype} on {partial.device}")
    kw = dict(w_data=w_data, w_smooth=w_smooth, w_ls=w_ls, killing=killing, gamma=gamma,
              band_union=band_union, taps=taps, out=out, stats=stats, active=active)
    if device.type == "cpu":
        return step2d_reference(live, canonical, warp_cm, rate, **kw)
    if device.type != "cuda":
        raise ValueError(f"no 2D step kernel for device {device}")

    lib = _library()
    nx, nz = live.shape
    new = out if out is not None else torch.empty_like(warp_cm)
    if stats is None:
        stats = torch.empty(len(STATS_FIELDS), dtype=torch.float32, device=device)
    taps_arr = (ctypes.c_float * max(len(taps), 1))(*np.asarray(taps, np.float32))
    with torch.cuda.device(device):
        rows = partial_len((nx, nz), len(taps), device)
        if rows:
            if partial is None:
                partial = torch.empty(rows, dtype=torch.float64, device=device)
            elif partial.numel() < rows:
                raise ValueError(f"partial holds {partial.numel()} values, the call folds {rows}")
            if ticket is None:
                ticket = torch.zeros(1, dtype=torch.int32, device=device)
        err = lib.lsf_step2d(
            live.data_ptr(), canonical.data_ptr(), warp_cm.data_ptr(), rate.data_ptr(),
            new.data_ptr(), stats.data_ptr(), partial.data_ptr() if rows else None,
            None if ticket is None else ticket.data_ptr(), _lib.flag_ptr(active),
            nx, nz, w_data, w_smooth, w_ls, int(bool(killing)), -(1.0 + gamma), gamma,
            int(bool(band_union)), taps_arr, len(taps), _lib.stream_handle(device),
        )
    _lib.check(err, lib.lsf_step2d_error_string, "step2d launch")
    if _lib.capturing():
        captured_count += 1
    else:
        launch_count += 1
    return new, stats
