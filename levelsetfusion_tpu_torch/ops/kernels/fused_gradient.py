"""The stencil half of a solver iteration: energy-term gradients, optional
Sobolev filter, warp update, energies and update statistics, in one call.

Port of the TPU kernel ``levelsetfusion_tpu/ops/pallas/fused_gradient.py::
fused_gradient_update``, with its x and y windows (``x_offset``,
``x_global``, ``x_lo``, ``x_len`` and their y twins: the sharded solvers'
haloed blocks) and ``conv_local_x`` (the Schur solvers' block-local Sobolev
x pass). The CUDA version, ``csrc/fused_gradient.cu``,
is two kernels: the terms (to g) over tiles of x planes, then the Sobolev
filter, the update and the statistics, whose last block folds every block's
partial sums into the stats. ``fused_gradient_update`` launches them for
CUDA tensors and uses the plain version ``fused_gradient_update_reference``
only for CPU tensors.

Returns ``(new_warp_cm, stats)``: the updated component-major warp
``(3, x_len, y_len, Z)`` and a float32 tensor of 8 values in ``STATS_FIELDS`` order
(the order of the TPU module's ``FusedStats``). Energies are weighted, as the
solver's telemetry records them. For the solve loop of
``models/single_level.py`` both versions take ``out=`` (the buffer the new
warp goes to) and an ``active`` flag: where it is false nothing is computed,
``out`` keeps what it held and the stats are unwritten (NaN in the plain
version).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from levelsetfusion_tpu_torch.ops import derivatives, sobolev, terms
from levelsetfusion_tpu_torch.ops.kernels import _lib

STATS_FIELDS = (
    "data_energy", "smoothing_energy", "level_set_energy",
    "sum_update", "max_update",
    "max_abs_u_x", "max_abs_u_y", "max_abs_u_z",
)

MAX_TAPS = 15  # kMaxTaps of csrc/fused_gradient.cu

# Kernel launches (calls that ran the CUDA kernels) since import or the last
# reset; callers set it to 0 to count the launches of one run. A call made
# while its stream is being captured into a CUDA graph launches nothing: it
# adds one to ``captured_count`` instead, and the code that replays the graph
# adds the calls its capture recorded to ``launch_count`` at each replay.
launch_count = 0
captured_count = 0


def to_component_major(warp: torch.Tensor) -> torch.Tensor:
    """``(*spatial, D)`` -> contiguous ``(D, *spatial)``."""
    return warp.movedim(-1, 0).contiguous()


def from_component_major(warp_cm: torch.Tensor) -> torch.Tensor:
    """``(D, *spatial)`` -> ``(*spatial, D)`` (a view)."""
    return warp_cm.movedim(0, -1)


def sobolev_taps(size: int, strength: float) -> tuple:
    """Sobolev kernel taps as a tuple of floats (the f32 kernel's values)."""
    return tuple(
        float(v) for v in sobolev.generate_1d_sobolev_kernel(size, strength)
    )


class AxisWindow(NamedTuple):
    """B2's window along one axis of an input of n slices: input slice q is
    global slice ``offset + q`` of ``extent``; the call updates input slices
    ``[lo, lo + length)``. ``q_lo``/``q_hi``: the input slices inside the
    volume."""

    offset: int
    extent: int
    lo: int
    length: int
    q_lo: int
    q_hi: int


class Window(NamedTuple):
    """B2's x and y windows (``y`` spans axis 1 whole for a 2D field)."""

    x: AxisWindow
    y: AxisWindow


def _axis_window(name, n, h, offset, extent, lo, length) -> AxisWindow:
    extent = n if extent is None else int(extent)
    length = n - lo if length is None else int(length)
    offset, lo = int(offset), int(lo)
    q_lo, q_hi = max(0, -offset), min(n, extent - offset)
    hi = lo + length
    if not (extent >= 1 and length >= 1 and 0 <= lo and hi <= n and lo + offset >= 0
            and hi + offset <= extent and max(lo - h, -offset) >= 0
            and min(hi + h, extent - offset) <= n):
        raise ValueError(
            f"bad {name} window: {name}_offset={offset} {name}_global={extent} "
            f"{name}_lo={lo} {name}_len={length} on {n} input slices (halo {h} needed "
            "inside the volume)"
        )
    return AxisWindow(offset, extent, lo, length, q_lo, q_hi)


def window(shape, ntaps=0, x_offset=0, x_global=None, x_lo=0, x_len=None, y_offset=0,
           y_global=None, y_lo=0, y_len=None, conv_local_x=False) -> Window:
    """The checked windows of a call on an input of ``shape`` (the defaults:
    the whole volume). Each window must lie inside the input and the volume,
    and the input must hold every slice inside the volume within ``h`` of
    it: ``2 + R`` (R = ntaps // 2; the solvers' ``stencil_halo``), and along
    x only 2 under ``conv_local_x``, whose x pass reads nothing beyond the
    window. The kernels' contract, which ``csrc/fused_gradient.cu::args_ok``
    checks too. A 2D field takes no y window."""
    h = 2 + ntaps // 2
    x = _axis_window("x", shape[0], 2 if conv_local_x else h, x_offset, x_global, x_lo,
                     x_len)
    if len(shape) == 2:
        if (y_offset, y_global, y_lo, y_len) != (0, None, 0, None):
            raise ValueError("a 2D field takes no y window")
        return Window(x, AxisWindow(0, shape[1], 0, shape[1], 0, shape[1]))
    return Window(x, _axis_window("y", shape[1], h, y_offset, y_global, y_lo, y_len))


def _window_energies(warped, canonical, wg, jac, *, w_data, w_smooth, w_ls, killing,
                     gamma, band_union):
    """The weighted energies of ``ops/terms.py`` summed over the given rows:
    every argument is already sliced to them, ``wg`` (the warped field's
    gradient) and ``jac`` (the warp's Jacobian, None without smoothing)
    computed on the whole block, so that the rows' derivatives are the
    volume's."""
    zero = torch.zeros((), dtype=warped.dtype, device=warped.device)
    e_data = w_data * terms.data_energy(warped, canonical, band_union)
    e_smooth = e_ls = zero
    if w_smooth:
        e_smooth = w_smooth * (terms.killing_energy(jac, gamma) if killing
                               else terms.tikhonov_energy(jac))
    if w_ls:
        e_ls = w_ls * terms.level_set_energy(warped, wg, canonical, band_union)
    return e_data, e_smooth, e_ls


def fused_gradient_update_reference(
    warped, canonical, warp_cm, rate, *, w_data=1.0, w_smooth=0.2, w_ls=0.0,
    killing=False, gamma=0.1, band_union=True, taps=(), out=None, active=None,
    x_offset=0, x_global=None, x_lo=0, x_len=None, y_offset=0, y_global=None, y_lo=0,
    y_len=None, conv_local_x=False,
):
    """Plain torch version: the golden term assembly of ``ops/terms.py`` and
    ``ops/sobolev.py`` on an already-warped field, then the update; 2D or 3D
    (``warp_cm`` ``(D, *spatial)``; the stats hold D per-axis maxes).

    With windows, the assembly runs on the input slices inside the volume
    (``AxisWindow.q_lo``/``q_hi`` of each axis): where they end at a global
    edge the golden edge rules and the filter's zero padding are the
    volume's, and where they end at a block's halo the slices that the edge
    rules spoil (2 of them, and R more for the filter) lie in the halo,
    outside the window. Under ``conv_local_x`` the filter's x pass reads g
    as zero outside the window's rows. The update, the energies and the
    statistics are then the window's."""
    win = window(warped.shape, len(taps), x_offset, x_global, x_lo, x_len, y_offset,
                 y_global, y_lo, y_len, conv_local_x)
    d = warped.ndim
    out_shape = (d, win.x.length, *((win.y.length,) if d == 3 else ()), *warped.shape[d - 1:])
    if active is not None and not bool(active):
        new = out if out is not None else torch.full(
            out_shape, float("nan"), dtype=warp_cm.dtype, device=warp_cm.device)
        return new, torch.full((5 + d,), float("nan"), dtype=warp_cm.dtype,
                               device=warp_cm.device)
    axes = (win.x, win.y)[:d - 1]
    sub = tuple(slice(a.q_lo, a.q_hi) for a in axes)
    part = tuple(slice(a.lo - a.q_lo, a.lo - a.q_lo + a.length) for a in axes)
    warped, canonical = warped[sub], canonical[sub]
    warp = from_component_major(warp_cm[(slice(None), *sub)])
    wg = derivatives.gradient(warped)
    g_data, _ = terms.data_term(warped, canonical, wg, band_union_only=band_union)
    total = w_data * g_data
    if w_smooth:
        g_s, _ = terms.killing_term(warp, gamma) if killing else terms.tikhonov_term(warp)
        total = total + w_smooth * g_s
    if w_ls:
        g_ls, _ = terms.level_set_term(warped, wg, canonical, band_union_only=band_union)
        total = total + w_ls * g_ls
    if taps:
        if conv_local_x:
            rows = torch.zeros(total.shape[0], dtype=torch.bool, device=total.device)
            rows[part[0]] = True
            total = torch.where(rows.view(-1, *(1,) * (d)), total, 0.0)
        kernel = torch.tensor(taps, dtype=warped.dtype, device=warped.device)
        total = sobolev.convolve_with_sobolev_kernel(total, kernel, num_spatial_dims=d)
    jac = derivatives.vector_jacobian(warp)[part] if w_smooth else None
    energies = _window_energies(
        warped[part], canonical[part], wg[part], jac, w_data=w_data, w_smooth=w_smooth,
        w_ls=w_ls, killing=killing, gamma=gamma, band_union=band_union)
    upd = -rate * total[part]
    new_warp = warp[part] + upd
    ul = torch.sqrt(torch.sum(upd * upd, dim=-1))
    stats = torch.stack([
        *energies, torch.sum(ul), torch.max(ul),
        *torch.amax(torch.abs(new_warp), dim=tuple(range(d))),
    ])
    new_cm = to_component_major(new_warp)
    return (new_cm if out is None else out.copy_(new_cm)), stats


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The prototypes of lsf_fused_partials_len and lsf_fused_gradient_update in
# csrc/fused_gradient.cu, in order (tests/test_torch_fused_gradient.py holds
# them together).
# nx, ny, nz, ntaps, x_offset, x_global, x_lo, x_len, y_offset, y_global, y_lo,
# y_len, conv_local_x
PARTIALS_ARGTYPES = (_I,) * 13
UPDATE_ARGTYPES = (
    _P, _P, _P, _P, _P, _P,  # warped, canonical, warp_cm, rate, new_warp, stats
    _P, _P, _P,  # scratch: g, partial, ticket
    _P,  # active flag (null: always on)
    _I, _I, _I,  # nx, ny, nz
    _I, _I, _I, _I,  # x_offset, x_global, x_lo, x_len
    _I, _I, _I, _I, _I,  # y_offset, y_global, y_lo, y_len, conv_local_x
    _F, _F, _F, _I, _F, _I,  # w_data, w_smooth, w_ls, killing, gamma, band_union
    ctypes.POINTER(ctypes.c_float), _I,  # taps (host), ntaps
    _P,  # stream
)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _lib.load("fused_gradient")
    lib.lsf_fused_partials_len.argtypes = list(PARTIALS_ARGTYPES)
    lib.lsf_fused_partials_len.restype = ctypes.c_int64
    lib.lsf_fused_gradient_update.argtypes = list(UPDATE_ARGTYPES)
    lib.lsf_fused_gradient_update.restype = _I
    lib.lsf_fused_error_string.argtypes = [_I]
    lib.lsf_fused_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _ticket(device: torch.device, shape: tuple, stream: int) -> torch.Tensor:
    """The completion counter of the kernels' last-block fold for calls
    that bring none: zeroed once here, reset to 0 by the kernels at the end
    of every call. One per stream (``stream`` is its raw handle): calls on
    one stream run in order, so none of them finds the counter mid-count,
    while two calls on two streams may run at once and would mix their
    counts on a shared one. A CUDA graph runs on whatever stream replays
    it, so code that captures B2 passes a ticket of its own (``ticket=``)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def fused_gradient_update(
    warped, canonical, warp_cm, rate, *, w_data=1.0, w_smooth=0.2, w_ls=0.0,
    killing=False, gamma=0.1, band_union=True, taps=(), out=None, active=None,
    ticket=None, x_offset=0, x_global=None, x_lo=0, x_len=None, y_offset=0, y_global=None,
    y_lo=0, y_len=None, conv_local_x=False,
):
    """One solver step after the resample, over the whole volume or a window
    of it.

    Args:
      warped: warped live field ``(X, Y, Z)`` (a block with its halo rows).
      canonical: canonical field, same shape.
      warp_cm: component-major warp ``(3, X, Y, Z)``.
      rate: learning rate, a 0-d tensor on the same device (read by the
        kernel from device memory, so an adaptive rate never syncs).
      taps: Sobolev kernel taps (odd count); empty = no filter.
      out: optional ``(3, x_len, y_len, Z)`` buffer for the new warp, not
        ``warp_cm``'s (the solve loop ping-pongs two); else a new tensor.
      active: None, or a 0-d bool tensor on the same device; the kernels
        read it and return at once where it is false.
      ticket: None (the stream's own, ``_ticket``), or a zeroed 1-element
        int32 tensor on the same device that no call running at the same
        time uses: the completion counter of the kernels' fold. The solve
        loop brings its own, since its graph replays on any stream. The
        plain version has no fold and ignores it.
      x_offset, x_global, x_lo, x_len: the x window (host ints, ``window``):
        input row q is global row ``x_offset + q`` of ``x_global`` (default
        X), and the new warp, the energies and the statistics cover input
        rows ``[x_lo, x_lo + x_len)`` (default all). The face rules fire at
        global rows 0 and ``x_global - 1`` only, and input rows beyond them
        are never read.
      y_offset, y_global, y_lo, y_len: the y window, the same along axis 1
        (columns): the new warp is ``(3, x_len, y_len, Z)``, the y face rules
        fire at global columns 0 and ``y_global - 1`` only, and the filter's
        y pass zero-pads beyond them.
      conv_local_x: the filter's x pass reads g as zero outside the window's
        rows (the Schur solvers' block-local filter), so the input needs only
        2 halo rows inside the volume.

    All tensors float32, contiguous, one device. CUDA tensors run the
    kernels, CPU tensors the plain version. The scratch (``g``, the
    partial rows, the stats) is allocated per call; inside a CUDA graph
    capture it comes from the graph's pool, where the next call of the
    capture reuses it.
    """
    global launch_count, captured_count
    if warped.ndim != 3 or tuple(warp_cm.shape) != (3, *warped.shape):
        raise ValueError(
            f"want warped (X, Y, Z) and warp_cm (3, X, Y, Z), got "
            f"{tuple(warped.shape)} and {tuple(warp_cm.shape)}"
        )
    if tuple(canonical.shape) != tuple(warped.shape):
        raise ValueError(f"canonical {tuple(canonical.shape)} != warped {tuple(warped.shape)}")
    if not isinstance(rate, torch.Tensor) or rate.ndim != 0:
        raise TypeError("rate must be a 0-d tensor")
    if taps and (len(taps) % 2 == 0 or len(taps) > MAX_TAPS):
        raise ValueError(f"taps must be an odd count <= {MAX_TAPS}, got {len(taps)}")
    win = window(warped.shape, len(taps), x_offset, x_global, x_lo, x_len, y_offset,
                 y_global, y_lo, y_len, conv_local_x)
    out_shape = (3, win.x.length, win.y.length, warped.shape[2])
    device = warped.device
    for name, t in (("warped", warped), ("canonical", canonical),
                    ("warp_cm", warp_cm), ("rate", rate)):
        _lib.require_f32_contiguous(name, t, device)
    if out is not None:
        _lib.require_f32_contiguous("out", out, device)
        if tuple(out.shape) != out_shape or out.data_ptr() == warp_cm.data_ptr():
            raise ValueError(f"out must be a {out_shape} buffer apart from warp_cm")
    _lib.require_flag(active, device)
    if ticket is not None and (ticket.dtype != torch.int32 or ticket.numel() != 1
                               or ticket.device != device):
        raise ValueError(f"ticket must be one int32 on {device}, got {ticket.dtype} "
                         f"{tuple(ticket.shape)} on {ticket.device}")
    kw = dict(w_data=w_data, w_smooth=w_smooth, w_ls=w_ls, killing=killing,
              gamma=gamma, band_union=band_union, taps=taps, out=out, active=active,
              x_offset=win.x.offset, x_global=win.x.extent, x_lo=win.x.lo, x_len=win.x.length,
              y_offset=win.y.offset, y_global=win.y.extent, y_lo=win.y.lo, y_len=win.y.length,
              conv_local_x=conv_local_x)
    if device.type == "cpu":
        return fused_gradient_update_reference(warped, canonical, warp_cm, rate, **kw)
    if device.type != "cuda":
        raise ValueError(f"no fused gradient kernel for device {device}")

    lib = _library()
    nx, ny, nz = warped.shape
    new_warp = out if out is not None else torch.empty(out_shape, dtype=torch.float32,
                                                       device=device)
    stats = torch.empty(8, dtype=torch.float32, device=device)
    g = torch.empty((3, nx, ny, nz), dtype=torch.float32, device=device)
    xw = (*win.x[:4], *win.y[:4], int(bool(conv_local_x)))
    stream = _lib.stream_handle(device)
    if ticket is None:
        ticket = _ticket(device, (nx, ny, nz), stream)
    taps_arr = (ctypes.c_float * max(len(taps), 1))(*np.asarray(taps, np.float32))
    with torch.cuda.device(device):
        rows = lib.lsf_fused_partials_len(nx, ny, nz, len(taps), *xw)
        if rows <= 0:
            raise RuntimeError(f"fused_gradient_update: no grid for {(nx, ny, nz)}")
        partial = torch.empty(rows, dtype=torch.float64, device=device)
        err = lib.lsf_fused_gradient_update(
            warped.data_ptr(), canonical.data_ptr(), warp_cm.data_ptr(),
            rate.data_ptr(), new_warp.data_ptr(), stats.data_ptr(),
            g.data_ptr(), partial.data_ptr(), ticket.data_ptr(), _lib.flag_ptr(active),
            nx, ny, nz, *xw,
            w_data, w_smooth, w_ls, int(bool(killing)), gamma, int(bool(band_union)),
            taps_arr, len(taps), stream,
        )
    _lib.check(err, lib.lsf_fused_error_string, "fused_gradient_update launch")
    if _lib.capturing():
        captured_count += 1
    else:
        launch_count += 1
    return new_warp, stats
