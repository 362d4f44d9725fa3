"""The stencil half of a solver iteration: energy-term gradients, optional
Sobolev filter, warp update, energies and update statistics, in one call.

Port of the TPU kernel ``levelsetfusion_tpu/ops/pallas/fused_gradient.py::
fused_gradient_update`` (whole volume; the sharded window arguments come
with the distributed solvers). The CUDA version, ``csrc/fused_gradient.cu``,
is two kernels: the terms (to g) over tiles of x planes, then the Sobolev
filter, the update and the statistics, whose last block folds every block's
partial sums into the stats. ``fused_gradient_update`` launches them for
CUDA tensors and uses the plain version ``fused_gradient_update_reference``
only for CPU tensors.

Returns ``(new_warp_cm, stats)``: the updated component-major warp
``(3, X, Y, Z)`` and a float32 tensor of 8 values in ``STATS_FIELDS`` order
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


def fused_gradient_update_reference(
    warped, canonical, warp_cm, rate, *, w_data=1.0, w_smooth=0.2, w_ls=0.0,
    killing=False, gamma=0.1, band_union=True, taps=(), out=None, active=None,
):
    """Plain torch version: the golden term assembly of ``ops/terms.py`` and
    ``ops/sobolev.py`` on an already-warped field, then the update."""
    if active is not None and not bool(active):
        new = out if out is not None else torch.full_like(warp_cm, float("nan"))
        return new, torch.full((8,), float("nan"), dtype=warp_cm.dtype, device=warp_cm.device)
    warp = from_component_major(warp_cm)
    wg = derivatives.gradient(warped)
    g_data, e_data = terms.data_term(warped, canonical, wg, band_union_only=band_union)
    total = w_data * g_data
    e_data = w_data * e_data
    e_smooth = torch.zeros((), dtype=warped.dtype, device=warped.device)
    if w_smooth:
        if killing:
            g_s, e_smooth = terms.killing_term(warp, gamma)
        else:
            g_s, e_smooth = terms.tikhonov_term(warp)
        total = total + w_smooth * g_s
        e_smooth = w_smooth * e_smooth
    e_ls = torch.zeros((), dtype=warped.dtype, device=warped.device)
    if w_ls:
        g_ls, e_ls = terms.level_set_term(
            warped, wg, canonical, band_union_only=band_union
        )
        total = total + w_ls * g_ls
        e_ls = w_ls * e_ls
    if taps:
        kernel = torch.tensor(taps, dtype=warped.dtype, device=warped.device)
        total = sobolev.convolve_with_sobolev_kernel(total, kernel, num_spatial_dims=3)
    upd = -rate * total
    new_warp = warp + upd
    ul = torch.sqrt(torch.sum(upd * upd, dim=-1))
    stats = torch.stack([
        e_data, e_smooth, e_ls, torch.sum(ul), torch.max(ul),
        *torch.amax(torch.abs(new_warp), dim=(0, 1, 2)),
    ])
    new_cm = to_component_major(new_warp)
    return (new_cm if out is None else out.copy_(new_cm)), stats


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The prototypes of lsf_fused_partials_len and lsf_fused_gradient_update in
# csrc/fused_gradient.cu, in order (tests/test_torch_fused_gradient.py holds
# them together).
PARTIALS_ARGTYPES = (_I, _I, _I, _I)  # nx, ny, nz, ntaps
UPDATE_ARGTYPES = (
    _P, _P, _P, _P, _P, _P,  # warped, canonical, warp_cm, rate, new_warp, stats
    _P, _P, _P,  # scratch: g, partial, ticket
    _P,  # active flag (null: always on)
    _I, _I, _I,  # nx, ny, nz
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
    ticket=None,
):
    """One solver step after the resample, over the whole volume.

    Args:
      warped: warped live field ``(X, Y, Z)``.
      canonical: canonical field, same shape.
      warp_cm: component-major warp ``(3, X, Y, Z)``.
      rate: learning rate, a 0-d tensor on the same device (read by the
        kernel from device memory, so an adaptive rate never syncs).
      taps: Sobolev kernel taps (odd count); empty = no filter.
      out: optional ``(3, X, Y, Z)`` buffer for the new warp, not
        ``warp_cm``'s (the solve loop ping-pongs two); else a new tensor.
      active: None, or a 0-d bool tensor on the same device; the kernels
        read it and return at once where it is false.
      ticket: None (the stream's own, ``_ticket``), or a zeroed 1-element
        int32 tensor on the same device that no call running at the same
        time uses: the completion counter of the kernels' fold. The solve
        loop brings its own, since its graph replays on any stream. The
        plain version has no fold and ignores it.

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
    device = warped.device
    for name, t in (("warped", warped), ("canonical", canonical),
                    ("warp_cm", warp_cm), ("rate", rate)):
        _lib.require_f32_contiguous(name, t, device)
    if out is not None:
        _lib.require_f32_contiguous("out", out, device)
        if out.shape != warp_cm.shape or out.data_ptr() == warp_cm.data_ptr():
            raise ValueError("out must be a (3, X, Y, Z) buffer apart from warp_cm")
    _lib.require_flag(active, device)
    if ticket is not None and (ticket.dtype != torch.int32 or ticket.numel() != 1
                               or ticket.device != device):
        raise ValueError(f"ticket must be one int32 on {device}, got {ticket.dtype} "
                         f"{tuple(ticket.shape)} on {ticket.device}")
    kw = dict(w_data=w_data, w_smooth=w_smooth, w_ls=w_ls, killing=killing,
              gamma=gamma, band_union=band_union, taps=taps, out=out, active=active)
    if device.type == "cpu":
        return fused_gradient_update_reference(warped, canonical, warp_cm, rate, **kw)
    if device.type != "cuda":
        raise ValueError(f"no fused gradient kernel for device {device}")

    lib = _library()
    nx, ny, nz = warped.shape
    vol = (3, nx, ny, nz)
    new_warp = out if out is not None else torch.empty(vol, dtype=torch.float32, device=device)
    stats = torch.empty(8, dtype=torch.float32, device=device)
    g = torch.empty(vol, dtype=torch.float32, device=device)
    stream = _lib.stream_handle(device)
    if ticket is None:
        ticket = _ticket(device, (nx, ny, nz), stream)
    taps_arr = (ctypes.c_float * max(len(taps), 1))(*np.asarray(taps, np.float32))
    with torch.cuda.device(device):
        rows = lib.lsf_fused_partials_len(nx, ny, nz, len(taps))
        if rows <= 0:
            raise RuntimeError(f"fused_gradient_update: no grid for {(nx, ny, nz)}")
        partial = torch.empty(rows, dtype=torch.float64, device=device)
        err = lib.lsf_fused_gradient_update(
            warped.data_ptr(), canonical.data_ptr(), warp_cm.data_ptr(),
            rate.data_ptr(), new_warp.data_ptr(), stats.data_ptr(),
            g.data_ptr(), partial.data_ptr(), ticket.data_ptr(), _lib.flag_ptr(active),
            nx, ny, nz,
            w_data, w_smooth, w_ls, int(bool(killing)), gamma, int(bool(band_union)),
            taps_arr, len(taps), stream,
        )
    _lib.check(err, lib.lsf_fused_error_string, "fused_gradient_update launch")
    if _lib.capturing():
        captured_count += 1
    else:
        launch_count += 1
    return new_warp, stats
