"""The solve loop's warp resample: ``out(v) = live(v + u(v))``, trilinear,
+1 outside the volume, with a component-major warp.

Port of the TPU kernel ``levelsetfusion_tpu/ops/pallas/resample.py::
warp_field_pallas_prepared``; the CUDA kernel is ``csrc/resample.cu``. It
computes the golden ``ops/interpolation.py::warp_field`` exactly, for any
displacement and any shape: no ±K clamp, no stacked y-copies, no shape gate.

``warp_field_cm`` launches the kernel for CUDA tensors and uses the plain
version ``warp_field_cm_reference`` only for CPU tensors. Both take the
solve loop's optional ``active`` flag (``models/single_level.py``): where it
is false the call computes nothing and its output is left unwritten.

The sharded solvers resample a block of the warp from a haloed block of the
live field: ``x_start`` (B1's argument of that name) makes output row i
sample field row ``x_start + i + ux``, and the field may hold more x rows
than the warp (the golden gather of ``levelsetfusion_tpu/parallel/
sharded.py`` on the haloed block, +1 outside the field's rows).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from levelsetfusion_tpu_torch.ops.interpolation import identity_positions, sample_at
from levelsetfusion_tpu_torch.ops.kernels import _lib

# Kernel launches (calls that ran the CUDA kernel) since import or the last
# reset; callers set it to 0 to count the launches of one run. A call made
# while its stream is being captured into a CUDA graph launches nothing: it
# adds one to ``captured_count`` instead, and the code that replays the graph
# adds the calls its capture recorded to ``launch_count`` at each replay.
launch_count = 0
captured_count = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
# The prototype of lsf_warp_field_cm in csrc/resample.cu
# (tests/test_torch_resample.py holds them together).
# live, warp_cm, out, nx, ny, nz (the warp's), fx (the field's x rows),
# x_start, active, stream
ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points of a library built from csrc/resample.cu
    (or from a variant of it, experiments/resample_sweep.py)."""
    lib.lsf_warp_field_cm.argtypes = list(ARGTYPES)
    lib.lsf_warp_field_cm.restype = _I
    lib.lsf_resample_error_string.argtypes = [_I]
    lib.lsf_resample_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_lib.load("resample"))


def warp_field_cm_reference(live: torch.Tensor, warp_cm: torch.Tensor,
                            active: torch.Tensor | None = None,
                            x_start: int = 0) -> torch.Tensor:
    """Plain torch version: the golden ``sample_at`` at ``(x_start + i + ux,
    j + uy, ...)`` for a component-major warp ``(D, *spatial)``; with
    ``x_start`` 0 and a field of the warp's shape, the golden
    ``warp_field``. Where ``active`` is false the output is NaN, standing
    for the kernel's unwritten one."""
    if active is not None and not bool(active):
        return torch.full(warp_cm.shape[1:], float("nan"), dtype=live.dtype,
                          device=live.device)
    pos = identity_positions(warp_cm.shape[1:], live.device, warp_cm.dtype)
    pos[..., 0] += x_start  # integers: exact, as the kernel's float(x_start + i)
    return sample_at(live, pos + warp_cm.movedim(0, -1))


def _as_3d(live: torch.Tensor, warp_cm: torch.Tensor):
    """A 2D (X, Z) field as (X, 1, Z) with zero y displacement — the same
    trilinear sum, since the y=1 corners carry zero weight."""
    fx, z = live.shape
    x = warp_cm.shape[1]
    zero = torch.zeros_like(warp_cm[0])
    warp3 = torch.stack([warp_cm[0], zero, warp_cm[1]]).view(3, x, 1, z)
    return live.view(fx, 1, z), warp3


def warp_field_cm(live: torch.Tensor, warp_cm: torch.Tensor,
                  active: torch.Tensor | None = None, x_start: int = 0) -> torch.Tensor:
    """Resample ``live`` (``(*spatial,)``, 2D or 3D) at ``v + u(v)`` for a
    component-major warp ``warp_cm`` (``(D, *spatial)``); float32,
    contiguous, one device. CUDA tensors run the kernel, CPU tensors the
    plain version. ``active``: None, or a 0-d bool tensor on the same
    device; the kernel reads it, and returns at once where it is false.

    ``x_start`` (an int): output row i samples field row ``x_start + i +
    ux``; ``live`` may then hold any number of x rows (a block with its
    halo), the other extents the warp's. The output has the warp's shape."""
    global launch_count, captured_count
    d = live.ndim
    if (d not in (2, 3) or warp_cm.ndim != d + 1 or warp_cm.shape[0] != d
            or tuple(warp_cm.shape[2:]) != tuple(live.shape[1:])):
        raise ValueError(
            f"warp_cm {tuple(warp_cm.shape)} does not match field "
            f"{tuple(live.shape)} (want (D, X, *rest) for a (FX, *rest) field, D = 2 or 3)"
        )
    x_start = int(x_start)
    if abs(x_start) + warp_cm.shape[1] >= 1 << 24:
        raise ValueError(f"x_start {x_start} out of range: |x_start| + X must be below 2^24")
    _lib.require_f32_contiguous("live", live, live.device)
    _lib.require_f32_contiguous("warp_cm", warp_cm, live.device)
    _lib.require_flag(active, live.device)
    if live.device.type == "cpu":
        return warp_field_cm_reference(live, warp_cm, active, x_start)
    if live.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {live.device}")

    live3, warp3 = _as_3d(live, warp_cm) if d == 2 else (live, warp_cm)
    out = torch.empty(warp3.shape[1:], dtype=live.dtype, device=live.device)
    lib = _library()
    with torch.cuda.device(live.device):
        err = lib.lsf_warp_field_cm(
            live3.data_ptr(), warp3.data_ptr(), out.data_ptr(), *out.shape, live3.shape[0],
            x_start, _lib.flag_ptr(active), _lib.stream_handle(live.device),
        )
    _lib.check(err, lib.lsf_resample_error_string, "warp_field_cm launch")
    if _lib.capturing():
        captured_count += 1
    else:
        launch_count += 1
    return out.view(warp_cm.shape[1:])
