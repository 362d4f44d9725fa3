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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from levelsetfusion_tpu_torch.ops.interpolation import warp_field
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
ARGTYPES = (_P, _P, _P, _I, _I, _I, _P, _P)  # live, warp_cm, out, nx, ny, nz, active, stream


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
                            active: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version: the golden ``warp_field`` on a component-major
    warp ``(D, *spatial)``. Where ``active`` is false the output is NaN,
    standing for the kernel's unwritten one."""
    if active is not None and not bool(active):
        return torch.full_like(live, float("nan"))
    return warp_field(live, warp_cm.movedim(0, -1))


def _as_3d(live: torch.Tensor, warp_cm: torch.Tensor):
    """A 2D (X, Z) field as (X, 1, Z) with zero y displacement — the same
    trilinear sum, since the y=1 corners carry zero weight."""
    x, z = live.shape
    zero = torch.zeros_like(warp_cm[0])
    warp3 = torch.stack([warp_cm[0], zero, warp_cm[1]]).view(3, x, 1, z)
    return live.view(x, 1, z), warp3


def warp_field_cm(live: torch.Tensor, warp_cm: torch.Tensor,
                  active: torch.Tensor | None = None) -> torch.Tensor:
    """Resample ``live`` (``(*spatial,)``, 2D or 3D) at ``v + u(v)`` for a
    component-major warp ``warp_cm`` (``(D, *spatial)``); float32,
    contiguous, one device. CUDA tensors run the kernel, CPU tensors the
    plain version. ``active``: None, or a 0-d bool tensor on the same
    device; the kernel reads it, and returns at once where it is false."""
    global launch_count, captured_count
    d = live.ndim
    if d not in (2, 3) or tuple(warp_cm.shape) != (d, *live.shape):
        raise ValueError(
            f"warp_cm {tuple(warp_cm.shape)} does not match field "
            f"{tuple(live.shape)} (want (D, *spatial), D = 2 or 3)"
        )
    _lib.require_f32_contiguous("live", live, live.device)
    _lib.require_f32_contiguous("warp_cm", warp_cm, live.device)
    _lib.require_flag(active, live.device)
    if live.device.type == "cpu":
        return warp_field_cm_reference(live, warp_cm, active)
    if live.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {live.device}")

    live3, warp3 = _as_3d(live, warp_cm) if d == 2 else (live, warp_cm)
    out = torch.empty_like(live3)
    lib = _library()
    with torch.cuda.device(live.device):
        err = lib.lsf_warp_field_cm(
            live3.data_ptr(), warp3.data_ptr(), out.data_ptr(),
            *live3.shape, _lib.flag_ptr(active), _lib.stream_handle(live.device),
        )
    _lib.check(err, lib.lsf_resample_error_string, "warp_field_cm launch")
    if _lib.capturing():
        captured_count += 1
    else:
        launch_count += 1
    return out.view(live.shape)
