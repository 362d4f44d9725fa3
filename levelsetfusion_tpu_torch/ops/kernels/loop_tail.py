"""The solve loop's bookkeeping after an iteration's step, in one call: the
total energy, the adaptive rate's halving, the previous energy, the
iteration's telemetry column, the per-axis max |u|, the last max |du|, the
iteration count and the done flag of the next iteration.

It replaces no TPU kernel: the JAX package's loop carries this state through
``lax.while_loop``, which XLA fuses. The CUDA kernel, ``csrc/loop_tail.cu``,
does it in one launch of one warp. ``loop_tail`` launches it for CUDA
tensors and uses the plain version ``loop_tail_reference`` only for CPU
tensors. ``next_flag`` is the done rule, which the loop also uses to seed
the flag of a solve's first iteration.

It reads the step's ``stats`` (B2's 8 values or the 2D step's 7: the three
energies, Σ‖δu‖, max ‖δu‖, the per-axis max |u'|) and the iteration's gate
``flag``, and updates the loop's buffers in place: ``rate``,
``prev_energy``, ``telemetry`` ``(5, n + 1)``, ``max_disp`` ``(D,)``,
``max_update``, ``iteration`` and ``active`` (which may be ``flag``). The
kernel gives the plain version's float32 values bit for bit. With the flag
off the kernel writes nothing; the plain version writes the spare telemetry
column ``n``, which no result reads, and recomputes ``active`` from the
unchanged state.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from levelsetfusion_tpu_torch.ops.kernels import _lib

# The telemetry rows' stats: the data, smoothing and level-set energies, max
# ‖δu‖ and Σ‖δu‖ (divided by the voxel count).
ROWS = (0, 1, 2, 4, 3)

# Kernel launches (calls that ran the CUDA kernel) since import or the last
# reset; callers set it to 0 to count the launches of one run. A call made
# while its stream is being captured into a CUDA graph launches nothing: it
# adds one to ``captured_count`` instead, and the code that replays the graph
# adds the calls its capture recorded to ``launch_count`` at each replay.
launch_count = 0
captured_count = 0


def loop_tail_reference(stats, flag, rate, prev_energy, telemetry, max_disp, max_update,
                        iteration, active, *, threshold, voxels, adaptive):
    """Plain torch version: the solve loop's ops after the step, gated by
    ``flag`` with ``torch.where``."""
    n = telemetry.shape[1] - 1
    energy = stats[0] + stats[1] + stats[2]
    if adaptive:
        torch.where(flag & (energy > prev_energy), rate * 0.5, rate, out=rate)
    torch.where(flag, energy, prev_energy, out=prev_energy)
    column = torch.where(flag, iteration, n)
    rows = torch.tensor(ROWS, device=stats.device)
    divisor = torch.tensor([1.0, 1.0, 1.0, 1.0, float(voxels)], dtype=torch.float32,
                           device=stats.device)
    telemetry.index_copy_(1, column.view(1), (stats.index_select(0, rows) / divisor).view(5, 1))
    torch.where(flag, torch.maximum(max_disp, stats[5:]), max_disp, out=max_disp)
    torch.where(flag, stats[4], max_update, out=max_update)
    iteration += flag
    next_flag(iteration, max_update, n, threshold, out=active)


def next_flag(iteration, max_update, n, threshold, *, out):
    """The solve loop's done rule: the next iteration runs while ``iteration
    < n`` and ``max_update >= threshold`` (false where ``max_update`` is
    NaN), into the 0-d bool ``out``."""
    torch.logical_and(iteration < n, max_update >= threshold, out=out)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The prototype of lsf_loop_tail in csrc/loop_tail.cu (tests/test_torch_loop_tail.py
# holds them together).
ARGTYPES = (
    _P, _P,  # stats, flag
    _P, _P, _P, _P, _P, _P, _P,  # rate, prev_energy, telemetry, max_disp, max_update,
                                 # iteration, active
    _I, _I, _F, _F, _I,  # dim, n, threshold, voxels, adaptive
    _P,  # stream
)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _lib.load("loop_tail")
    lib.lsf_loop_tail.argtypes = list(ARGTYPES)
    lib.lsf_loop_tail.restype = _I
    lib.lsf_loop_tail_error_string.argtypes = [_I]
    lib.lsf_loop_tail_error_string.restype = ctypes.c_char_p
    return lib


def _require_scalar(name, t, dtype, device):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.ndim != 0:
        got = f"{t.dtype} {tuple(t.shape)}" if isinstance(t, torch.Tensor) else type(t).__name__
        raise TypeError(f"{name} must be a 0-d {dtype} tensor, got {got}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def loop_tail(stats, flag, rate, prev_energy, telemetry, max_disp, max_update, iteration,
              active, *, threshold, voxels, adaptive):
    """Update the solve loop's state from one iteration's ``stats``, where
    ``flag`` is set.

    Args:
      stats: the step's ``5 + D`` float32 stats.
      flag: the iteration's gate, a 0-d bool tensor.
      rate, prev_energy, max_update: 0-d float32 tensors, updated in place.
      telemetry: ``(5, n + 1)`` float32; column ``iteration`` gets the
        iteration's entries (``n`` = the iteration cap).
      max_disp: ``(D,)`` float32, the per-axis max |u|.
      iteration: 0-d int64; ``active``: 0-d bool, the next iteration's flag
        (may be ``flag``).
      threshold: the convergence threshold (rounded to float32 as compared).
      voxels: the voxel count, the divisor of Σ‖δu‖.
      adaptive: whether the rate halves where the energy rose.

    All tensors contiguous, on one device. CUDA tensors run the kernel, CPU
    tensors the plain version. Nothing is allocated on CUDA.
    """
    global launch_count, captured_count
    device = stats.device
    dim = max_disp.numel()
    for name, t in (("stats", stats), ("telemetry", telemetry), ("max_disp", max_disp)):
        _lib.require_f32_contiguous(name, t, device)
    if max_disp.ndim != 1 or dim not in (2, 3) or tuple(stats.shape) != (5 + dim,):
        raise ValueError(f"want max_disp (D,) with D 2 or 3 and stats (5 + D,), got "
                         f"{tuple(max_disp.shape)} and {tuple(stats.shape)}")
    if telemetry.ndim != 2 or telemetry.shape[0] != 5 or telemetry.shape[1] < 1:
        raise ValueError(f"telemetry must be (5, n + 1), got {tuple(telemetry.shape)}")
    for name, t in (("rate", rate), ("prev_energy", prev_energy), ("max_update", max_update)):
        _require_scalar(name, t, torch.float32, device)
    _require_scalar("iteration", iteration, torch.int64, device)
    _require_scalar("flag", flag, torch.bool, device)
    _require_scalar("active", active, torch.bool, device)
    kw = dict(threshold=threshold, voxels=voxels, adaptive=adaptive)
    if device.type == "cpu":
        return loop_tail_reference(stats, flag, rate, prev_energy, telemetry, max_disp,
                                   max_update, iteration, active, **kw)
    if device.type != "cuda":
        raise ValueError(f"no loop-tail kernel for device {device}")

    lib = _library()
    with torch.cuda.device(device):
        err = lib.lsf_loop_tail(
            stats.data_ptr(), flag.data_ptr(), rate.data_ptr(), prev_energy.data_ptr(),
            telemetry.data_ptr(), max_disp.data_ptr(), max_update.data_ptr(),
            iteration.data_ptr(), active.data_ptr(), dim, telemetry.shape[1] - 1,
            threshold, voxels, int(bool(adaptive)),  # c_float rounds as float32 does
            _lib.stream_handle(device),
        )
    _lib.check(err, lib.lsf_loop_tail_error_string, "loop_tail launch")
    if _lib.capturing():
        captured_count += 1
    else:
        launch_count += 1
