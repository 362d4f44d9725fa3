"""Is the fused kernel's separable Sobolev convolution faster as a stencil on
the CUDA cores, or as a banded matrix product on the tensor cores?

Port of ``experiments/mxu_conv.py``. A zero-padded K-tap convolution along
an axis of length n is a product with the (n, n) band matrix ``band(n,
taps)``, the zero edge falling out of the band's cut at the matrix border.
One conv pass is the y-convolution then the z-convolution of every x-slice,
``out = C_yᵀ · A · C_z``; the kernels repeat it ``reps`` times with the
block resident in shared memory (``csrc/conv_yz.cu``):

- ``conv_yz_stencil`` — the stencil (the JAX ``vpu`` kernel);
- ``conv_yz_banded_f32`` — the banded product with 3×TF32 ``mma.sync``,
  float32 accuracy (the JAX ``mxu`` kernel at precision HIGHEST);
- ``conv_yz_banded_bf16`` — bf16 operands, float32 accumulate (the JAX
  ``mxu`` kernel at precision DEFAULT).

The banded kernels multiply only the k steps of ``C_y`` and ``C_z`` that
hold a nonzero. ``band_extents(c, cols, step)`` finds them on the matrices
passed in, with no assumption of a band: for each group of ``cols`` columns,
the first and last k step of ``step`` rows holding a nonzero. The wrappers
compute it for ``cy`` per 16 columns and for ``cz`` per 8 (the products'
output tiles), in steps of 8 rows (TF32) or 16 (bf16). With finite inputs
the skipped products are exact zeros, so the result is the dense product's;
a NaN or Inf in ``a`` does not reach a skipped block, where the dense
product would spread it. ``mma_count`` is the ``mma.sync`` count a slice
and pass that the extents give.

``run`` prints one JSON line. Its keys and the JAX keys they map:
``parity_max_abs_err`` (stencil against banded f32 after one pass, as JAX's
vpu against mxu), ``bf16_vs_f32_max_abs_err`` (same), and per variant the
µs per conv pass from a ``reps``-pass call differenced against a 1-pass
call: ``stencil_us_per_convpass`` (JAX ``vpu_us_per_convpass``),
``tc_f32_us_per_convpass`` (JAX ``mxu_…``), ``tc_bf16_us_per_convpass``
(JAX ``mxu_bf16_…``).

    python -m levelsetfusion_tpu_torch.experiments.mxu_conv
"""

from __future__ import annotations

import ctypes
import functools
import json

import numpy as np
import torch

from levelsetfusion_tpu_torch.experiments._timing import (
    device_name,
    differenced_ms,
    resolve_device,
)
from levelsetfusion_tpu_torch.ops import sobolev
from levelsetfusion_tpu_torch.ops.kernels import _lib
from levelsetfusion_tpu_torch.ops.kernels.fused_gradient import sobolev_taps

MAX_RADIUS = 7  # kMaxRadius of csrc/conv_yz.cu
MAX_SMEM = 232448  # bytes of dynamic shared memory a block may use
BANDED_MAX_PLANE = 16384  # Y * Z of the banded kernels

# Kernel launches per entry point since import or the last reset; callers set
# the values to 0 to count the launches of one run.
launch_counts = {"stencil": 0, "banded_f32": 0, "banded_bf16": 0}


def band(n: int, taps) -> np.ndarray:
    """The (n, n) matrix C with ``(a @ C)[j] = sum_s taps[r+s] a[j+s]``,
    zero outside ``[0, n)``."""
    r = len(taps) // 2
    m = np.zeros((n, n), np.float32)
    for j in range(n):
        for s in range(-r, r + 1):
            if 0 <= j + s < n:
                m[j + s, j] += taps[r + s]
    return m


def band_extents(c: torch.Tensor, cols: int, step: int) -> torch.Tensor:
    """For each group of ``cols`` consecutive columns of ``c`` (rows, width),
    the first and last k step of ``step`` rows that holds a nonzero (a NaN
    counts), as int32 (width / cols, 2); a group with no nonzero gets the
    empty range (0, -1). Plain torch on ``c``'s device, no host sync."""
    if c.ndim != 2 or c.shape[0] % step or c.shape[1] % cols:
        raise ValueError(
            f"want a matrix of whole {step}-row steps and {cols}-column groups, "
            f"got shape {tuple(c.shape)}"
        )
    rows, width = c.shape
    hit = (c != 0).reshape(rows // step, step, width // cols, cols).any(3).any(1)
    steps = torch.arange(rows // step, device=c.device)[:, None]
    last = torch.where(hit, steps, -1).amax(0)
    first = torch.where(hit, steps, rows // step).amin(0)
    first = torch.where(last < 0, 0, first)
    return torch.stack([first, last], 1).to(torch.int32)


def _extents(cy, cz, bf16: bool):
    """The extents the banded kernels walk: C_y per 16 columns (the y
    product's m-tiles), C_z per 8 (the z product's n-tiles)."""
    step = 16 if bf16 else 8
    return band_extents(cy, 16, step), band_extents(cz, 8, step)


def mma_count(cy, cz, bf16: bool) -> int:
    """``mma.sync`` instructions a banded kernel issues per slice and pass:
    each (m-tile, n-tile) pair runs its band extent's steps, three mma a
    step for 3×TF32 and one for bf16."""
    ey, ez = (e[:, 1] - e[:, 0] + 1 for e in _extents(cy, cz, bf16))
    steps = int(ey.sum()) * (cz.shape[1] // 8) + int(ez.sum()) * (cy.shape[1] // 16)
    return steps * (1 if bf16 else 3)


def conv_yz_stencil_reference(a: torch.Tensor, taps, reps: int) -> torch.Tensor:
    """Plain version: the port's zero-padded ``_convolve_axis`` along y then
    z, ``reps`` times. It convolves (tap t multiplies ``kernel[k-1-t]``), so
    the taps go in reversed to give ``sum_s taps[r+s] a[j+s]``."""
    kernel = torch.tensor(tuple(reversed(taps)), dtype=a.dtype, device=a.device)
    for _ in range(reps):
        a = sobolev._convolve_axis(sobolev._convolve_axis(a, kernel, 1), kernel, 2)
    return a


def _banded(a, cy, cz, reps, rounded):
    for _ in range(reps):
        t = torch.einsum("yY,xyz->xYz", rounded(cy), rounded(a))
        a = torch.einsum("xYz,zZ->xYZ", rounded(t), rounded(cz))
    return a


def conv_yz_banded_reference(a, cy, cz, reps: int) -> torch.Tensor:
    """Plain version: ``C_yᵀ · A · C_z`` per x-slice as two float32 einsums
    (full float32: the package keeps TF32 off)."""
    return _banded(a, cy, cz, reps, lambda v: v)


def conv_yz_banded_bf16_reference(a, cy, cz, reps: int) -> torch.Tensor:
    """Plain version of the bf16 route: the same einsums on operands rounded
    to bf16 (the intermediate after the y-product included), float32 sums."""
    return _banded(a, cy, cz, reps, lambda v: v.bfloat16().float())


_P, _I = ctypes.c_void_p, ctypes.c_int
# in, cy, cz, ext_y, ext_z, out, nx, ny, nz, reps, bf16, stream
BANDED_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the entry points' argument and result types on a loaded
    ``csrc/conv_yz.cu`` library (or a sweep's variant of it)."""
    lib.lsf_conv_yz_stencil.argtypes = [
        _P, _P, _I, _I, _I, ctypes.POINTER(ctypes.c_float), _I, _I, _P,
    ]
    lib.lsf_conv_yz_stencil.restype = _I
    lib.lsf_conv_yz_banded.argtypes = list(BANDED_ARGTYPES)
    lib.lsf_conv_yz_banded.restype = _I
    lib.lsf_conv_yz_error_string.argtypes = [_I]
    lib.lsf_conv_yz_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_lib.load("conv_yz"))


def _check_block(a: torch.Tensor, reps: int) -> None:
    if a.ndim != 3:
        raise ValueError(f"want a block (X, Y, Z), got shape {tuple(a.shape)}")
    if not isinstance(reps, int) or reps < 0:
        raise ValueError(f"reps must be an int >= 0, got {reps!r}")
    _lib.require_f32_contiguous("a", a, a.device)
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conv_yz kernel for device {a.device}")


def conv_yz_stencil(a: torch.Tensor, taps, reps: int) -> torch.Tensor:
    """``reps`` conv passes of ``a`` (X, Y, Z) as a stencil; float32,
    contiguous; odd ``taps``, at most 15; 2·Y·Z·4 bytes must fit a block's
    shared memory. CUDA tensors run the kernel, CPU tensors the plain
    version."""
    _check_block(a, reps)
    if len(taps) % 2 == 0 or not 1 <= len(taps) // 2 <= MAX_RADIUS:
        raise ValueError(f"taps must be an odd count in [3, {2 * MAX_RADIUS + 1}]")
    _, ny, nz = a.shape
    if 2 * ny * nz * 4 > MAX_SMEM:
        raise ValueError(f"a slice of {ny} x {nz} does not fit shared memory twice")
    if a.device.type == "cpu":
        return conv_yz_stencil_reference(a, taps, reps)
    lib = _library()
    out = torch.empty_like(a)
    taps_arr = (ctypes.c_float * len(taps))(*np.asarray(taps, np.float32))
    with torch.cuda.device(a.device):
        err = lib.lsf_conv_yz_stencil(
            a.data_ptr(), out.data_ptr(), *a.shape, taps_arr, len(taps), reps,
            _lib.stream_handle(a.device),
        )
    _lib.check(err, lib.lsf_conv_yz_error_string, "conv_yz_stencil launch")
    launch_counts["stencil"] += 1
    return out


def _banded_call(a, cy, cz, reps, bf16: bool) -> torch.Tensor:
    _check_block(a, reps)
    _, ny, nz = a.shape
    if ny % 16 or nz % 16 or ny * nz > BANDED_MAX_PLANE:
        raise ValueError(
            f"banded conv wants Y and Z multiples of 16 with Y*Z <= "
            f"{BANDED_MAX_PLANE}, got {ny} x {nz}"
        )
    if tuple(cy.shape) != (ny, ny) or tuple(cz.shape) != (nz, nz):
        raise ValueError(
            f"want cy ({ny}, {ny}) and cz ({nz}, {nz}), got "
            f"{tuple(cy.shape)} and {tuple(cz.shape)}"
        )
    _lib.require_f32_contiguous("cy", cy, a.device)
    _lib.require_f32_contiguous("cz", cz, a.device)
    if a.device.type == "cpu":
        ref = conv_yz_banded_bf16_reference if bf16 else conv_yz_banded_reference
        return ref(a, cy, cz, reps)
    lib = _library()
    ext_y, ext_z = _extents(cy, cz, bf16)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.lsf_conv_yz_banded(
            a.data_ptr(), cy.data_ptr(), cz.data_ptr(), ext_y.data_ptr(),
            ext_z.data_ptr(), out.data_ptr(), *a.shape, reps, int(bf16),
            _lib.stream_handle(a.device),
        )
    name = "banded_bf16" if bf16 else "banded_f32"
    _lib.check(err, lib.lsf_conv_yz_error_string, f"conv_yz_{name} launch")
    launch_counts[name] += 1
    return out


def conv_yz_banded_f32(a, cy, cz, reps: int) -> torch.Tensor:
    """``reps`` conv passes of ``a`` (X, Y, Z) as ``C_yᵀ · A · C_z`` on the
    tensor cores at float32 accuracy (3×TF32), over the k steps that
    ``band_extents`` finds nonzero. Y and Z multiples of 16, Y·Z at most
    16384; ``cy`` (Y, Y), ``cz`` (Z, Z); all float32, contiguous, one device.
    CUDA tensors run the kernel, CPU tensors the plain version."""
    return _banded_call(a, cy, cz, reps, bf16=False)


def conv_yz_banded_bf16(a, cy, cz, reps: int) -> torch.Tensor:
    """As ``conv_yz_banded_f32`` with bf16 operands and float32 sums."""
    return _banded_call(a, cy, cz, reps, bf16=True)


def inputs(shape, device):
    """The JAX script's inputs: a standard-normal block from seed 0, the
    7-tap λ=0.1 Sobolev taps and their band matrices."""
    taps = sobolev_taps(7, 0.1)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    cy = torch.from_numpy(band(shape[1], taps)).to(device)
    cz = torch.from_numpy(band(shape[2], taps)).to(device)
    return a, taps, cy, cz


def run(shape=(16, 128, 128), reps=1024, device="cuda") -> dict:
    """Parity of the three routes after one pass, then µs per conv pass of
    each (see the module docstring for the keys)."""
    if reps < 2:
        raise ValueError("reps must be >= 2 to difference against one pass")
    device = resolve_device(device)
    a, taps, cy, cz = inputs(shape, device)
    routes = {
        "stencil": lambda r: conv_yz_stencil(a, taps, r),
        "tc_f32": lambda r: conv_yz_banded_f32(a, cy, cz, r),
        "tc_bf16": lambda r: conv_yz_banded_bf16(a, cy, cz, r),
    }
    one = {name: fn(1) for name, fn in routes.items()}
    out = {
        "shape": list(shape), "reps": reps, "device": device_name(device),
        "parity_max_abs_err": float(torch.max(torch.abs(one["stencil"] - one["tc_f32"]))),
        "bf16_vs_f32_max_abs_err": float(torch.max(torch.abs(one["tc_bf16"] - one["tc_f32"]))),
    }
    for name, fn in routes.items():
        ms = differenced_ms(lambda: fn(reps), lambda: fn(1), reps - 1, device)
        out[f"{name}_us_per_convpass"] = ms * 1e3
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    run()
