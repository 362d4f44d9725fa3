"""The card's peaks and the bytes the solve's two kernels must move.

Peak: NVIDIA's H100 SXM data sheet, 80 GB HBM3 at 3.35 TB/s, at its 700 W
power limit. The byte counts are frozen copies of ``chip_smoke.py::_bound``'s
rule and of ``utils/profiling.py::solver_roofline``: each input read once,
each output written once, float32. Both kernels are bound by bytes: their
float operations over the 67 TFLOP/s f32 peak take less (B2's 270 a voxel
8.4 µs at 128³ against its 20.0 µs of bytes; B1's 43, 1.3 against 12.5).

- B1 (the resample) reads the live field and the D-component warp and
  writes the warped field: ``(1 + D + 1) V`` floats.
- B2 (the fused gradient and update) reads the warped field, the canonical
  and the warp and writes the new warp: ``(2 + 2 D) V`` floats.

At a sharded block (``parallel/sharded.py``) a call reads only the rows it
needs: B2's three inputs hold the block's rows and the stencil halo inside
the volume (``b2_block_bytes``); B1 reads the field rows of the block
(displacements reach a few halo rows, which are left out) and the block's
warp, and writes the block.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32 = 4

# Device kernel names (as ``tracing.short_name`` gives them) of each kernel.
B1_KERNELS = ("warp_field_cm_kernel",)
B2_KERNELS = ("terms_kernel", "sobolev_update_kernel")


def b1_bytes(voxels: int, dim: int = 3) -> float:
    """One B1 call over ``voxels`` output voxels."""
    return float((1 + dim + 1) * voxels * F32)


def b2_bytes(voxels: int, dim: int = 3) -> float:
    """One B2 call over ``voxels`` updated voxels with no halo."""
    return float((2 + 2 * dim) * voxels * F32)


def iteration_bytes(voxels: int, dim: int = 3) -> float:
    """One solver iteration (a B1 and a B2 call) over the whole volume:
    ``solver_roofline``'s numerator, whatever kernels implement it."""
    return b1_bytes(voxels, dim) + b2_bytes(voxels, dim)


def b2_block_bytes(rows: int, plane: int, rank: int, world: int, halo: int,
                   dim: int = 3) -> float:
    """One B2 call on rank ``rank``'s block of ``rows`` x-rows (``plane``
    voxels a row) of a volume split over ``world`` ranks, with ``halo``
    stencil rows a side: the input rows inside the volume, read for the
    warped field, the canonical and the warp, and the block's rows written."""
    lo = rank * rows - halo
    hi = (rank + 1) * rows + halo
    inside = min(hi, rows * world) - max(lo, 0)
    return float(((2 + dim) * inside + dim * rows) * plane * F32)
