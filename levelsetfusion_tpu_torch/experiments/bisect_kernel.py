"""Bisect the resample body's cost on a stack that is already materialised:
the production body's features added back one at a time.

Port of ``experiments/bisect_kernel.py``. Inputs as ``loop_cost``: a stack
``stacked`` (6, XP ≥ X + 5, Y, 128) and a channel-last warp (X, Y, 128, 3).

- ``run(stacked, warp, level)`` (B8), a runtime pair loop whose levels add up:
  0 ``base`` (loop_cost's ``full`` body), 1 ``zsetup`` (the real z weights,
  zeroed outside), 2 ``tents`` (the x/y tent weights of the raw ux, uy),
  3 ``acc0`` (the sum starts from the +1 fill's weight), 4 ``clampin``
  (ux, uy clamped to ±2 in the kernel);
- ``run_v8(stacked, warp, yb, which)`` (B7): level 4 with the 12 tent
  values (``v8``) or the 36 weight products (``v8c``, the fill added after
  the loop) computed once per voxel.

The kernel is ``csrc/stack_bodies.cu`` (through ``loop_cost.launch``), its
one-wave ``table_kernel`` (loop code ``frame``) for every level and both
bodies of ``run_v8``; the plain versions are
``loop_cost.stack_body_reference`` under the level's body. On the stack of
a field (``make_stack``), level 4, v8 and v8c are the golden ``warp_field``
on the clamped warp.

``main`` follows the script: by default each level's µs per call on its
random stack; with ``mode="v8"``, v8 and v8c at yb 64 and 128 on the stack
of a field, with max|Δ| against the golden resample. Inputs are drawn in the
script's order, seed 0: the stack, the warp, then the field.

    python -m levelsetfusion_tpu_torch.experiments.bisect_kernel [v8 | level ...]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from levelsetfusion_tpu_torch.experiments import loop_cost
from levelsetfusion_tpu_torch.experiments._timing import (
    best_ms,
    device_name,
    resolve_device,
)
from levelsetfusion_tpu_torch.experiments.loop_cost import (
    LANE,
    K,
    N,
    check_stack_inputs,
    stack_body_reference,
)
from levelsetfusion_tpu_torch.experiments.resample_variants import clamp_warp
from levelsetfusion_tpu_torch.ops.interpolation import TRUNCATION_FILL, warp_field

SHAPE = (128, 128)  # the script's (X, Y)
YB = 64  # run's y block (fixed in the script)
LEVELS = ("full", "zsetup", "tents", "acc0", "clampin")  # stack_bodies.cu bodies
LEVEL_NAMES = ("base", "zsetup", "tents", "acc0", "clampin")  # the script's names
WHICH = ("v8", "v8c")
V8_YBS = (64, 128)

# Kernel launches per entry since import or the last reset; callers set the
# values to 0 to count the launches of one run.
launch_counts = {"run": 0, "run_v8": 0}


def bisect_reference(stacked, warp, level: int) -> torch.Tensor:
    """Plain version of ``run``."""
    return stack_body_reference(stacked, warp, LEVELS[level])


def v8_reference(stacked, warp, which: str = "v8") -> torch.Tensor:
    """Plain version of ``run_v8``."""
    return stack_body_reference(stacked, warp, which)


def run(stacked, warp, level: int) -> torch.Tensor:
    """B8: bisection ``level`` 0–4, a runtime pair loop, the script's y
    block (Y a multiple of 64). CUDA tensors run the kernel, CPU tensors the
    plain version."""
    if level not in range(len(LEVELS)):
        raise ValueError(f"level must be 0-{len(LEVELS) - 1}, got {level!r}")
    check_stack_inputs(stacked, warp, YB)
    if stacked.device.type == "cpu":
        return bisect_reference(stacked, warp, level)
    out = loop_cost.launch(stacked, warp, LEVELS[level], "frame")
    launch_counts["run"] += 1
    return out


def run_v8(stacked, warp, yb: int = 64, which: str = "v8") -> torch.Tensor:
    """B7: level 4 with its weights computed once per voxel, ``which`` in
    ``WHICH``. CUDA tensors run the kernel, CPU tensors the plain version."""
    if which not in WHICH:
        raise ValueError(f"which must be one of {WHICH}, got {which!r}")
    check_stack_inputs(stacked, warp, yb)
    if stacked.device.type == "cpu":
        return v8_reference(stacked, warp, which)
    out = loop_cost.launch(stacked, warp, which, "frame")
    launch_counts["run_v8"] += 1
    return out


def make_stack(field: torch.Tensor) -> torch.Tensor:
    """The script's stack of a field (X, Y, Z): the field padded by the +1
    fill (K cells before, K + 1 after, in x and y), then its N y-shifted
    windows, (N, X + 5, Y, Z)."""
    ny = field.shape[1]
    padded = F.pad(field, (0, 0, K, K + 1, K, K + 1), value=TRUNCATION_FILL)
    return torch.stack([padded[:, cy:cy + ny] for cy in range(N)])


def inputs(device, shape=SHAPE):
    """The script's draws for (X, Y) = ``shape``, seed 0, in its order: a
    standard normal stack (6, X + 5, Y, 128), a 1.5 N(0, 1) warp (X, Y, 128,
    3), then the field tanh(0.3 N(0, 1)) (X, Y, 128) of its ``v8`` mode."""
    nx, ny = shape
    rng = np.random.default_rng(0)
    stacked = rng.standard_normal((N, nx + N - 1, ny, LANE)).astype(np.float32)
    warp = (rng.standard_normal((nx, ny, LANE, 3)) * 1.5).astype(np.float32)
    field = np.tanh(rng.standard_normal((nx, ny, LANE)) * 0.3).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (stacked, warp, field)]


def main(device="cuda", mode=None, levels=None, shape=SHAPE) -> list:
    """One JSON row per level (µs per call on the random stack), or with
    ``mode="v8"`` per (which, yb) on the stack of a field (µs per call and
    max|Δ| against the golden resample)."""
    device = resolve_device(device)
    stacked, warp, field = inputs(device, shape)
    common = {"shape": [*shape, LANE], "device": device_name(device)}
    rows = []
    if mode == "v8":
        stack = make_stack(field)
        golden = warp_field(field, clamp_warp(warp))
        for which in WHICH:
            for yb in V8_YBS:
                err = float(torch.max(torch.abs(run_v8(stack, warp, yb, which) - golden)))
                us = best_ms(lambda: run_v8(stack, warp, yb, which), device) * 1e3
                rows.append({"which": which, "yb": yb, "us_per_call": us,
                             "max_abs_err_vs_golden": err, **common})
    else:
        for level in levels if levels is not None else range(len(LEVELS)):
            us = best_ms(lambda: run(stacked, warp, level), device) * 1e3
            rows.append({"level": level, "name": LEVEL_NAMES[level], "us_per_call": us,
                         **common})
    for row in rows:
        print(json.dumps(row))
    return rows


if __name__ == "__main__":
    args = sys.argv[1:]
    if "v8" in args:
        main(mode="v8")
    else:
        main(levels=[int(a) for a in args] or None)
