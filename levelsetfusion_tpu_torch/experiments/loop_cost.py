"""The cost of the resample's pair loop, on a stack that is already
materialised.

Port of ``experiments/loop_cost.py``. The input is a stack
``stacked[cy, px, y, z]`` of N = 2K + 2 = 6 planes (px an x row of the
padded field, XP ≥ X + N − 1 rows) and a channel-last warp (X, Y, 128, 3);
the output is (X, Y, 128). Each body sums over the 36 pairs t = 6 cy + cx
(cy outer), with R = stacked[cy, x + cx, y], z0 = z + ⌊uz⌋ and z0c, z1c the
clipped z0 and z0 + 1:

- ``nothing``: acc + 1;
- ``slice``: acc + R[z];
- ``slice0``: acc + stacked[0, x, y, z];
- ``gather``: acc + stacked[0, x, y, z0c];
- ``full``: acc + (0.5 R[z0c] + 0.25 R[z1c]).

``run`` takes a body and a loop: ``fori`` (a runtime pair loop) or
``static`` (the 36 pairs unrolled). The kernel is ``csrc/stack_bodies.cu``'s
``loop_kernel``, which walks equal ranges of (y tile, x row) steps through a
ring of staged x rows in one wave of CTAs (``b9_geometry``, ``b9_ranges``);
the file also carries the bodies of ``bisect_kernel``. The plain version of
every body is ``stack_body_reference``.

``main`` takes the script's cases, ``body/loop[/yb]`` (yb 64 by default), on
its inputs (a random stack and a 1.5 N(0, 1) warp, seed 0) and prints one
JSON row per case: µs per call and µs per body as the script defines it,
per call / ((Y / yb) · X · 36), the TPU grid's bodies.

    python -m levelsetfusion_tpu_torch.experiments.loop_cost [case ...]
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys

import numpy as np
import torch

from levelsetfusion_tpu_torch.experiments._timing import (
    best_ms,
    device_name,
    resolve_device,
)
from levelsetfusion_tpu_torch.ops.kernels import _lib

K = 2
N = 2 * K + 2  # stack planes and x shifts
NBODY = N * N
LANE = 128  # the z extent the kernel takes
SHAPE = (128, 128)  # the script's (X, Y)
BODY_KINDS = ("nothing", "slice", "slice0", "gather", "full")
LOOP_KINDS = ("fori", "static")
DEFAULT_CASES = ("nothing/fori", "slice/fori", "slice0/fori", "gather/fori", "full/fori",
                 "nothing/static", "full/static")
# Body and loop codes of csrc/stack_bodies.cu: this module's, then
# bisect_kernel's (its "frame": the one-wave kernel of its levels, v8, v8c).
BODIES = BODY_KINDS + ("zsetup", "tents", "acc0", "clampin", "v8", "v8c")
LOOPS = LOOP_KINDS + ("frame",)
TILE_Y = 4  # the wrappers' Y rule: Y must be a multiple (csrc/stack_bodies.cu kYRule)
# B9's launch (csrc/stack_bodies.cu kLoopTY, kLoopV, kLoopAhead): tiles of
# B9_TILE_ROWS y rows (a divisor of TILE_Y), B9_VOXELS voxels a thread (rows
# B9_TILE_ROWS / B9_VOXELS apart), a ring of N + B9_AHEAD staged x rows,
# B9_AHEAD of them in flight while a step sums.
B9_TILE_ROWS = 4
B9_VOXELS = 2
B9_AHEAD = 1
H100_SMS = 132
SM_SHARED_BYTES = 233472  # an SM's shared memory for CTAs (228 KB)
MAX_DYNAMIC_SMEM = 232448  # a CTA's (227 KB)

# Kernel launches since import or the last reset; callers set it to 0 to
# count the launches of one run.
launch_count = 0


def _tent(t):
    return torch.clamp_min(1.0 - torch.abs(t), 0.0)


def stack_body_reference(stacked: torch.Tensor, warp: torch.Tensor, body: str) -> torch.Tensor:
    """Plain version of every body of ``csrc/stack_bodies.cu`` (``BODIES``),
    in the kernel's order: the fill first (``acc0``, ``clampin``, ``v8``)
    or last (``v8c``), then the 36 pairs, cy outer and cx inner."""
    nx = warp.shape[0]
    ux, uy, uz = warp.unbind(-1)
    if body in ("clampin", "v8", "v8c"):
        ux, uy = ux.clamp(-K, K), uy.clamp(-K, K)
    nz = torch.floor(uz)
    z0 = torch.arange(LANE, device=warp.device) + nz.to(torch.int64)
    z0c, z1c = z0.clamp(0, LANE - 1), (z0 + 1).clamp(0, LANE - 1)
    if body in BODY_KINDS:
        w0, w1 = 0.5, 0.25
    else:
        fz = uz - nz
        zero = torch.zeros((), dtype=uz.dtype, device=uz.device)
        w0 = torch.where((z0 >= 0) & (z0 < LANE), 1.0 - fz, zero)
        w1 = torch.where((z0 + 1 >= 0) & (z0 + 1 < LANE), fz, zero)
    fill = 1.0 - w0 - w1

    def rows(cy, cx):
        return stacked[cy, cx:cx + nx]

    acc = fill if body in ("acc0", "clampin", "v8") else torch.zeros_like(uz)
    for t in range(NBODY):
        cy, cx = divmod(t, N)
        if body == "nothing":
            acc = acc + 1.0
        elif body == "slice":
            acc = acc + rows(cy, cx)
        elif body == "slice0":
            acc = acc + rows(0, 0)
        elif body == "gather":
            acc = acc + torch.gather(rows(0, 0), 2, z0c)
        else:
            r = rows(cy, cx)
            g = w0 * torch.gather(r, 2, z0c) + w1 * torch.gather(r, 2, z1c)
            if body in ("full", "zsetup"):
                acc = acc + g
            else:
                acc = acc + (_tent(uy - float(cy - K)) * _tent(ux - float(cx - K))) * g
    return acc + fill if body == "v8c" else acc


def loop_cost_reference(stacked, warp, body_kind: str) -> torch.Tensor:
    """Plain version of ``run`` (the loop does not change the value)."""
    return stack_body_reference(stacked, warp, body_kind)


_P, _I = ctypes.c_void_p, ctypes.c_int
# The prototype of csrc/stack_bodies.cu's entry point
# (tests/test_torch_loop_cost.py holds them together).
STACK_BODY_ARGTYPES = (
    _P, _P, _P,  # stack, warp, out
    _I, _I, _I, _I, _I, _I, _I,  # n, xp, nx, ny, nz, body, loop
    _P,  # stream
)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of the library's entry points."""
    lib.lsf_stack_body.argtypes = list(STACK_BODY_ARGTYPES)
    lib.lsf_stack_body.restype = _I
    lib.lsf_stack_bodies_error_string.argtypes = [_I]
    lib.lsf_stack_bodies_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(_lib.load("stack_bodies"))


def check_stack_inputs(stacked, warp, yb) -> None:
    """The wrappers' contract: warp (X, Y, 128, 3) and stacked (6, XP, Y,
    128) with XP ≥ X + 5 and Y a multiple of ``TILE_Y``, float32,
    contiguous, one device; the TPU grid's y block ``yb`` divides Y (it
    changes nothing else)."""
    if warp.ndim != 4 or warp.shape[-1] != 3 or stacked.ndim != 4:
        raise ValueError(
            f"want stacked ({N}, XP, Y, {LANE}) and warp (X, Y, {LANE}, 3), got "
            f"{tuple(stacked.shape)} and {tuple(warp.shape)}"
        )
    nx, ny, nz, _ = warp.shape
    if nz != LANE:
        raise ValueError(f"Z must be {LANE}, got {nz}")
    if nx < 1:
        raise ValueError("X must be at least 1")
    n, xp = stacked.shape[:2]
    if n != N or tuple(stacked.shape[2:]) != (ny, LANE) or xp < nx + N - 1:
        raise ValueError(
            f"want stacked ({N}, XP >= {nx + N - 1}, {ny}, {LANE}) for warp "
            f"{tuple(warp.shape)}, got {tuple(stacked.shape)}"
        )
    if ny % TILE_Y:
        raise ValueError(f"Y must be a multiple of {TILE_Y}, got {ny}")
    if not isinstance(yb, int) or yb < 1 or ny % yb:
        raise ValueError(f"y block {yb!r} must divide Y = {ny}")
    _lib.require_f32_contiguous("stacked", stacked, stacked.device)
    _lib.require_f32_contiguous("warp", warp, stacked.device)
    if stacked.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stack body kernel for device {stacked.device}")


def b9_geometry(shape, sms=H100_SMS) -> dict:
    """The launch ``run`` makes for (X, Y) = ``shape`` (Y a multiple of
    ``TILE_Y``): the kernel instantiation (``loop_kernel<body, loop, tile,
    voxels>``, body and loop as ``*``), its tile's y rows, voxels a thread,
    threads and dynamic shared bytes a CTA (the ring of N + B9_AHEAD slots
    of N planes' tile rows), the CTAs an SM holds, and the CTAs of its one
    wave on ``sms`` SMs (at most one a (tile, x row) step)."""
    nx, ny = shape
    threads = B9_TILE_ROWS * LANE // B9_VOXELS
    smem = (N + B9_AHEAD) * N * B9_TILE_ROWS * LANE * 4
    per_sm = min(SM_SHARED_BYTES // (smem + 1024), 2048 // threads)
    return {"kernel": f"loop_kernel<*,*,{B9_TILE_ROWS},{B9_VOXELS}>",
            "tile_rows": B9_TILE_ROWS, "voxels": B9_VOXELS, "threads": threads,
            "smem_bytes": smem, "ctas_per_sm": per_sm,
            "ctas": min(nx * (ny // B9_TILE_ROWS), sms * per_sm)}


def b9_ranges(shape, ctas, tile) -> list:
    """The (y0, x0, xn) runs of each CTA, as ``loop_kernel`` walks them: the
    (tile, x row) steps, x fastest, cut into ``ctas`` equal ranges; a run is
    a range's part in one tile, where the CTA stages x rows x0 .. x0 + xn + 4
    into a fresh ring."""
    nx, ny = shape
    steps = nx * (ny // tile)
    ranges = []
    for b in range(ctas):
        f, end, runs = b * steps // ctas, (b + 1) * steps // ctas, []
        while f < end:
            y0, x0 = f // nx * tile, f % nx
            xn = min(nx - x0, end - f)
            runs.append((y0, x0, xn))
            f += xn
        ranges.append(runs)
    return ranges


def b9_staged_bytes(shape, sms=H100_SMS) -> int:
    """The stack bytes ``loop_kernel`` stages at ``shape``: each run of
    ``b9_ranges`` stages xn + N - 1 x rows of N planes' tile rows."""
    g = b9_geometry(shape, sms)
    rows = sum(xn + N - 1 for runs in b9_ranges(shape, g["ctas"], g["tile_rows"])
               for _, _, xn in runs)
    return rows * N * g["tile_rows"] * LANE * 4


def shared_wavefronts(warp) -> np.ndarray:
    """Shared-memory wavefronts of each warp load of the ``full`` body
    (z0c's, then z1c's, of every 32-lane warp): a row starts on bank 0, so
    lane z reads bank z0c mod 32, and a load takes as many wavefronts as
    the most distinct words any bank holds (a repeated word is broadcast)."""
    uz = np.asarray(warp)[..., 2]
    z0 = np.arange(LANE) + np.floor(uz).astype(np.int64)
    loads = np.concatenate([np.clip(z0, 0, LANE - 1).reshape(-1, 32),
                            np.clip(z0 + 1, 0, LANE - 1).reshape(-1, 32)])
    words = np.sort(loads, axis=1)  # a word's repeats side by side
    first = np.ones(words.shape, bool)
    first[:, 1:] = words[:, 1:] != words[:, :-1]
    distinct = np.zeros((loads.shape[0], 32), np.int64)
    np.add.at(distinct, (np.nonzero(first)[0], words[first] % 32), 1)
    return distinct.max(axis=1)


def shared_floor_us(warp, clock_hz, sms=H100_SMS) -> float:
    """The ``full`` body's shared-memory floor: 2 loads a pair, 36 pairs, at
    ``shared_wavefronts`` each, one wavefront a cycle an SM."""
    warps = np.asarray(warp)[..., 0].size // 32
    wavefronts = float(shared_wavefronts(warp).mean()) * 2 * NBODY * warps
    return wavefronts / sms / clock_hz * 1e6


def launch(stacked, warp, body: str, loop: str) -> torch.Tensor:
    """One launch of the stack-body kernel on checked CUDA inputs; the
    callers count it."""
    lib = _library()
    nx, ny = warp.shape[:2]
    out = torch.empty((nx, ny, LANE), dtype=torch.float32, device=warp.device)
    with torch.cuda.device(warp.device):
        err = lib.lsf_stack_body(
            stacked.data_ptr(), warp.data_ptr(), out.data_ptr(), N, stacked.shape[1],
            nx, ny, LANE, BODIES.index(body), LOOPS.index(loop),
            _lib.stream_handle(warp.device),
        )
    _lib.check(err, lib.lsf_stack_bodies_error_string, f"stack body {body}/{loop} launch")
    return out


def run(stacked, warp, body_kind: str, loop_kind: str, yb: int = 64) -> torch.Tensor:
    """B9: ``body_kind`` in ``BODY_KINDS`` under ``loop_kind`` in
    ``LOOP_KINDS``. CUDA tensors run the kernel, CPU tensors the plain
    version."""
    global launch_count
    if body_kind not in BODY_KINDS:
        raise ValueError(f"body must be one of {BODY_KINDS}, got {body_kind!r}")
    if loop_kind not in LOOP_KINDS:
        raise ValueError(f"loop must be one of {LOOP_KINDS}, got {loop_kind!r}")
    check_stack_inputs(stacked, warp, yb)
    if stacked.device.type == "cpu":
        return loop_cost_reference(stacked, warp, body_kind)
    out = launch(stacked, warp, body_kind, loop_kind)
    launch_count += 1
    return out


def inputs(device, shape=SHAPE):
    """The script's inputs for (X, Y) = ``shape``, seed 0: a standard
    normal stack (6, X + 6, Y, 128), then a 1.5 N(0, 1) warp (X, Y, 128, 3)."""
    nx, ny = shape
    rng = np.random.default_rng(0)
    stacked = rng.standard_normal((N, nx + N, ny, LANE)).astype(np.float32)
    warp = (rng.standard_normal((nx, ny, LANE, 3)) * 1.5).astype(np.float32)
    return torch.from_numpy(stacked).to(device), torch.from_numpy(warp).to(device)


def parse_case(case: str):
    """(body, loop, yb) of a ``body/loop[/yb]`` case string."""
    parts = case.split("/")
    if len(parts) not in (2, 3):
        raise ValueError(f"case {case!r} is not body/loop[/yb]")
    return parts[0], parts[1], int(parts[2]) if len(parts) == 3 else 64


def main(device="cuda", cases=None, shape=SHAPE) -> list:
    """One JSON row per case: µs per call (best of 5 after a warm-up) and
    µs per TPU grid body."""
    device = resolve_device(device)
    stacked, warp = inputs(device, shape)
    nx, ny = shape
    rows = []
    for case in cases or DEFAULT_CASES:
        body, loop, yb = parse_case(case)
        us = best_ms(lambda: run(stacked, warp, body, loop, yb), device) * 1e3
        row = {"case": case, "body": body, "loop": loop, "yb": yb,
               "shape": [nx, ny, LANE], "us_per_call": us,
               "us_per_body": us / ((ny // yb) * nx * NBODY), "device": device_name(device)}
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(cases=sys.argv[1:] or None)
