"""Variants of a kernel source made by text substitution, as the sweeps
(``fused_gradient_sweep``, ``resample_sweep``, ``stack_bodies_sweep``,
``loop_cost_sweep``) build them: each anchor must occur exactly once in the
source, so a variant built on the card is the one its name says; and what
the compiler made of a kernel (``ptxas``, ``sass_per_voxel``), which
``chip_smoke.py`` prints too. GPU only at build time (nvcc)."""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import torch

from levelsetfusion_tpu_torch.ops.kernels import _lib


def substituted(source: Path, subs, name: str, inline=()) -> str:
    """``source``'s text with each header of ``inline`` (a file beside it)
    pasted in place of its ``#include``, so that anchors may lie in the
    header, and each ``(old, new)`` of ``subs`` applied."""
    text = source.read_text()
    for header in inline:
        include = f'#include "{header}"'
        if text.count(include) != 1:
            raise ValueError(f"{name}: {include} found {text.count(include)} times")
        text = text.replace(include, (source.parent / header).read_text().replace(
            "#pragma once\n", ""))
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{name}: anchor found {text.count(old)} times: {old!r}")
        text = text.replace(old, new)
    return text


# A sweep variant's substitutions in resample_z.cuh (inlined): pair_sum
# loading pair t + 1's table entry and its two shared values before it sums
# pair t (the table's pair 36 is a copy of pair 0).
PAIR_PREFETCH = [
    ("#pragma unroll 1\n  for (int t = 0; t < kN * kN; ++t) {\n"
     "    const int4 q = *reinterpret_cast<const int4*>(&pairs[t]);  // row, fx, fy, pad0\n"
     "    const unsigned off = (unsigned)q.x * kRowBytes;\n"
     "    const float g = zmix(zs, ld_shared(a0 + off), ld_shared(a1 + off));\n",
     "  int4 q = *reinterpret_cast<const int4*>(&pairs[0]);\n"
     "  float r0 = ld_shared(a0 + (unsigned)q.x * kRowBytes);\n"
     "  float r1 = ld_shared(a1 + (unsigned)q.x * kRowBytes);\n"
     "#pragma unroll 1\n  for (int t = 0; t < kN * kN; ++t) {\n"
     "    const int4 qn = *reinterpret_cast<const int4*>(&pairs[t + 1]);\n"
     "    const float r0n = ld_shared(a0 + (unsigned)qn.x * kRowBytes);\n"
     "    const float r1n = ld_shared(a1 + (unsigned)qn.x * kRowBytes);\n"
     "    const float g = zmix(zs, r0, r1);\n"),
    ("      acc = __fadd_rn(acc, g);\n    }\n  }\n",
     "      acc = __fadd_rn(acc, g);\n    }\n    q = qn, r0 = r0n, r1 = r1n;\n  }\n"),
]


def build(text: str, stem: str, build_dir: Path) -> tuple:
    """Compile ``text`` into ``build_dir/lib<stem>.so``, from a file beside
    the package's sources (it may include their headers); returns the
    library's path and nvcc's ``-Xptxas -v`` report."""
    build_dir.mkdir(parents=True, exist_ok=True)
    src = _lib.SOURCE_DIR / f".sweep_{stem}.cu"
    lib = build_dir / f"lib{stem}.so"
    src.write_text(text)
    try:
        proc = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(lib), str(src)],
                              capture_output=True, text=True)
    finally:
        src.unlink()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {stem}:\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def kernel_name(mangled: str) -> str:
    """``name<template ints>`` (or ``<uint32_t>``, ``<uint64_t>``) of a
    kernel in an anonymous namespace, from its mangled name
    (``_ZN<len><namespace><len><name>I...E...``)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name, tail = rest[m.end():m.end() + int(m.group(1))], rest[m.end() + int(m.group(1)):]
    args = re.findall(r"L[ib](\d+)E", tail.split("EEv")[0]) if tail.startswith("I") else []
    offset = re.match(r"I([jm])E", tail)  # resample.cu's offset type
    if offset:
        args = ["uint32_t" if offset.group(1) == "j" else "uint64_t"]
    return f"{name}<{','.join(args)}>" if args else name


def ptxas(log: str) -> dict:
    """``{mangled: (registers, spill bytes, stack frame bytes, static shared
    bytes)}`` for each kernel of an ``-Xptxas -v`` report (``None`` where
    the report gives no register count)."""
    found = {}
    for entry in log.split("Compiling entry function '")[1:]:
        used = re.search(r"Used (\d+) registers", entry)
        spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", entry))
        stack = re.search(r"(\d+) bytes stack frame", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        found[entry.split("'", 1)[0]] = (int(used.group(1)) if used else None, spill,
                                          int(stack.group(1)) if stack else 0,
                                          int(smem.group(1)) if smem else 0)
    return found


def registers(log: str, key) -> dict:
    """``{key(mangled): "<registers>r/<spill bytes>B/<stack frame bytes>B"}``
    for each kernel of an ``-Xptxas -v`` report for which ``key`` returns a
    name."""
    regs = {}
    for mangled, (used, spill, stack, _) in ptxas(log).items():
        name = key(mangled)
        if name:
            regs[name] = f"{used if used is not None else '?'}r/{spill}B/{stack}B"
    return regs


PAIRS = 36  # a voxel's pairs: each runtime pair loop runs once per pair


def sass_per_voxel(library: Path, names, loops=None) -> dict:
    """For each kernel of ``library`` named in ``names`` (as ``kernel_name``
    gives them), from ``cuobjdump -sass``: the SASS instructions a voxel
    runs and its local-memory loads and stores (LDL, STL), counting the code
    between the step's first and last barrier once and its pair loop (the
    innermost loop with shared loads, if any) ``PAIRS`` times, and the pair
    loop's size and shared loads. ``loops`` maps a name to (trips, voxels)
    where its loop runs another number of times for ``voxels`` voxels at
    once (B5's chunk: 6 cy steps for two voxels); the counts are then per
    voxel. Where a loop holds a block that runs at a new cy only, it is
    counted every pair. Instructions predicated off (``@!PT``, nvcc's
    padding) are not counted. ``{}`` without cuobjdump."""
    tool = shutil.which("cuobjdump") or str(Path(_lib._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    found = {}
    for chunk in sass.split("Function : ")[1:]:
        name = kernel_name(chunk.split()[0])
        if name not in names:
            continue
        code = []  # (address, instruction)
        for line in chunk.splitlines():
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if ins and not ins.group(2).startswith("@!PT"):
                code.append((int(ins.group(1), 16), ins.group(2).strip()))
        bars = [a for a, text in code if text.startswith("BAR.SYNC")]
        if len(bars) < 2:
            found[name] = {"error": "barriers not found"}
            continue
        step = [(a, text) for a, text in code if bars[0] < a < bars[-1]]
        found_loops = []  # (instructions, shared loads, first address, last address)
        for addr, text in step:
            target = re.search(r"BRA\s+(?:`\()?(0x[0-9a-f]+)", text)
            if target and int(target.group(1), 16) < addr:
                first = int(target.group(1), 16)
                body = [t for a, t in step if first <= a <= addr]
                lds = sum(1 for t in body if re.search(r"\bLDS\b", t))
                if lds:
                    found_loops.append((len(body), lds, first, addr))
        loop = min(found_loops) if found_loops else None  # the pair loop, innermost
        trips, voxels = (loops or {}).get(name, (PAIRS, 1))

        def per_voxel(pattern):
            hits = [a for a, t in step if re.search(pattern, t)]
            inside = sum(1 for a in hits if loop and loop[2] <= a <= loop[3])
            return (len(hits) + inside * (trips - 1)) / voxels

        found[name] = {
            "instructions": (len(step) + (loop[0] * (trips - 1) if loop else 0)) / voxels,
            "pair_loop": loop[0] if loop else None,
            "pair_loop_lds": loop[1] if loop else None,
            "ldl": per_voxel(r"\bLDL\b"), "stl": per_voxel(r"\bSTL\b"),
        }
    return found


def kernel_us(call, n=20) -> dict:
    """Device µs per call of each kernel that ``call`` launches, from
    ``torch.profiler`` over ``n`` calls after a warm-up: the kernels' own
    time, whatever the host takes to enqueue them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / n
    return {k: round(v, 1) for k, v in out.items()}
