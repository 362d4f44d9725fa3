"""Variants of a kernel source made by text substitution, as the sweeps
(``fused_gradient_sweep``, ``resample_sweep``) build them: each anchor must
occur exactly once in the source, so a variant built on the card is the one
its name says. GPU only at build time (nvcc)."""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

import torch

from levelsetfusion_tpu_torch.ops.kernels import _lib


def substituted(source: Path, subs, name: str) -> str:
    """``source``'s text with each ``(old, new)`` of ``subs`` applied."""
    text = source.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{name}: anchor found {text.count(old)} times: {old!r}")
        text = text.replace(old, new)
    return text


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


def registers(log: str, key) -> dict:
    """``{key(mangled): "<registers>r/<spill bytes>B"}`` for each kernel of
    an ``-Xptxas -v`` report for which ``key`` returns a name."""
    regs = {}
    for entry in log.split("Compiling entry function '")[1:]:
        name = key(entry.split("'", 1)[0])
        if name:
            used = re.search(r"Used (\d+) registers", entry)
            spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", entry))
            regs[name] = f"{used.group(1) if used else '?'}r/{spill}B"
    return regs


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
