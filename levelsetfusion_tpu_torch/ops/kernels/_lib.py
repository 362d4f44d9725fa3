"""Build and load the port's CUDA kernels.

Each kernel family is one CUDA C++ file in ``levelsetfusion_tpu_torch/csrc``
with a plain C interface. At first use it is compiled with ``nvcc`` for
``sm_90a`` into ``build/kernels/lib<name>.so`` at the root of the checkout
(again whenever the source or a ``csrc/*.cuh`` header is newer than the
library) and loaded with
``ctypes``. Nothing here runs at import time; machines without ``nvcc``
never reach it, because the wrappers take their plain versions for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PACKAGE = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def is_stale(lib: Path, src: Path) -> bool:
    """Whether ``lib`` must be rebuilt from ``src``: it is missing, or older
    than ``src`` or than any ``*.cuh`` header beside ``src`` (a source may
    include any of them)."""
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(p.stat().st_mtime > built for p in (src, *src.parent.glob("*.cuh")))


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is up to date; returns
    the library's path. The compiler's report (registers, spills) is kept
    beside it as ``lib<name>.log``."""
    src = SOURCE_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    if not is_stale(lib, src):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src} (exit {proc.returncode}):\n{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name)))


def check(err: int, error_string, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: {error_string(err).decode()}")


def stream_handle(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def capturing() -> bool:
    """Whether the current CUDA stream is being captured into a CUDA graph:
    a kernel enqueued now is recorded, not launched."""
    return torch.cuda.is_current_stream_capturing()


def require_flag(active, device: torch.device) -> None:
    """The contract of the solve loop's ``active`` flag: None, or a 0-d
    bool tensor on ``device`` (the kernels read it as one byte)."""
    if active is None:
        return
    if active.dtype != torch.bool or active.ndim != 0:
        raise TypeError(f"active must be a 0-d bool tensor, got {active.dtype} "
                        f"{tuple(active.shape)}")
    if active.device != device:
        raise ValueError(f"active is on {active.device}, expected {device}")


def flag_ptr(active) -> int | None:
    """The device pointer the kernels read the flag from (None: always on)."""
    return None if active is None else active.data_ptr()


def require_f32_contiguous(name: str, t: torch.Tensor, device: torch.device) -> None:
    """The wrappers' input contract: float32, contiguous, on one device."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
