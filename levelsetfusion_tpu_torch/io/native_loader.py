"""ctypes bindings of the native depth-IO library. Twin of
``levelsetfusion_tpu/io/native_loader.py``.

``native/depth_io.cpp`` (the port's copy: zlib's inflate and the five row
filters, no libpng) is compiled with ``g++`` at first use into
``build/native/liblsf_io.so`` at the root of the checkout, again whenever
the source is newer than the library. The compiler writes into a fresh
temporary directory beside the library, which is then renamed into place,
so builders racing in several processes never load a half-written file.
The library is there wherever a C++ compiler is (``native_available``);
a build that fails where one is raises, it is not hidden.

``DepthPrefetcher`` decodes a list of PNGs in order on background threads
and yields each frame as a float32 tensor in metres, in pinned host memory
where CUDA is up, so the fusion's host-to-device copy can be
``non_blocking``. Each frame is a fresh tensor: PyTorch's pinned-memory
allocator hands a block out again only once the copies recorded from it
have completed, so no copy in flight reads a reused buffer.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

import numpy as np
import torch

from levelsetfusion_tpu_torch.io.depth import DEPTH_UNIT_M
from levelsetfusion_tpu_torch.utils.profiling import span

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = _PACKAGE / "native" / "depth_io.cpp"
BUILD_DIR = _PACKAGE.parent / "build" / "native"
LIBRARY = "liblsf_io.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
END = -100  # lsf_prefetcher_next past the last frame
STATUS = {-1: "cannot open or read the file", -2: "not a PNG, or a chunk is truncated or "
          "fails its CRC", -3: "the image is not the expected width x height",
          -4: "palette, interlaced or 1/2/4-bit PNGs are not supported",
          -5: "the image data does not inflate to the image's size",
          -6: "a row names an unknown filter type"}


def compiler() -> str | None:
    """The C++ compiler the library is built with, or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def native_available() -> bool:
    """Whether the native decoder can be used here: a C++ compiler is there
    to build it (a build that then fails raises)."""
    return compiler() is not None


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``native/depth_io.cpp`` into ``build_dir`` unless the library
    there is newer than the source; returns the library's path. The
    compiler writes into a temporary directory inside ``build_dir`` that is
    removed after the library is renamed into place (atomic)."""
    build_dir = Path(build_dir)
    lib = build_dir / LIBRARY
    if lib.exists() and lib.stat().st_mtime >= SOURCE.stat().st_mtime:
        return lib
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build the depth-IO library")
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir, prefix=".build-") as tmp:
        out = Path(tmp) / LIBRARY
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE), "-lz"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {SOURCE} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(out, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    p_int = ctypes.POINTER(ctypes.c_int)
    p_u16 = ctypes.POINTER(ctypes.c_uint16)
    lib.lsf_png_info.argtypes = [ctypes.c_char_p, p_int, p_int, p_int]
    lib.lsf_png_info.restype = ctypes.c_int
    lib.lsf_load_depth_png.argtypes = [ctypes.c_char_p, p_u16, ctypes.c_int, ctypes.c_int]
    lib.lsf_load_depth_png.restype = ctypes.c_int
    lib.lsf_prefetcher_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int]
    lib.lsf_prefetcher_create.restype = ctypes.c_void_p
    lib.lsf_prefetcher_next.argtypes = [ctypes.c_void_p, p_u16]
    lib.lsf_prefetcher_next.restype = ctypes.c_int
    lib.lsf_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.lsf_prefetcher_destroy.restype = None
    return lib


def _check(rc: int, what: str) -> None:
    if rc == -1:
        raise FileNotFoundError(f"{what}: {STATUS[-1]}")
    if rc != 0:
        raise ValueError(f"{what}: {STATUS.get(rc, f'status {rc}')}")


def png_info(path: str) -> tuple:
    """``(width, height, bit_depth)`` from the PNG's header."""
    w, h, bd = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(load().lsf_png_info(os.fsencode(path), ctypes.byref(w), ctypes.byref(h),
                               ctypes.byref(bd)), f"lsf_png_info({path})")
    return w.value, h.value, bd.value


def native_load_depth_png(path: str) -> np.ndarray:
    """The PNG's first channel as stored, uint16 (H, W), by the native
    decoder. Raises on a decode error."""
    w, h, _ = png_info(path)
    out = np.empty((h, w), np.uint16)
    _check(load().lsf_load_depth_png(os.fsencode(path),
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                                     w, h), f"lsf_load_depth_png({path})")
    return out


class DepthPrefetcher:
    """Ordered multi-threaded decode-ahead over a list of depth PNGs.

    Iterating yields float32 (H, W) tensors in metres (``raw * unit``, as
    ``io.depth.load_depth_png``), pinned where CUDA is up; frames t + 1 .. t + ``max_inflight`` decode on ``num_threads``
    threads while frame t is consumed. A decode error raises at its frame.
    The threads stop when the last frame is taken, at ``close()`` or when
    the object is collected.
    """

    def __init__(self, paths: List[str], width: int, height: int, num_threads: int = 2,
                 max_inflight: int = 4, depth_unit_m: float = DEPTH_UNIT_M):
        self._lib = load()
        self._paths = [os.fsencode(p) for p in paths]
        self._n = len(paths)
        self._shape = (height, width)
        self._unit = np.float32(depth_unit_m)
        self._pin = torch.cuda.is_available()  # pinning needs CUDA
        self._raw = np.empty(self._shape, np.uint16)
        arr = (ctypes.c_char_p * self._n)(*self._paths)
        self._handle = self._lib.lsf_prefetcher_create(arr, self._n, width, height,
                                                       num_threads, max_inflight)
        self._consumed = 0

    def __iter__(self):
        return self

    def __len__(self) -> int:
        return self._n

    def __next__(self) -> torch.Tensor:
        if self._handle is None or self._consumed >= self._n:
            self.close()
            raise StopIteration
        with span("lsf.io.prefetch_wait"):
            rc = self._lib.lsf_prefetcher_next(
                self._handle, self._raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
        if rc == END:
            self.close()
            raise StopIteration
        _check(rc, f"prefetch of {self._paths[self._consumed].decode()}")
        self._consumed += 1
        out = torch.empty(self._shape, dtype=torch.float32, pin_memory=self._pin)
        np.multiply(self._raw, self._unit, out=out.numpy(), dtype=np.float32)
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self._lib.lsf_prefetcher_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
