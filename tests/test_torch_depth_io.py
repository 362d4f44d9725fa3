"""The port's depth-PNG IO (io/depth.py, io/native_loader.py,
native/depth_io.cpp) against JAX's.

JAX writes its PNGs with cv2 and reads them with cv2 where its native
library is absent; these tests write with JAX's ``save_depth_png`` (cv2
only) and read with ``cv2.imread(..., IMREAD_UNCHANGED)``, JAX's fallback,
never through JAX's native loader (its build is not atomic). Every decode is
held to exact equality: the stored values are integers."""

import os
import threading
import zlib

import cv2
import numpy as np
import pytest
import torch

from levelsetfusion_tpu.io import depth as jdepth
from levelsetfusion_tpu_torch.io import depth, native_loader


def _jax_pngs(tmp_path, n=3, h=24, w=32):
    """PNGs written by JAX's save_depth_png, with 0, 65535 and clipped
    pixels, and their paths."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        d = rng.uniform(0.2, 3.0, (h, w)).astype(np.float32) * (i + 1)
        d[0, 0], d[1, 1], d[2, 2], d[3, 3] = 0.0, 65.535, 100.0, -1.0
        p = str(tmp_path / f"depth_{i:06d}.png")
        jdepth.save_depth_png(p, d)
        paths.append(p)
    return paths


@pytest.mark.parametrize("decoder", depth.DECODERS)
def test_reader_equals_cv2_on_jax_pngs(tmp_path, decoder):
    for p in _jax_pngs(tmp_path):
        want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        got = depth.read_png(p, decoder)
        assert got.dtype == np.uint16 and want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
        assert got.min() == 0 and got.max() == 65535
        # JAX's metres: raw.astype(f32) * unit, bit for bit.
        np.testing.assert_array_equal(depth.load_depth_png(p, decoder=decoder),
                                      want.astype(np.float32) * 0.001)


def test_cv2_reads_port_pngs(tmp_path):
    rng = np.random.default_rng(1)
    d = rng.uniform(0.0, 70.0, (17, 23)).astype(np.float32)
    d[0, :3] = (0.0, 65.535, 90.0)
    p = str(tmp_path / "port.png")
    depth.save_depth_png(p, d)
    want = np.clip(np.round(d / 0.001), 0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), want)
    jp = str(tmp_path / "jax.png")
    jdepth.save_depth_png(jp, d)
    np.testing.assert_array_equal(cv2.imread(jp, cv2.IMREAD_UNCHANGED), want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(pixels: np.ndarray, bit_depth: int, colour: int, interlace: int = 0,
                  header_depth: int | None = None) -> bytes:
    """A PNG of ``pixels`` (H, W, channels) whose rows cycle through the five
    filter types (row y takes filter y % 5); ``header_depth`` overrides the
    bit depth its header states."""
    h, w, _ = pixels.shape
    raw = pixels.astype(">u2" if bit_depth == 16 else np.uint8).view(np.uint8).reshape(h, -1)
    bpp = raw.shape[1] // w
    out, prev = bytearray(), np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        cur = raw[y].astype(np.int64)
        kind = y % 5
        enc = []
        for i in range(len(cur)):
            left = cur[i - bpp] if i >= bpp else 0
            upleft = prev[i - bpp] if i >= bpp else 0
            pred = (0, left, prev[i], (left + prev[i]) >> 1, _paeth(left, prev[i], upleft))[kind]
            enc.append((cur[i] - pred) & 0xFF)
        out += bytes([kind, *enc])
        prev = cur

    def chunk(kind, data):
        return (len(data).to_bytes(4, "big") + kind + data
                + (zlib.crc32(kind + data) & 0xFFFFFFFF).to_bytes(4, "big"))

    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([header_depth or bit_depth, colour, 0, 0, interlace]))
    return (depth.PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(out))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("bit_depth,colour,channels", [
    (16, 0, 1), (8, 0, 1), (16, 2, 3), (8, 2, 3), (16, 4, 2), (8, 6, 4)])
def test_every_row_filter_both_decoders(tmp_path, bit_depth, colour, channels):
    """All five filters, at each accepted bit depth and colour type: the
    first channel as stored (8-bit widened), from both decoders; cv2 agrees
    on greyscale."""
    rng = np.random.default_rng(bit_depth * 10 + colour)
    top = 65536 if bit_depth == 16 else 256
    pixels = rng.integers(0, top, (11, 13, channels))
    pixels[0, 0, 0], pixels[1, 1, 0] = 0, top - 1
    p = tmp_path / f"f{bit_depth}_{colour}.png"
    p.write_bytes(_filtered_png(pixels, bit_depth, colour))
    want = pixels[..., 0].astype(np.uint16)
    native, plain = depth.read_png(p, "native"), depth.read_png(p, "plain")
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(plain, want)
    if colour == 0:
        np.testing.assert_array_equal(cv2.imread(str(p), cv2.IMREAD_UNCHANGED), want)


@pytest.mark.parametrize("decoder", depth.DECODERS)
@pytest.mark.parametrize("case", ["palette", "interlaced", "four_bit", "bad_crc", "not_png"])
def test_unsupported_pngs_raise(tmp_path, decoder, case):
    pixels = np.zeros((4, 4, 1), np.int64)
    data = {
        "palette": lambda: _filtered_png(pixels, 8, 3),
        "interlaced": lambda: _filtered_png(pixels, 16, 0, interlace=1),
        "four_bit": lambda: _filtered_png(pixels, 8, 0, header_depth=4),
        "bad_crc": lambda: _filtered_png(pixels, 16, 0)[:-5] + b"\x00\x00\x00\x00\x00",
        "not_png": lambda: b"GIF89a" + bytes(40),
    }[case]()
    p = tmp_path / f"{case}.png"
    p.write_bytes(data)
    with pytest.raises(ValueError, match="not supported|CRC|not a PNG|truncated"):
        depth.read_png(p, decoder)


def test_missing_file_raises(tmp_path):
    for decoder in depth.DECODERS:
        with pytest.raises(FileNotFoundError):
            depth.read_png(tmp_path / "none.png", decoder)
    with pytest.raises(ValueError, match="unknown decoder"):
        depth.read_png(tmp_path / "none.png", "cv2")


def test_prefetcher_keeps_order_pins_and_raises(tmp_path):
    paths = _jax_pngs(tmp_path, n=6, h=12, w=16)
    pf = native_loader.DepthPrefetcher(paths, width=16, height=12, num_threads=3,
                                       max_inflight=2)
    assert len(pf) == 6
    frames = list(pf)
    assert len(frames) == 6
    for p, frame in zip(paths, frames):
        assert frame.dtype == torch.float32 and frame.shape == (12, 16)
        # Pinned wherever CUDA is up (the card); pinning needs CUDA.
        assert frame.is_pinned() == torch.cuda.is_available()
        np.testing.assert_array_equal(
            frame.numpy(), cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.float32) * 0.001)
    with pytest.raises(StopIteration):
        next(pf)
    broken = [paths[0], str(tmp_path / "missing.png"), paths[1]]
    with native_loader.DepthPrefetcher(broken, width=16, height=12) as pf:
        first = next(pf)
        np.testing.assert_array_equal(first.numpy(), frames[0].numpy())
        with pytest.raises(FileNotFoundError, match="missing.png"):
            next(pf)
    wrong_size = native_loader.DepthPrefetcher(paths[:1], width=8, height=12)
    with pytest.raises(ValueError, match="width x height"):
        next(wrong_size)
    wrong_size.close()


def test_build_is_atomic(tmp_path):
    """The library is compiled in a temporary directory and renamed into
    place: four builders racing on one directory all load a whole library,
    and no temporary directory is left behind; a library older than the
    source is rebuilt."""
    import ctypes

    out = tmp_path / "native"
    libs, errors = [], []

    def builder():
        try:
            libs.append(ctypes.CDLL(str(native_loader.build(out))))
        except Exception as err:  # noqa: BLE001 -- reported below
            errors.append(err)

    threads = [threading.Thread(target=builder) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errors and len(libs) == 4 and not any(th.is_alive() for th in threads)
    assert sorted(os.listdir(out)) == [native_loader.LIBRARY]
    lib = out / native_loader.LIBRARY
    old = native_loader.SOURCE.stat().st_mtime - 10
    os.utime(lib, (old, old))
    assert native_loader.build(out) == lib and lib.stat().st_mtime > old
