"""Depth image IO. Twin of ``levelsetfusion_tpu/io/depth.py``: 16-bit depth
PNGs (millimetres) to and from float32 metres.

The stored value is ``clip(round(d / unit), 0, 65535)`` as uint16, and 0
stays 0 (an invalid pixel). Reading goes through the native decoder of
``io/native_loader.py`` (``native/depth_io.cpp``, zlib's inflate and the
five row filters) when a C++ compiler is there to build it; the plain
codec below, numpy and the standard library's ``zlib``, is the other path,
taken when the caller asks for it (``decoder="plain"``) or when no compiler
is there. A native decode error is raised, never hidden behind the plain
path. The plain codec writes greyscale at bit depth 16 (filter 0, one
IDAT) and reads greyscale, grey + alpha, RGB and RGBA at bit depth 8 or 16,
non-interlaced; a colour image is read as its first channel, as JAX's
native decoder reads it (its cv2 fallback takes cv2's first, the blue).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

DEPTH_UNIT_M = 0.001  # Kinect-style: 16-bit PNG values are millimetres.

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
DECODERS = ("native", "plain")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png16(raw: np.ndarray) -> bytes:
    """A 16-bit greyscale PNG of the uint16 image ``raw`` (H, W): IHDR, one
    IDAT of big-endian rows each with filter byte 0, IEND."""
    raw = np.asarray(raw)
    if raw.ndim != 2 or raw.dtype != np.uint16:
        raise ValueError(f"need a 2-D uint16 image, got {raw.dtype} {raw.shape}")
    h, w = raw.shape
    rows = np.zeros((h, 1 + 2 * w), np.uint8)
    rows[:, 1:] = raw.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _chunks(data: bytes, name: str):
    """(kind, payload) of each chunk, CRCs checked, up to IEND."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: chunk {kind!r} is truncated or fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: no IEND chunk")


def _unfilter(filtered: np.ndarray, h: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """The image bytes (H, stride) from the filtered rows (H, 1 + stride):
    None, Sub, Up, Average and Paeth, each row against the row above."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind = int(filtered[y, 0])
        cur = filtered[y, 1:].astype(np.int32)
        if kind == 1:  # Sub: a running sum along each of the bpp byte lanes
            lanes = np.zeros(-(-stride // bpp) * bpp, np.int32)
            lanes[:stride] = cur
            cur = (np.cumsum(lanes.reshape(-1, bpp), axis=0) & 0xFF).reshape(-1)[:stride]
        elif kind == 2:  # Up
            cur = (cur + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour's result
            line, up = cur.tolist(), prev.tolist()
            for i in range(stride):
                left = line[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    upleft = up[i - bpp] if i >= bpp else 0
                    p = left + up[i] - upleft
                    pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - upleft)
                    pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else upleft)
                line[i] = (line[i] + pred) & 0xFF
            cur = np.asarray(line, np.int32)
        elif kind != 0:
            raise ValueError(f"{name}: row {y} has unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """The first channel of a PNG as uint16 (H, W): 16-bit samples as they
    are stored, 8-bit ones widened. Palette, interlaced and 1/2/4-bit images
    raise ``ValueError``."""
    header, idat = None, []
    for kind, payload in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"{name}: colour type {colour} is not supported "
                         "(greyscale, grey + alpha, RGB or RGBA only)")
    if depth not in (8, 16):
        raise ValueError(f"{name}: bit depth {depth} is not supported (8 or 16 only)")
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not supported")
    sample = depth // 8
    bpp = _CHANNELS[colour] * sample
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + stride):
        raise ValueError(f"{name}: image data holds {len(raw)} bytes, "
                         f"expected {h * (1 + stride)}")
    pixels = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + stride), h, stride, bpp,
                       name).reshape(h, w, bpp)
    if sample == 2:
        return (pixels[..., 0].astype(np.uint16) << 8) | pixels[..., 1]
    return pixels[..., 0].astype(np.uint16)


def read_png(path: str | os.PathLike, decoder: str | None = None) -> np.ndarray:
    """The stored uint16 image of the PNG at ``path`` (see ``decode_png``),
    decoded by ``decoder``: ``"native"``, ``"plain"``, or None for the
    native one wherever it can be built (``native_loader.native_available``)."""
    from levelsetfusion_tpu_torch.io import native_loader

    if decoder is None:
        decoder = "native" if native_loader.native_available() else "plain"
    if decoder == "native":
        return native_loader.native_load_depth_png(os.fspath(path))
    if decoder != "plain":
        raise ValueError(f"unknown decoder {decoder!r}; expected one of {DECODERS}")
    with open(path, "rb") as f:
        return decode_png(f.read(), os.fspath(path))


def load_depth_png(path: str | os.PathLike, depth_unit_m: float = DEPTH_UNIT_M,
                   decoder: str | None = None) -> np.ndarray:
    """Load a 16-bit depth PNG as float32 metres (0 stays 0 = invalid):
    JAX's ``raw.astype(f32) * unit``."""
    return read_png(path, decoder).astype(np.float32) * np.float32(depth_unit_m)


def save_depth_png(path: str | os.PathLike, depth_m: np.ndarray,
                   depth_unit_m: float = DEPTH_UNIT_M) -> None:
    """Save float32 metres as a 16-bit greyscale depth PNG, JAX's
    ``clip(round(d / unit), 0, 65535)`` as uint16."""
    mm = np.clip(np.round(np.asarray(depth_m) / depth_unit_m), 0, 65535).astype(np.uint16)
    data = encode_png16(mm)
    with open(path, "wb") as f:
        f.write(data)
