"""A small PNG codec for 8-bit grayscale images, on the standard library's
``zlib``.

The KITTI layout stores camera and label images as PNG files. The port
reads and writes them without an imaging library, so that every machine
runs the same code:

- :func:`write_png` writes 8-bit grayscale (colour type 0), every row with
  filter 0 (none), one IDAT chunk;
- :func:`read_png` reads 8-bit grayscale, non-interlaced, with any of the
  five row filters (none, sub, up, average, Paeth), as imaging libraries
  write them with adaptive filtering. Any other format raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an [H,W] uint8 array as an 8-bit grayscale PNG."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected an [H,W] uint8 image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape
    raw = np.zeros((h, w + 1), np.uint8)        # a 0 filter byte per row
    raw[:, 1:] = img
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth_row(raw: np.ndarray, prior: np.ndarray) -> np.ndarray:
    out = np.empty_like(raw)
    left = upleft = 0
    rw, pr = raw.tolist(), prior.tolist()
    for i in range(len(rw)):
        up = pr[i]
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        pred = left if pa <= pb and pa <= pc else (up if pb <= pc else upleft)
        left = (rw[i] + pred) & 0xFF
        out[i] = left
        upleft = up
    return out


def _average_row(raw: np.ndarray, prior: np.ndarray) -> np.ndarray:
    out = np.empty_like(raw)
    left = 0
    rw, pr = raw.tolist(), prior.tolist()
    for i in range(len(rw)):
        left = (rw[i] + ((left + pr[i]) >> 1)) & 0xFF
        out[i] = left
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit grayscale PNG into an [H,W] uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 0, 0):
        raise ValueError(f"{path}: only 8-bit grayscale non-interlaced PNG "
                         f"is supported (bit depth {depth}, colour type "
                         f"{colour}, interlace {interlace})")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, w + 1)
    out = np.empty((h, w), np.uint8)
    prior = np.zeros(w, np.uint8)
    for y in range(h):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = raw.copy()
        elif kind == 1:                              # sub
            cur = np.cumsum(raw, dtype=np.uint8)
        elif kind == 2:                              # up
            cur = raw + prior
        elif kind == 3:
            cur = _average_row(raw, prior)
        elif kind == 4:
            cur = _paeth_row(raw, prior)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        out[y] = cur
        prior = cur
    return out
