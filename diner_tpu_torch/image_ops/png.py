"""8-bit PNG files on zlib: the writer and reader of the eval folders.

The port carries its own because it does not depend on an imaging package.
`write_png` writes grey (H, W), RGB (H, W, 3) or RGBA (H, W, 4) uint8 arrays
unfiltered; `read_png` reads any non-interlaced 8-bit grey, grey+alpha, RGB
or RGBA PNG, with all five row filters, into the array imageio returns for
it.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}            # colour type -> channels
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}               # channels -> colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img) -> None:
    """Write a uint8 (H, W), (H, W, 3) or (H, W, 4) array as a PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if C not in _COLOUR_TYPE:
        raise ValueError(f"cannot write {C} channels")
    header = struct.pack(">IIBBBBB", W, H, 8, _COLOUR_TYPE[C], 0, 0, 0)
    rows = np.concatenate([np.zeros((H, 1), np.uint8),   # filter 0 per row
                           np.ascontiguousarray(img).reshape(H, W * C)], 1)
    Path(path).write_bytes(_SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                           + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray,
              bpp: int) -> np.ndarray:
    """Reconstruct one row of bytes from its filtered bytes and the row
    above (zeros for the first row)."""
    if kind == 0:
        return line
    if kind == 1:    # Sub: a running sum per channel, modulo 256
        return (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                % 256).astype(np.uint8).reshape(-1)
    if kind == 2:    # Up
        return ((line.astype(np.int64) + prior) % 256).astype(np.uint8)
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG row filter {kind}")
    out = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:    # Average
            pred = (left + up[i]) // 2
        else:            # Paeth
            pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path) -> np.ndarray:
    """Read an 8-bit PNG: (H, W) for grey, else (H, W, C) uint8."""
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
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
    W, H, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey, grey+alpha,"
                         f" RGB and RGBA PNGs are read (bit depth {depth}, "
                         f"colour type {colour}, interlace {interlace})")
    C = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(H, 1 + W * C)
    rows, prior = [], np.zeros(W * C, np.uint8)
    for y in range(H):
        prior = _unfilter(int(raw[y, 0]), raw[y, 1:], prior, C)
        rows.append(prior)
    img = np.stack(rows).reshape(H, W, C)
    return img[..., 0] if C == 1 else img
