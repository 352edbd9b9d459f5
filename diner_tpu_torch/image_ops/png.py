"""8- and 16-bit PNG files on zlib: the eval folders' images and the
datasets' uint16 depth and confidence maps.

The port carries its own codec because it does not depend on an imaging
package, and because 16-bit grey decoding must be exact whatever the
installed imaging package does with it. `write_png` writes grey (H, W), RGB
(H, W, 3) or RGBA (H, W, 4) arrays of uint8 or uint16 unfiltered (16-bit
samples big-endian, as PNG stores them); `read_png` reads any non-interlaced
8- or 16-bit grey, grey+alpha, RGB or RGBA PNG, with all five row filters,
into the array imageio returns for it (uint8, or uint16 for 16-bit files).
zlib inflates the rows; a small C++ library, `csrc/png_unfilter.cpp`,
undoes their filters, built by the C++ compiler at the first read.
"""

from __future__ import annotations

import ctypes
import struct
import threading
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
    """Write a uint8 or uint16 (H, W), (H, W, 3) or (H, W, 4) array as a
    PNG of that bit depth."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"expected uint8 or uint16 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if C not in _COLOUR_TYPE:
        raise ValueError(f"cannot write {C} channels")
    depth = 8 * img.dtype.itemsize
    header = struct.pack(">IIBBBBB", W, H, depth, _COLOUR_TYPE[C], 0, 0, 0)
    data = np.ascontiguousarray(img, img.dtype.newbyteorder(">"))
    rows = np.concatenate([np.zeros((H, 1), np.uint8),   # filter 0 per row
                           data.view(np.uint8).reshape(H, -1)], 1)
    Path(path).write_bytes(_SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                           + _chunk(b"IEND", b""))


_UNFILTER = None
_UNFILTER_LOCK = threading.Lock()


def _unfilter():
    """The row defilter of csrc/png_unfilter.cpp, built at its first use."""
    global _UNFILTER
    with _UNFILTER_LOCK:
        if _UNFILTER is None:
            from diner_tpu_torch.kernels.build import host_library

            fn = ctypes.CDLL(str(host_library("png_unfilter"))).png_unfilter
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int64
            _UNFILTER = fn
    return _UNFILTER


def read_png(path) -> np.ndarray:
    """Read an 8- or 16-bit PNG: (H, W) for grey, else (H, W, C); uint8, or
    uint16 for a 16-bit file."""
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
    if depth not in (8, 16) or colour not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8- and 16-bit non-interlaced grey, "
                         f"grey+alpha, RGB and RGBA PNGs are read (bit depth "
                         f"{depth}, colour type {colour}, interlace "
                         f"{interlace})")
    C = _CHANNELS[colour]
    bpp = C * depth // 8     # bytes per pixel, the filters' left distance
    raw, stride = zlib.decompress(b"".join(idat)), W * bpp
    if len(raw) != H * (1 + stride):
        raise ValueError(f"{path}: {len(raw)} bytes of rows, expected "
                         f"{H * (1 + stride)}")
    img = np.empty((H, stride), np.uint8)
    bad = _unfilter()(raw, H, stride, bpp, img.ctypes.data)
    if bad:
        raise ValueError(f"{path}: unknown PNG row filter "
                         f"{raw[(bad - 1) * (1 + stride)]} in row {bad - 1}")
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(H, W, C)
    return img[..., 0] if C == 1 else img
