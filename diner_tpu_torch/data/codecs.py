"""On-disk formats of the dataset trees (port of diner_tpu.data.codecs).

- uint16 depth and confidence PNGs at DEPTH_SCALE_FACTOR = 1e-4 m per unit,
  through the port's own PNG codec (image_ops/png.py), which decodes 16-bit
  grey exactly whatever imaging package is installed;
- PFM depth maps (bottom-up rows);
- MVSNet camera text files: extrinsics 4x4, intrinsics 3x3, depth bounds;
- Gipuma's .dmb maps and camera files, the fusibile inputs.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from diner_tpu_torch.image_ops.png import read_png, write_png

DEPTH_SCALE_FACTOR = 1e-4  # meters per uint16 unit


def read_png16(path):
    """Read a grey PNG (8- or 16-bit) -> uint16 (H, W)."""
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: expected a grey PNG, got shape {img.shape}")
    return img.astype(np.uint16)


def write_png16(path, img_u16):
    """Write uint16 (H, W) as a 16-bit grey PNG."""
    write_png(path, np.asarray(img_u16, np.uint16))


def write_depth_png(path, depth_m):
    """Write metric depth (H, W) [m] as a uint16 PNG (1e-4 m units)."""
    q = np.clip(np.asarray(depth_m, np.float64) / DEPTH_SCALE_FACTOR,
                0, np.iinfo(np.uint16).max)
    write_png16(path, q.astype(np.uint16))


def read_depth_png(path):
    """Read a uint16 depth PNG -> float32 meters (0 = invalid)."""
    return read_png16(path).astype(np.float32) * DEPTH_SCALE_FACTOR


def write_pfm(path, data, scale: float = 1.0):
    """Write (H, W) or (H, W, 3) float32 PFM (bottom-up row order)."""
    data = np.asarray(data, np.float32)
    color = data.ndim == 3 and data.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        endian = data.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(data).tofile(f)


def read_pfm(path):
    """Read PFM -> (data float32 (H, W[, 3]), scale)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"malformed PFM header: {path}")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        fmt = "<f" if scale < 0 else ">f"
        data = np.fromfile(f, fmt)
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).astype(np.float32), abs(scale)


def read_mvsnet_cam(path):
    """Parse an MVSNet cam txt: 'extrinsic' 4x4, 'intrinsic' 3x3, then the
    bounds line. Returns (extrinsics (4,4), intrinsics (3,3),
    (depth_min, depth_interval))."""
    lines = [ln.strip() for ln in Path(path).read_text().splitlines()
             if ln.strip()]
    i_ext = lines.index("extrinsic") + 1
    ext = np.array([[float(v) for v in lines[i_ext + r].split()]
                    for r in range(4)], np.float32)
    i_int = lines.index("intrinsic") + 1
    K = np.array([[float(v) for v in lines[i_int + r].split()]
                  for r in range(3)], np.float32)
    bounds = tuple(float(v) for v in lines[i_int + 3].split()[:2])
    return ext, K, bounds


def write_mvsnet_cam(path, extrinsics, intrinsics, depth_min: float,
                     depth_interval: float):
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in np.asarray(extrinsics, np.float64):
            f.write(" ".join(f"{v:.8f}" for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in np.asarray(intrinsics, np.float64):
            f.write(" ".join(f"{v:.8f}" for v in row) + "\n")
        f.write(f"\n{depth_min} {depth_interval}\n")


def nearest_resize(img, h, w):
    """Integer nearest resize by index striding (the floor convention of
    the DTU and MultiFace readers)."""
    ys = (np.arange(h) * (img.shape[0] / h)).astype(np.int64)
    xs = (np.arange(w) * (img.shape[1] / w)).astype(np.int64)
    return img[ys][:, xs]


def write_dmb(path, image):
    """Write a Gipuma .dmb map (fusibile's input): an int32 header [type 1,
    height, width, channels], then float32 data, column-major per
    channel."""
    import struct

    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", 1, h, w, c))
        np.transpose(image, (2, 0, 1)).astype(np.float32).tofile(f)


def read_dmb(path):
    """Read a Gipuma .dmb map -> (H, W) or (H, W, C) float32."""
    import struct

    with open(path, "rb") as f:
        _, h, w, c = struct.unpack("<iiii", f.read(16))
        data = np.fromfile(f, np.float32)
    arr = data.reshape((w, h, c), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()


def fake_gipuma_normals(depth):
    """Camera-facing unit normals (1, 1, 1)/sqrt(3) where depth > 0, zeros
    elsewhere: (H, W, 3) float32."""
    depth = np.asarray(depth)
    n = np.ones((*depth.shape, 3), np.float32) / 1.732050808
    return n * (depth > 0)[..., None]


def write_gipuma_cam(path, extrinsics, intrinsics):
    """Write fusibile's camera file: the 3x4 projection P = K @ [R|t]."""
    K = np.asarray(intrinsics, np.float64)
    ext = np.asarray(extrinsics, np.float64)
    P = K @ ext[:3, :4]
    with open(path, "w") as f:
        for row in P:
            f.write(" ".join(f"{v:.8f}" for v in row) + "\n")
        f.write("\n")
