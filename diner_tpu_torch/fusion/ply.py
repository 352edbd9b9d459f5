"""Binary PLY IO (port of diner_tpu.fusion.ply): point clouds written by
the host C++ writer `csrc/ply_writer.cpp` (built at its first use into
`build/diner_tpu_torch/`, loaded by ctypes) or by the Python writer beside
it, byte for byte the same; readers for our own clouds and for triangle
meshes (ascii or binary_little_endian). Vertices are x/y/z float32, then
optionally nx/ny/nz float32 and red/green/blue uchar.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

_WRITER = None
_WRITER_LOCK = threading.Lock()


def _native_writer():
    """write_ply_binary of csrc/ply_writer.cpp, built at its first use."""
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None:
            from diner_tpu_torch.kernels.build import host_library

            fn = ctypes.CDLL(str(host_library("ply_writer"))).write_ply_binary
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                           ctypes.POINTER(ctypes.c_float),
                           ctypes.POINTER(ctypes.c_uint8),
                           ctypes.POINTER(ctypes.c_float)]
            _WRITER = fn
    return _WRITER


def _ptr(a, ctype):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctype))


def write_ply(path, points, colors=None, normals=None,
              use_native: bool = True):
    """Write a binary little-endian PLY point cloud. points (N, 3) float;
    colors (N, 3) uint8, or floats in [0, 1]; normals (N, 3) float.
    use_native: the C++ writer (it raises if it cannot be built or fails),
    else the Python one."""
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        colors = np.ascontiguousarray(colors)
    if normals is not None:
        normals = np.ascontiguousarray(normals, np.float32)

    if use_native:
        rc = _native_writer()(str(path).encode(), n,
                              _ptr(points, ctypes.c_float),
                              _ptr(colors, ctypes.c_uint8),
                              _ptr(normals, ctypes.c_float))
        if rc != 0:
            raise IOError(f"the C++ PLY writer failed with code {rc}")
        return Path(path)

    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write(b"property float nx\nproperty float ny\n"
                    b"property float nz\n")
        if colors is not None:
            f.write(b"property uchar red\nproperty uchar green\n"
                    b"property uchar blue\n")
        f.write(b"end_header\n")
        rec = np.dtype([("xyz", np.float32, 3)]
                       + ([("n", np.float32, 3)] if normals is not None else [])
                       + ([("c", np.uint8, 3)] if colors is not None else []))
        arr = np.empty(n, rec)
        arr["xyz"] = points
        if normals is not None:
            arr["n"] = normals
        if colors is not None:
            arr["c"] = colors
        arr.tofile(f)
    return Path(path)


def read_ply(path):
    """Read a binary PLY point cloud of `write_ply`'s layout -> {"points",
    and "normals" and "colors" when present}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = f.readline().strip()
        assert b"binary_little_endian" in fmt, fmt
        n = 0
        props = []
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            elif line.startswith(b"property"):
                _, typ, name = line.split()
                props.append((name.decode(),
                              np.float32 if typ == b"float" else np.uint8))
            elif line == b"end_header":
                break
        rec = np.dtype(props)
        data = np.fromfile(f, rec, n)
    out = {"points": np.stack([data["x"], data["y"], data["z"]], -1)}
    if "nx" in data.dtype.names:
        out["normals"] = np.stack([data["nx"], data["ny"], data["nz"]], -1)
    if "red" in data.dtype.names:
        out["colors"] = np.stack([data["red"], data["green"], data["blue"]], -1)
    return out


def read_ply_mesh(path):
    """Read a triangle-mesh PLY (ascii or binary_little_endian), the raw
    FaceScape scans' format -> (vertices (N, 3) float32, faces (M, 3)
    int32); a face of more than 3 indices is fan-triangulated."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = f.readline().split()[1]
        elements = []  # (name, count, [(prop_name, type_str)])
        while True:
            line = f.readline().strip()
            if line.startswith(b"element"):
                _, name, cnt = line.split()
                elements.append([name.decode(), int(cnt), []])
            elif line.startswith(b"property"):
                parts = line.split()
                if parts[1] == b"list":
                    elements[-1][2].append(("__list__", (parts[2].decode(),
                                                         parts[3].decode())))
                else:
                    elements[-1][2].append((parts[-1].decode(),
                                            parts[1].decode()))
            elif line == b"end_header":
                break

        np_t = {"float": "f4", "float32": "f4", "double": "f8",
                "uchar": "u1", "uint8": "u1", "char": "i1", "short": "i2",
                "ushort": "u2", "int": "i4", "int32": "i4", "uint": "u4"}
        verts, faces, tri_blocks = None, [], []
        for name, cnt, props in elements:
            if fmt == b"ascii":
                rows = [f.readline().split() for _ in range(cnt)]
                if name == "vertex":
                    idx = [i for i, (p, _) in enumerate(props)
                           if p in ("x", "y", "z")]
                    verts = np.array([[float(r[i]) for i in idx]
                                      for r in rows], np.float32)
                elif name == "face":
                    for r in rows:
                        k = int(r[0])
                        faces.extend([[int(r[1]), int(r[1 + j]),
                                       int(r[2 + j])] for j in range(1, k - 1)])
                continue
            if name == "vertex":
                rec = np.dtype([(p, np_t[t]) for p, t in props])
                data = np.fromfile(f, rec, cnt)
                verts = np.stack([data["x"], data["y"], data["z"]],
                                 -1).astype(np.float32)
            elif name == "face":
                (_, (cnt_t, idx_t)), = [p for p in props if p[0] == "__list__"]
                if len(props) == 1:
                    # a mesh of triangles alone reads as one record array
                    pos = f.tell()
                    tri = np.fromfile(f, np.dtype([("n", np_t[cnt_t]),
                                                   ("i", np_t[idx_t], 3)]),
                                      cnt)
                    if len(tri) == cnt and (tri["n"] == 3).all():
                        tri_blocks.append(tri["i"].astype(np.int32))
                        continue
                    f.seek(pos)
                for _ in range(cnt):
                    k = int(np.fromfile(f, np_t[cnt_t], 1)[0])
                    idxs = np.fromfile(f, np_t[idx_t], k).astype(np.int64)
                    for j in range(1, k - 1):
                        faces.append([idxs[0], idxs[j], idxs[j + 1]])
            else:  # skip unknown fixed-size element
                rec = np.dtype([(p, np_t[t]) for p, t in props])
                np.fromfile(f, rec, cnt)
    if verts is None:
        raise ValueError("PLY has no vertex element")
    return verts, np.concatenate(
        [np.asarray(faces, np.int32).reshape(-1, 3), *tri_blocks])
