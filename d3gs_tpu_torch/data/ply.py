"""Self-contained PLY reader/writer (numpy copy of `d3gs_tpu/data/ply.py`,
without its native fast path).

Layouts:
  * point-cloud PLYs with x/y/z [+ nx/ny/nz] [+ red/green/blue u1];
  * Gaussian checkpoint PLYs with float32 per-vertex properties (the 3DGS
    checkpoint format: x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_*),
    binary little-endian.
"""
from __future__ import annotations

import io
from typing import NamedTuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {v: k for k, v in reversed(_PLY_TO_NP.items())}


class PlyVertexData(NamedTuple):
    data: np.ndarray          # structured array
    names: tuple              # property names in file order


def _read_header(f):
    """Parse the PLY header of an open binary file, leaving it at the
    payload. Returns (fmt, counts, props)."""
    header_lines = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("PLY header has no end_header")
        line = line.decode("ascii").strip()
        header_lines.append(line)
        if line == "end_header":
            break
    fmt = None
    counts = {}
    props = []  # (elem, name, dtype)
    cur_elem = None
    for line in header_lines:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur_elem = parts[1]
            counts[cur_elem] = int(parts[2])
        elif parts[0] == "property":
            if parts[1] == "list":
                props.append((cur_elem, parts[-1],
                              ("list", parts[2], parts[3])))
            else:
                props.append((cur_elem, parts[-1], _PLY_TO_NP[parts[1]]))
    return fmt, counts, props


def read_ply(path: str) -> PlyVertexData:
    """Read the `vertex` element of a PLY file (binary or ascii)."""
    with open(path, "rb") as f:
        fmt, counts, props = _read_header(f)
        v_props = [(n, d) for e, n, d in props if e == "vertex"]
        if any(isinstance(d, tuple) for _, d in v_props):
            raise ValueError("list properties on vertex element unsupported")
        names = tuple(n for n, _ in v_props)
        nvert = counts.get("vertex", 0)

        if fmt == "ascii":
            rows = [[float(x) for x in f.readline().split()]
                    for _ in range(nvert)]
            arr = np.array(rows)
            out = np.empty(nvert, dtype=[(n, d) for n, d in v_props])
            for i, (n, d) in enumerate(v_props):
                out[n] = arr[:, i].astype(d)
            return PlyVertexData(out, names)

        endian = "<" if "little" in fmt else ">"
        dtype = np.dtype([(n, endian + d) for n, d in v_props])
        if props and props[0][0] != "vertex":
            raise ValueError("vertex element must come first")
        buf = f.read(dtype.itemsize * nvert)
        if len(buf) != dtype.itemsize * nvert:
            raise ValueError(f"{path}: truncated PLY payload")
        out = np.frombuffer(buf, dtype=dtype, count=nvert).copy()
        return PlyVertexData(out, names)


def write_ply(path: str, arrays: dict[str, np.ndarray]) -> None:
    """Write a binary little-endian PLY with one `vertex` element; `arrays`
    maps property name -> (N,) array, insertion order = file order."""
    names = list(arrays)
    n = len(arrays[names[0]])
    header = io.StringIO()
    header.write("ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {n}\n")
    dtype_fields = []
    for name in names:
        a = np.asarray(arrays[name])
        if a.shape != (n,):
            raise ValueError(f"PLY property {name!r}: shape {a.shape}, "
                             f"expected ({n},)")
        kind = a.dtype.str.lstrip("<>|=")
        header.write(f"property {_NP_TO_PLY[kind]} {name}\n")
        dtype_fields.append((name, "<" + kind))
    header.write("end_header\n")
    out = np.empty(n, dtype=dtype_fields)
    for name in names:
        out[name] = arrays[name]
    with open(path, "wb") as f:
        f.write(header.getvalue().encode("ascii"))
        f.write(out.tobytes())


def read_ply_columns(path: str):
    """-> ({name: (N,) array}, names) for the vertex element."""
    v, names = read_ply(path)
    return {nm: np.ascontiguousarray(v[nm]) for nm in names}, names


def read_pointcloud_ply(path: str):
    """-> (points (N,3) f64, colors (N,3) f64 in [0,1] or None, normals)."""
    v, names = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float64)
    colors = None
    if "red" in names:
        colors = np.stack([v["red"], v["green"], v["blue"]], axis=-1) / 255.0
    normals = None
    if "nx" in names:
        normals = np.stack([v["nx"], v["ny"], v["nz"]],
                           axis=-1).astype(np.float64)
    return pts, colors, normals


def write_pointcloud_ply(path: str, xyz: np.ndarray,
                         rgb: np.ndarray | None = None):
    """The reference's storePly layout (dataset_readers.py:156-173)."""
    n = xyz.shape[0]
    arrays = {
        "x": xyz[:, 0].astype(np.float32),
        "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "nx": np.zeros(n, np.float32),
        "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
    }
    if rgb is not None:
        arrays["red"] = rgb[:, 0].astype(np.uint8)
        arrays["green"] = rgb[:, 1].astype(np.uint8)
        arrays["blue"] = rgb[:, 2].astype(np.uint8)
    write_ply(path, arrays)
