"""COLMAP sparse-reconstruction parsers (bin + text), self-contained.

Numpy/struct copy of `d3gs_tpu/data/colmap_loader.py`. Reads
cameras.bin/images.bin/points3D.bin (and .txt fallbacks) in the COLMAP
export format — the same inputs consumed by the reference's
scene/colmap_loader.py:87-288. Implemented directly from the COLMAP binary
layout (documented in COLMAP's `src/base/reconstruction.cc`).
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

# camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray   # (4,) wxyz
    tvec: np.ndarray   # (3,)
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (largest-component method)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0] + (q[0] == 0))


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, nparams = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * nparams, "d" * nparams))
            out[cid] = ColmapCamera(cid, name, w, h, params)
    return out


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            out[cid] = ColmapCamera(cid, parts[1], int(parts[2]),
                                    int(parts[3]),
                                    np.array([float(p) for p in parts[4:]]))
    return out


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, 8, "Q")
            pt_dtype = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
            data = np.frombuffer(f.read(24 * npts), dtype=pt_dtype, count=npts)
            xys = np.stack([data["x"], data["y"]], axis=-1)
            p3d = data["id"].copy()
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                   name.decode("utf-8"), xys, p3d)
    return out


def read_images_text(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        # keep blank lines: the POINTS2D line following each image line
        # may be legitimately empty (zero observations) and the format is
        # strictly line-paired — dropping blanks would mis-pair entries
        lines = [l.strip() for l in f if not l.startswith("#")]
    while lines and not lines[0]:
        lines.pop(0)
    while lines and not lines[-1]:       # trailing newline(s)
        lines.pop()
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        iid = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(e) for e in elems]).reshape(-1, 3)[:, :2] \
            if elems else np.zeros((0, 2))
        p3d = (np.array([float(e) for e in elems]).reshape(-1, 3)[:, 2]
               .astype(np.int64) if elems else np.zeros(0, np.int64))
        out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, p3d)
    return out


def read_points3d_binary(path: str):
    """-> (xyz (N,3), rgb (N,3) uint8, err (N,))."""
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty(num)
        for i in range(num):
            _pid, x, y, z, r, g, b, e = _read(f, 43, "qdddBBBd")
            xyz[i] = (x, y, z)
            rgb[i] = (r, g, b)
            err[i] = e
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, 1)
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(p[1]), float(p[2]), float(p[3])])
            rgb.append([int(p[4]), int(p[5]), int(p[6])])
            err.append(float(p[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err))


# --- writers (used by tests / convert tooling) -----------------------------

def write_cameras_binary(path: str, cams: dict[int, ColmapCamera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            mid = _MODEL_NAME_TO_ID[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))


def write_images_binary(path: str, images: dict[int, ColmapImage]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.xys)
            f.write(struct.pack("<Q", n))
            for j in range(n):
                f.write(struct.pack("<ddq", im.xys[j, 0], im.xys[j, 1],
                                    int(im.point3D_ids[j])))


def write_points3d_binary(path: str, xyz, rgb, err=None):
    n = len(xyz)
    err = np.zeros(n) if err is None else err
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<qdddBBBd", i, *xyz[i],
                                *rgb[i].astype(np.uint8), err[i]))
            f.write(struct.pack("<Q", 0))
