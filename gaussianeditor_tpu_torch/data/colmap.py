"""COLMAP model ingestion (binary + text).

Counterpart (a copy) of `gaussianeditor_tpu/data/colmap.py`
(`read_colmap_model`, the text and binary readers, `read_points3d`,
`write_colmap_model_bin`); numpy only.

First-party parsers for COLMAP's cameras/images/points3D files, covering
the formats the reference consumes (`gaussiansplatting/scene/
colmap_loader.py:113-260`): SIMPLE_PINHOLE / PINHOLE (and SIMPLE_RADIAL
treated as SIMPLE_PINHOLE, matching the loader's fallback in practice).
Implemented against the COLMAP on-disk format: each binary record is
little-endian packed; quaternions are (w, x, y, z) world-to-camera.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Tuple

import numpy as np

_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
}
_MODEL_IDS = {name: mid for mid, (name, _) in _CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def focal(self) -> Tuple[float, float]:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
            return float(self.params[0]), float(self.params[0])
        return float(self.params[0]), float(self.params[1])


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (w, x, y, z) world-to-cam
    tvec: np.ndarray
    camera_id: int
    name: str

    def rotmat(self) -> np.ndarray:
        """qvec2rotmat (colmap_loader.py:31-43)."""
        w, x, y, z = self.qvec
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )


def _read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = _CAMERA_MODELS[mid]
            params = np.array(struct.unpack("<" + "d" * np_, f.read(8 * np_)))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def _read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cid, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
        params = np.array([float(x) for x in parts[4:]])
        out[cid] = ColmapCamera(cid, model, w, h, params)
    return out


def _read_images_bin(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            q = np.array(struct.unpack("<dddd", f.read(32)))
            t = np.array(struct.unpack("<ddd", f.read(24)))
            cid = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.seek(24 * n2d, os.SEEK_CUR)  # skip 2D points (x, y, p3d_id)
            out[iid] = ColmapImage(iid, q, t, cid, name.decode("utf-8"))
    return out


def _read_images_txt(path: str) -> Dict[int, ColmapImage]:
    out = {}
    lines = [
        l.strip() for l in open(path)
        if l.strip() and not l.strip().startswith("#")
    ]
    for i in range(0, len(lines), 2):  # every other line is the 2D point list
        parts = lines[i].split()
        iid = int(parts[0])
        q = np.array([float(x) for x in parts[1:5]])
        t = np.array([float(x) for x in parts[5:8]])
        cid = int(parts[8])
        name = parts[9]
        out[iid] = ColmapImage(iid, q, t, cid, name)
    return out


def read_points3d(sparse_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (xyz [N,3] f32, rgb [N,3] f32 in [0,1]) — the 3DGS init
    point cloud (colmap_loader.py fetchPly/read_points3D_*)."""
    bin_path = os.path.join(sparse_dir, "points3D.bin")
    txt_path = os.path.join(sparse_dir, "points3D.txt")
    xyzs, rgbs = [], []
    if os.path.exists(bin_path):
        with open(bin_path, "rb") as f:
            n = struct.unpack("<Q", f.read(8))[0]
            for _ in range(n):
                f.read(8)  # point id
                xyz = struct.unpack("<ddd", f.read(24))
                rgb = struct.unpack("<BBB", f.read(3))
                f.read(8)  # error
                track_len = struct.unpack("<Q", f.read(8))[0]
                f.seek(8 * track_len, os.SEEK_CUR)
                xyzs.append(xyz)
                rgbs.append(rgb)
    elif os.path.exists(txt_path):
        for line in open(txt_path):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(x) for x in parts[1:4]])
            rgbs.append([float(x) for x in parts[4:7]])
    else:
        raise FileNotFoundError(f"no points3D in {sparse_dir}")
    xyz = np.asarray(xyzs, np.float32)
    rgb = np.asarray(rgbs, np.float32) / 255.0
    return xyz, rgb


def read_colmap_model(sparse_dir: str):
    """Read (cameras, images) from a COLMAP sparse dir (bin preferred)."""
    cb = os.path.join(sparse_dir, "cameras.bin")
    if os.path.exists(cb):
        cams = _read_cameras_bin(cb)
        imgs = _read_images_bin(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = _read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = _read_images_txt(os.path.join(sparse_dir, "images.txt"))
    return cams, imgs


# --- writers (for tests / interchange) ---

def write_colmap_model_bin(sparse_dir: str, cams: Dict[int, ColmapCamera],
                           imgs: Dict[int, ColmapImage]) -> None:
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            mid = _MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", c.camera_id, mid, c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))
