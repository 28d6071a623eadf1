"""PLY I/O in the Inria/GaussianEditor layout.

Counterpart of `gaussianeditor_tpu/models/ply.py` (`ply_vertex_count`,
`load_ply`, `save_ply`): x,y,z,nx,ny,nz, f_dc_{0..2}, f_rest_{0..3K-4}
(channel-major: the [N, K-1, 3] rest features are stored transposed to
[N, 3, K-1] then flattened), opacity, scale_{0..2}, rot_{0..3}; all
float32, binary_little_endian. Files written by either package load in
the other.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from gaussianeditor_tpu_torch import resolve_device

_PLY_DTYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
}


def _read_ply_vertices(path: str) -> Dict[str, np.ndarray]:
    """Minimal PLY reader: returns the 'vertex' element as {name: array}."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        cur_props: List[Tuple[str, str]] = []
        cur_name, cur_count = None, 0
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "comment":
                continue
            elif tokens[0] == "element":
                if cur_name is not None:
                    elements.append((cur_name, cur_count, cur_props))
                cur_name, cur_count, cur_props = tokens[1], int(tokens[2]), []
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    raise ValueError("list properties unsupported")
                cur_props.append((tokens[-1], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                if cur_name is not None:
                    elements.append((cur_name, cur_count, cur_props))
                break

        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"unsupported PLY format {fmt}")

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            dtype = np.dtype([(p, "<" + d) for p, d in props])
            if fmt == "binary_little_endian":
                buf = f.read(dtype.itemsize * count)
                if len(buf) != dtype.itemsize * count:
                    raise ValueError(f"{path}: truncated '{name}' element")
                data = np.frombuffer(buf, dtype=dtype, count=count)
            else:
                rows = [f.readline().split() for _ in range(count)]
                data = np.array([tuple(r) for r in rows], dtype=dtype)
            if name == "vertex":
                for p, _ in props:
                    out[p] = np.ascontiguousarray(data[p])
        if not out:
            raise ValueError(f"{path}: no vertex element")
        return out


def ply_vertex_count(path: str) -> int:
    """Vertex count from the header alone (to size capacities)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        for _ in range(1000):
            tokens = f.readline().decode("ascii", "replace").split()
            if tokens[:2] == ["element", "vertex"]:
                return int(tokens[2])
            if tokens[:1] == ["end_header"]:
                break
    raise ValueError(f"{path}: no vertex element in header")


def save_ply(scene, path: str) -> None:
    """Write a GaussianScene (alive slots only) in the Inria layout."""
    keep = scene.alive.detach().cpu().numpy()

    def host(t):
        return t.detach().cpu().numpy().astype(np.float32)[keep]

    xyz = host(scene.xyz)
    n = xyz.shape[0]
    normals = np.zeros_like(xyz)
    # [N,1,3] -> [N,3] / [N,K-1,3] -> [N,3,K-1] -> flat (channel-major)
    f_dc = host(scene.features_dc).transpose(0, 2, 1).reshape(n, -1)
    f_rest = host(scene.features_rest).transpose(0, 2, 1).reshape(n, -1)
    opacity = host(scene.opacity_raw).reshape(n, 1)
    scales = host(scene.log_scales)
    rots = host(scene.quats)

    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(f_dc.shape[1])]
    names += [f"f_rest_{i}" for i in range(f_rest.shape[1])]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(scales.shape[1])]
    names += [f"rot_{i}" for i in range(rots.shape[1])]

    attributes = np.concatenate(
        [xyz, normals, f_dc, f_rest, opacity, scales, rots], axis=1
    ).astype("<f4")

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(attributes).tobytes())


def load_ply(path: str, capacity=None, anchor_weight_init_g0: float = 0.05,
             device="cuda"):
    """Read an Inria-layout PLY into a GaussianScene on `device`.

    SH degree is inferred from the f_rest_* count and made active;
    generation is zeroed, the mask covers every alive slot, the anchor is
    a copy of the parameters. Slots past the file's vertex count are dead.
    """
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene

    device = resolve_device(device)
    v = _read_ply_vertices(path)
    n = v["x"].shape[0]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    opacity = np.asarray(v["opacity"], np.float32)[:, None]

    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]],
                    axis=1).astype(np.float32)
    rest_names = sorted(
        (k for k in v if k.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1])
    )
    max_sh_degree = int(((len(rest_names) + 3) / 3) ** 0.5 - 1)
    k_rest = (max_sh_degree + 1) ** 2 - 1
    if rest_names:
        f_rest = np.stack([v[kk] for kk in rest_names], axis=1).astype(np.float32)
        f_rest = f_rest.reshape(n, 3, k_rest).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)

    scale_names = sorted(
        (k for k in v if k.startswith("scale_")),
        key=lambda s: int(s.split("_")[-1])
    )
    scales = np.stack([v[kk] for kk in scale_names], axis=1).astype(np.float32)
    rot_names = sorted(
        (k for k in v if k.startswith("rot_")),
        key=lambda s: int(s.split("_")[-1])
    )
    rots = np.stack([v[kk] for kk in rot_names], axis=1).astype(np.float32)

    if capacity is None:
        capacity = n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} vertices in {path}")

    def pad(x):
        out = torch.zeros((capacity,) + x.shape[1:], dtype=torch.float32,
                          device=device)
        out[:n] = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return out

    params = dict(
        xyz=pad(xyz),
        features_dc=pad(f_dc[:, None, :]),
        features_rest=pad(f_rest),
        opacity_raw=pad(opacity),
        log_scales=pad(scales),
        quats=pad(rots),
    )
    return GaussianScene.create(
        params,
        max_sh_degree=max_sh_degree,
        anchor_weight_init_g0=anchor_weight_init_g0,
        active_sh_degree=max_sh_degree,
        alive=np.arange(capacity) < n,
    )
