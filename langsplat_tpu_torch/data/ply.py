"""Minimal PLY reader/writer (no external plyfile dependency).

A copy of `langsplat_tpu/data/ply.py` (numpy only), kept in the port so that it imports
nothing of the JAX package. Covers the two formats the pipeline needs:
  - SfM point clouds: x/y/z [+ nx/ny/nz] [+ red/green/blue uchar or float]
    (written by COLMAP and by the scene loader);
  - Gaussian field dumps: all-float32 vertex elements with the 3DGS column naming
    (x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_*).

Supports binary_little_endian 1.0 and ascii 1.0; vertex element only.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}
_NAMES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
          "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Returns {property_name: [N] array} for the vertex element."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        props: list[tuple[str, str]] = []
        count = 0
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    count = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise ValueError("list properties unsupported in vertex element")
                props.append((tokens[2], _DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt == "binary_little_endian":
            dtype = np.dtype([(n, "<" + t) for n, t in props])
            data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype,
                                 count=count)
        elif fmt == "ascii":
            raw = np.loadtxt(f, max_rows=count, ndmin=2)
            data = {n: raw[:, i].astype(t) for i, (n, t) in enumerate(props)}
            return dict(data)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
        return {n: np.ascontiguousarray(data[n]) for n, _ in props}


def write_ply(path: str, columns: dict[str, np.ndarray]) -> None:
    """Write a binary_little_endian vertex-element PLY with the given columns."""
    names = list(columns)
    n = len(next(iter(columns.values())))
    dtype = np.dtype([(k, "<" + np.dtype(columns[k].dtype).str[1:]) for k in names])
    rec = np.empty(n, dtype=dtype)
    for k in names:
        rec[k] = columns[k]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for k in names:
        header.append(f"property {_NAMES[np.dtype(columns[k].dtype).str[1:]]} {k}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def read_point_cloud(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (points [N,3] f32, colors [N,3] f32 in [0,1], normals [N,3] f32)."""
    cols = read_ply(path)
    pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)
    if "red" in cols:
        scale = 255.0 if cols["red"].dtype == np.uint8 else 1.0
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]],
                       axis=1).astype(np.float32) / scale
    else:
        rgb = np.full_like(pts, 0.5)
    if "nx" in cols:
        nrm = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=1).astype(np.float32)
    else:
        nrm = np.zeros_like(pts)
    return pts, rgb, nrm


def write_point_cloud(path: str, points: np.ndarray, colors: np.ndarray,
                      normals: np.ndarray | None = None) -> None:
    if normals is None:
        normals = np.zeros_like(points)
    rgb = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    write_ply(path, {
        "x": points[:, 0].astype(np.float32),
        "y": points[:, 1].astype(np.float32),
        "z": points[:, 2].astype(np.float32),
        "nx": normals[:, 0].astype(np.float32),
        "ny": normals[:, 1].astype(np.float32),
        "nz": normals[:, 2].astype(np.float32),
        "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
    })
