"""File IO for the OTSLAM on-disk formats.

The reference's process boundaries are all files (SURVEY.md §5 checkpoint):
  * capture dataset: color/<label>_<n>.jpg, depth/<label>_<n>.png (uint16 mm),
    poses/<label>_<n>.txt (4x4 map->camera matrix)   [scanner_node.cpp:268-299]
  * 2D maps: PGM + YAML (slam_toolbox format)        [hybrid_map.py:31-38]
  * 3D objects / hybrid maps: .ply point clouds      [reconstruct_rgbd_filter.py:140]

Counterpart of otslam_tpu/core/io.py: PLY in both binary and ascii, with
point clouds (xyz[+rgb][+normals]) and triangle meshes; no Open3D.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np


def _cv2():
    """OpenCV if installed, else None (PIL is the fallback codec). Imported
    on first use, so the package imports on machines without either."""
    try:
        import cv2
    except ImportError:  # pragma: no cover
        return None
    return cv2


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None,
              faces: Optional[np.ndarray] = None, binary: bool = True) -> None:
    """Write a point cloud or triangle mesh to PLY.

    colors: float [0,1] or uint8; stored as uchar r,g,b.
    faces: (M,3) int vertex indices -> triangle mesh.
    """
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              "comment produced by otslam_tpu_torch",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    cols = None
    if colors is not None:
        cols = np.asarray(colors)
        if cols.dtype != np.uint8:
            cols = np.clip(np.asarray(cols, dtype=np.float64) * 255.0, 0, 255).astype(np.uint8)
        cols = cols.reshape(-1, 3)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    nrm = None
    if normals is not None:
        nrm = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
        header += ["property float nx", "property float ny", "property float nz"]
    if faces is not None:
        faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        header += [f"element face {faces.shape[0]}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if cols is not None:
                fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
            if nrm is not None:
                fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
            rec = np.zeros(n, dtype=np.dtype(fields))
            rec["x"], rec["y"], rec["z"] = points.T
            if cols is not None:
                rec["red"], rec["green"], rec["blue"] = cols.T
            if nrm is not None:
                rec["nx"], rec["ny"], rec["nz"] = nrm.T
            f.write(rec.tobytes())
            if faces is not None:
                frec = np.zeros(faces.shape[0],
                                dtype=np.dtype([("k", "u1"), ("a", "<i4"),
                                                ("b", "<i4"), ("c", "<i4")]))
                frec["k"] = 3
                frec["a"], frec["b"], frec["c"] = faces.T
                f.write(frec.tobytes())
        else:
            rows = []
            for i in range(n):
                row = f"{points[i,0]:.6f} {points[i,1]:.6f} {points[i,2]:.6f}"
                if cols is not None:
                    row += f" {cols[i,0]} {cols[i,1]} {cols[i,2]}"
                if nrm is not None:
                    row += f" {nrm[i,0]:.6f} {nrm[i,1]:.6f} {nrm[i,2]:.6f}"
                rows.append(row)
            if faces is not None:
                rows += [f"3 {a} {b} {c}" for a, b, c in faces]
            f.write(("\n".join(rows) + "\n").encode("ascii"))


def read_ply(path: str) -> dict:
    """Read a PLY file. Returns dict with 'points' (n,3) f32 and optionally
    'colors' (n,3) f32 in [0,1], 'normals' (n,3) f32, 'faces' (m,3) i32."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = "ascii"
    elements: list[tuple[str, int, list]] = []  # (name, count, [(prop, type)|('list',...)])
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property" and elements:
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[2], tok[1]))

    out: dict = {}
    offset = 0
    if fmt.startswith("binary"):
        little = "little" in fmt
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                # assume uniform triangle lists (as written by Open3D/us)
                cnt_t = _PLY_DTYPES[props[0][1]]
                idx_t = _PLY_DTYPES[props[0][2]]
                if not little:
                    cnt_t, idx_t = cnt_t.replace("<", ">"), idx_t.replace("<", ">")
                k = int(np.frombuffer(body, dtype=cnt_t, count=1, offset=offset)[0])
                rec = np.dtype([("k", cnt_t), ("v", idx_t, (k,))])
                arr = np.frombuffer(body, dtype=rec, count=count, offset=offset)
                offset += rec.itemsize * count
                if name == "face":
                    out["faces"] = arr["v"].astype(np.int32)
            else:
                fields = [(p[0], _PLY_DTYPES[p[1]] if little
                           else _PLY_DTYPES[p[1]].replace("<", ">")) for p in props]
                rec = np.dtype(fields)
                arr = np.frombuffer(body, dtype=rec, count=count, offset=offset)
                offset += rec.itemsize * count
                if name == "vertex":
                    _extract_vertex(out, arr)
    else:
        text = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                faces = []
                for _ in range(count):
                    k = int(text[pos]); pos += 1
                    faces.append([int(text[pos + i]) for i in range(k)])
                    pos += k
                if name == "face":
                    out["faces"] = np.asarray(faces, dtype=np.int32)
            else:
                ncol = len(props)
                vals = np.asarray(text[pos:pos + count * ncol], dtype=np.float64)
                pos += count * ncol
                arr2 = vals.reshape(count, ncol)
                names = [p[0] for p in props]
                rec = {nm: arr2[:, i] for i, nm in enumerate(names)}
                if name == "vertex":
                    _extract_vertex_dict(out, rec, names)
    return out


def _extract_vertex(out: dict, arr: np.ndarray) -> None:
    names = arr.dtype.names
    out["points"] = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float32)
    if all(c in names for c in ("red", "green", "blue")):
        cols = np.stack([arr["red"], arr["green"], arr["blue"]], axis=-1)
        out["colors"] = (cols.astype(np.float32) / 255.0
                         if cols.dtype == np.uint8 else cols.astype(np.float32))
    if all(c in names for c in ("nx", "ny", "nz")):
        out["normals"] = np.stack([arr["nx"], arr["ny"], arr["nz"]], axis=-1).astype(np.float32)


def _extract_vertex_dict(out: dict, rec: dict, names: list) -> None:
    out["points"] = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
    if all(c in names for c in ("red", "green", "blue")):
        out["colors"] = (np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1)
                         / 255.0).astype(np.float32)
    if all(c in names for c in ("nx", "ny", "nz")):
        out["normals"] = np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# PGM + map YAML (slam_toolbox conventions)
# ---------------------------------------------------------------------------

def read_pgm(path: str) -> np.ndarray:
    """Read a (P2 ascii or P5 binary) PGM image as uint8 (row 0 = top)."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    i = 0
    while len(tokens) < 4:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", data[i:])
        if m is None:
            raise ValueError(f"{path}: malformed PGM header")
        tok = m.group(1)
        i += m.end()
        if not tok.startswith(b"#"):
            tokens.append(tok)
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P5":
        # exactly one whitespace byte separates maxval from the binary raster
        img = np.frombuffer(data, dtype=np.uint8, count=w * h, offset=i + 1)
        return img.reshape(h, w).copy()
    elif magic == b"P2":
        vals = np.asarray(data[i:].split()[: w * h], dtype=np.uint8)
        return vals.reshape(h, w)
    raise ValueError(f"{path}: unsupported PGM magic {magic!r}")


def write_pgm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode("ascii"))
        f.write(img.tobytes())


def read_map_yaml(path: str) -> dict:
    import yaml  # imported on first use, like the image codecs
    with open(path, "r") as f:
        return yaml.safe_load(f)


def write_map_yaml(path: str, image: str, resolution: float,
                   origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                   negate: int = 0, occupied_thresh: float = 0.65,
                   free_thresh: float = 0.196) -> None:
    import yaml
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(
            {"image": image, "resolution": float(resolution),
             "origin": [float(o) for o in origin], "negate": negate,
             "occupied_thresh": occupied_thresh, "free_thresh": free_thresh},
            f, default_flow_style=None)


# ---------------------------------------------------------------------------
# Capture dataset (scanner_node format)
# ---------------------------------------------------------------------------

def read_bytes(path: str) -> bytes:
    """The whole file at `path`."""
    with open(path, "rb") as f:
        return f.read()


def parse_pose_txt(data: bytes) -> np.ndarray:
    """A pose file's bytes -> its 4x4 matrix (np.loadtxt of the text)."""
    return np.loadtxt(data.decode().splitlines()).reshape(4, 4)


def read_pose_txt(path: str) -> np.ndarray:
    """4x4 map->camera pose matrix, 6-decimal text (scanner_node.cpp:290-297)."""
    return parse_pose_txt(read_bytes(path))


def write_pose_txt(path: str, pose: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savetxt(path, np.asarray(pose).reshape(4, 4), fmt="%.6f")


def decode_depth_png(data: bytes) -> np.ndarray:
    """uint16 mm depth PNG bytes -> the (H, W) uint16 image, as
    `cv2.imread(path, IMREAD_UNCHANGED)` decodes the file."""
    cv2 = _cv2()
    if cv2 is not None:
        raw = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_UNCHANGED)
    else:  # pragma: no cover
        import io
        from PIL import Image
        raw = np.asarray(Image.open(io.BytesIO(data)))
    if raw is None:
        raise ValueError("not a decodable depth PNG")
    return raw


def read_depth_png(path: str, depth_scale: float = 1000.0) -> np.ndarray:
    """uint16 mm depth PNG -> float32 meters (0 where invalid)."""
    return decode_depth_png(read_bytes(path)).astype(np.float32) / depth_scale


def write_depth_png(path: str, depth_m: np.ndarray, depth_scale: float = 1000.0,
                    depth_max: float = 5.0) -> None:
    """float meters -> uint16 mm PNG with the scanner_node clipping semantics:
    NaN -> 0, > depth_max -> 0 (scanner_node.cpp:277-281)."""
    d = np.asarray(depth_m, dtype=np.float32).copy()
    d[~np.isfinite(d)] = 0.0
    d[d > depth_max] = 0.0
    u16 = np.round(d * depth_scale).astype(np.uint16)  # cv::convertTo rounds
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2 = _cv2()
    if cv2 is not None:
        cv2.imwrite(path, u16)
    else:  # pragma: no cover
        from PIL import Image
        Image.fromarray(u16).save(path)


def decode_color(data: bytes) -> np.ndarray:
    """Color image bytes -> (H, W, 3) uint8 RGB, as `cv2.imread(path,
    IMREAD_COLOR)` decodes the file."""
    cv2 = _cv2()
    if cv2 is not None:
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError("not a decodable colour image")
        return bgr[..., ::-1].copy()
    import io  # pragma: no cover
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def read_color(path: str) -> np.ndarray:
    """Color image -> (H, W, 3) uint8 RGB."""
    return decode_color(read_bytes(path))


def write_color(path: str, rgb: np.ndarray) -> None:
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2 = _cv2()
    if cv2 is not None:
        cv2.imwrite(path, rgb[..., ::-1])
    else:  # pragma: no cover
        from PIL import Image
        Image.fromarray(rgb).save(path)
