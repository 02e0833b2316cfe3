"""Triangle-mesh ingestion: OBJ / STL / DAE readers + surface sampling.

The reference builds its evaluation ground truth by loading simulation mesh
assets with trimesh and sampling 50k surface points with per-asset scale and
placement (eval_table_chair.py:66-88 — table_lightmap.dae + Chair.obj;
eval_cone.py:20-21 — cone.stl). trimesh/Open3D are not dependencies here, so
this module provides native readers for exactly the formats those assets use:

- OBJ: `v`/`f` records, polygonal faces fan-triangulated, `a/b/c` index
  syntax, negative (relative) indices.
- STL: binary (80-byte header + u32 count + 50-byte records) and ASCII,
  auto-detected the way real parsers do (by record arithmetic, not by the
  "solid" prefix, which binary exporters also emit).
- DAE (COLLADA): library_geometries meshes — <float_array> sources, the
  POSITION input of <vertices>, and <triangles>/<polylist> primitives with
  multi-input index strides. Scene-node transform chains
  (<matrix>/<translate>/<rotate>/<scale>, document order, parent-to-child,
  including <instance_node> indirection) ARE applied, and coordinates scale
  by <asset><unit meter=...> to meters — real Gazebo exports carry both.
  Up-axis is left as-authored (the reference applies orientation itself,
  eval/scenarios.load_and_scale_gt).

Sampling is area-weighted uniform over triangles with a seeded generator,
mirroring ``trimesh.sample`` semantics (eval_table_chair.py:73).
"""

from __future__ import annotations

import os
import re
import struct
import xml.etree.ElementTree as ET
from typing import NamedTuple, Sequence

import numpy as np


class TriMesh(NamedTuple):
    vertices: np.ndarray   # (V, 3) f64
    faces: np.ndarray      # (F, 3) i64


def _fan(indices: Sequence[int]) -> list:
    """Fan-triangulate a polygon index list."""
    return [(indices[0], indices[i], indices[i + 1])
            for i in range(1, len(indices) - 1)]


def read_obj(path: str) -> TriMesh:
    """Wavefront OBJ (vertices + faces; normals/uvs/materials ignored)."""
    verts, faces = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    k = int(tok.split("/")[0])
                    idx.append(k - 1 if k > 0 else len(verts) + k)
                faces.extend(_fan(idx))
    if not verts or not faces:
        raise ValueError(f"no triangle data in OBJ {path!r}")
    return TriMesh(np.asarray(verts, np.float64),
                   np.asarray(faces, np.int64))


def _read_stl_binary(data: bytes) -> TriMesh:
    n = struct.unpack_from("<I", data, 80)[0]
    rec = np.frombuffer(data, dtype=np.uint8, count=50 * n, offset=84)
    rec = rec.reshape(n, 50)
    tri = rec[:, 12:48].copy().view("<f4").reshape(n, 3, 3).astype(np.float64)
    verts = tri.reshape(-1, 3)
    faces = np.arange(3 * n, dtype=np.int64).reshape(n, 3)
    return TriMesh(verts, faces)


def _read_stl_ascii(text: str) -> TriMesh:
    coords = re.findall(
        r"vertex\s+([^\s]+)\s+([^\s]+)\s+([^\s]+)", text)
    if not coords or len(coords) % 3:
        raise ValueError("malformed ASCII STL")
    verts = np.asarray(coords, np.float64)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return TriMesh(verts, faces)


def read_stl(path: str) -> TriMesh:
    """STL, binary or ASCII auto-detected by record arithmetic.

    Record arithmetic is tried FIRST regardless of the header prefix: some
    binary exporters write free-form 80-byte headers starting with
    "solid ..." (and even containing "facet"), so prefix sniffing alone
    would mis-parse them as ASCII. Only when the declared record count does
    not fit the file does the ASCII parser run.
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) >= 84:
        n = struct.unpack_from("<I", data, 80)[0]
        # accept trailing bytes after the records (a common exporter
        # artifact) — only require the declared records to be present
        if n > 0 and 84 + 50 * n <= len(data):
            return _read_stl_binary(data)
    return _read_stl_ascii(data.decode("ascii", errors="replace"))


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _dae_geometry(geom) -> TriMesh | None:
    """Triangulated mesh of one <geometry> element (triangles/polylist
    primitives with arbitrary input strides), or None if it has none."""
    all_v, all_f = [], []
    base = 0
    for mesh in geom:
        if _strip_ns(mesh.tag) != "mesh":
            continue
        sources = {}
        vertices_src = {}
        for child in mesh:
            tag = _strip_ns(child.tag)
            if tag == "source":
                arr = None
                for sub in child:
                    if _strip_ns(sub.tag) == "float_array":
                        arr = np.asarray((sub.text or "").split(),
                                         np.float64)
                if arr is not None:
                    sources["#" + child.get("id", "")] = arr
            elif tag == "vertices":
                vid = "#" + child.get("id", "")
                for sub in child:
                    if (_strip_ns(sub.tag) == "input"
                            and sub.get("semantic") == "POSITION"):
                        vertices_src[vid] = sub.get("source")
        for prim in mesh:
            tag = _strip_ns(prim.tag)
            if tag not in ("triangles", "polylist"):
                continue
            v_offset, stride, pos_source = 0, 1, None
            for sub in prim:
                if _strip_ns(sub.tag) == "input":
                    stride = max(stride, int(sub.get("offset", 0)) + 1)
                    if sub.get("semantic") == "VERTEX":
                        v_offset = int(sub.get("offset", 0))
                        pos_source = vertices_src.get(sub.get("source"),
                                                      sub.get("source"))
            if pos_source is None or pos_source not in sources:
                continue
            verts = sources[pos_source].reshape(-1, 3)
            p_el = [s for s in prim if _strip_ns(s.tag) == "p"]
            if not p_el:
                continue
            p = np.asarray(" ".join(e.text or "" for e in p_el).split(),
                           np.int64)
            vidx = p.reshape(-1, stride)[:, v_offset]
            if tag == "polylist":
                vc_el = [s for s in prim if _strip_ns(s.tag) == "vcount"]
                vcount = np.asarray((vc_el[0].text or "").split(),
                                    np.int64) if vc_el else None
                faces = []
                pos = 0
                if vcount is None:
                    faces = vidx.reshape(-1, 3).tolist()
                else:
                    for c in vcount:
                        faces.extend(_fan(vidx[pos:pos + c].tolist()))
                        pos += c
                faces = np.asarray(faces, np.int64)
            else:
                faces = vidx.reshape(-1, 3)
            all_v.append(verts)
            all_f.append(faces + base)
            base += len(verts)
    if not all_v:
        return None
    return TriMesh(np.concatenate(all_v), np.concatenate(all_f))


def _floats(el) -> np.ndarray:
    return np.asarray((el.text or "").split(), np.float64)


def _node_transform(node) -> np.ndarray:
    """Compose a <node>'s transform elements in DOCUMENT ORDER (COLLADA
    semantics: each successive matrix/translate/rotate/scale
    post-multiplies)."""
    T = np.eye(4)
    for el in node:
        tag = _strip_ns(el.tag)
        if tag == "matrix":
            T = T @ _floats(el).reshape(4, 4)      # row-major per spec
        elif tag == "translate":
            M = np.eye(4)
            M[:3, 3] = _floats(el)[:3]
            T = T @ M
        elif tag == "rotate":
            x, y, z, deg = _floats(el)[:4]
            a = np.deg2rad(deg)
            axis = np.array([x, y, z])
            n = np.linalg.norm(axis)
            if n > 0:
                x, y, z = axis / n
                c, s = np.cos(a), np.sin(a)
                C = 1 - c
                R = np.array([
                    [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
                    [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
                    [z * x * C - y * s, z * y * C + x * s, z * z * C + c]])
                M = np.eye(4)
                M[:3, :3] = R
                T = T @ M
        elif tag == "scale":
            M = np.eye(4)
            M[[0, 1, 2], [0, 1, 2]] = _floats(el)[:3]
            T = T @ M
    return T


def read_dae(path: str) -> TriMesh:
    """COLLADA .dae with scene-node transforms and unit scaling.

    Matches how the reference ingests its GT asset (trimesh.load of a
    Gazebo export, eval_table_chair.py:66-74): the instantiated
    <visual_scene>'s node tree is walked, composing <matrix>/<translate>/
    <rotate>/<scale> chains (document order, parent-to-child) onto each
    <instance_geometry>, following <instance_node> into <library_nodes>;
    vertex coordinates then scale by <asset><unit meter=...> so the result
    is in meters. Files with no scene (or scenes instancing nothing) fall
    back to concatenating all library_geometries raw — the old behavior.
    Up-axis is left as-authored (the reference applies orientation itself).
    """
    root = ET.parse(path).getroot()

    geoms = {}
    for geom in root.iter():
        if _strip_ns(geom.tag) == "geometry":
            m = _dae_geometry(geom)
            if m is not None:
                geoms["#" + geom.get("id", "")] = m

    unit = 1.0
    for el in root.iter():
        if _strip_ns(el.tag) == "unit":
            unit = float(el.get("meter", "1.0"))
            break

    lib_nodes = {}
    for lib in root:
        if _strip_ns(lib.tag) == "library_nodes":
            for node in lib:
                if _strip_ns(node.tag) == "node":
                    lib_nodes["#" + node.get("id", "")] = node

    vscenes = {}
    for lib in root:
        if _strip_ns(lib.tag) == "library_visual_scenes":
            for vs in lib:
                if _strip_ns(vs.tag) == "visual_scene":
                    vscenes["#" + vs.get("id", "")] = vs
    active = []
    for el in root:
        if _strip_ns(el.tag) == "scene":
            for inst in el:
                if _strip_ns(inst.tag) == "instance_visual_scene":
                    url = inst.get("url", "")
                    if url in vscenes:
                        active.append(vscenes[url])
    if not active:
        active = list(vscenes.values())

    all_v, all_f = [], []
    base = 0

    def emit(mesh: TriMesh, T: np.ndarray):
        nonlocal base
        v = mesh.vertices @ T[:3, :3].T + T[:3, 3]
        all_v.append(v)
        all_f.append(mesh.faces + base)
        base += len(v)

    def walk(node, parent_T, depth=0):
        if depth > 32:          # instance_node cycle guard
            return
        T = parent_T @ _node_transform(node)
        for el in node:
            tag = _strip_ns(el.tag)
            if tag == "instance_geometry":
                g = geoms.get(el.get("url", ""))
                if g is not None:
                    emit(g, T)
            elif tag == "instance_node":
                ref = lib_nodes.get(el.get("url", ""))
                if ref is not None:
                    walk(ref, T, depth + 1)
            elif tag == "node":
                walk(el, T, depth)

    for vs in active:
        for node in vs:
            if _strip_ns(node.tag) == "node":
                walk(node, np.eye(4))

    if not all_v:
        # no scene (or it instanced nothing): all geometries, untransformed
        for m in geoms.values():
            emit(m, np.eye(4))
    if not all_v:
        raise ValueError(f"no triangle geometry in DAE {path!r}")
    return TriMesh(np.concatenate(all_v) * unit, np.concatenate(all_f))


_READERS = {".obj": read_obj, ".stl": read_stl, ".dae": read_dae}


def load_mesh(path: str) -> TriMesh:
    """Load a triangle mesh by extension (.obj / .stl / .dae)."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in _READERS:
        raise ValueError(f"unsupported mesh format {ext!r} ({path})")
    return _READERS[ext](path)


def sample_mesh_surface(mesh: TriMesh, n: int, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling (trimesh.sample semantics:
    eval_table_chair.py:73 samples 50k points per asset)."""
    v = mesh.vertices
    f = mesh.faces
    a = v[f[:, 0]]
    b = v[f[:, 1]]
    c = v[f[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero surface area")
    rng = np.random.default_rng(seed)
    tri = rng.choice(len(f), size=n, p=areas / total)
    u = rng.random((n, 1))
    w = rng.random((n, 1))
    flip = (u + w) > 1.0
    u = np.where(flip, 1.0 - u, u)
    w = np.where(flip, 1.0 - w, w)
    return a[tri] + u * (b[tri] - a[tri]) + w * (c[tri] - a[tri])
