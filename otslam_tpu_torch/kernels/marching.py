"""Triangle-mesh extraction from TSDF volumes by marching tetrahedra
(counterpart of otslam_tpu/kernels/marching.py).

Each surface cell (all 8 corners observed, mixed signs) splits into 6
tetrahedra sharing the cube's main diagonal; the 16 inside/outside sign
cases of a tetrahedron are derived at import (`_build_tet_table`) and each
emits 0-2 triangles, wound afterwards to face positive tsdf. The soup is
padded and masked: verts (T, 9), cols (T, 9), tri_mask (T,) with
T = max_cells * 12, triangle `cell*12 + tet*2 + tri`, rows vertex-major
([v0x v0y v0z v1x ... v2z]). Cells are x-major on the dense path and
block-major on the block path; on overflow the smallest cell ids (and, on
the block path, the smallest created block ids) are kept, and padded cells
decode cell 0 under a false mask. Vertex welding (1e-5 m quantized
vertices) runs where the soup lives: a card's soup is welded on the card
by one stable sort of packed keys, in numpy's order, and only the welded
arrays cross to the host; a host soup by numpy unique, as in the JAX
package. `extract_mesh` opens the spans ``extract.march``,
``extract.to_host`` and ``extract.weld`` (utils/profiling.py).

This is plain PyTorch on whatever device holds the volume: the JAX
package's extraction is XLA with no Pallas kernel. Its TPU layout is not
carried over: active cells compact with `nonzero` (not a segmented top_k),
each triangle vertex's two cube corners come from indexing a
(case -> corner) table (not one-hot MXU contractions), per-cell corner
values are direct gathers (not a one-hot lane select), and the block
path's 8 corner fields are 3D slices of each block with its 7 +x/+y/+z
halo blocks (not masked lane rolls). Every f32 operation of the lerp,
the colour scale and the winding test keeps the JAX order; XLA:CPU fuses
some of them into FMAs, so the two packages agree to ~1 ulp, not bit for
bit (tests state the tolerance).
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

from otslam_tpu_torch.device import to_device, to_host
from otslam_tpu_torch.kernels.tsdf import TSDFVolume, recip32
from otslam_tpu_torch.kernels.tsdf_block import (
    BLOCK, BLOCK_VOXELS, BlockTSDFVolume)
from otslam_tpu_torch.utils.profiling import count, drain, span, waited

# cube corner offsets (x, y, z), corner index x*4 + y*2 + z (z fastest)
_CORNERS = np.array(list(product((0, 1), repeat=3)), np.int32)  # (8, 3)

# 6-tetrahedra decomposition of the cube sharing the main diagonal 0-7
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], np.int32)


def _build_tet_table():
    """For each of 16 inside/outside sign cases of a tetrahedron, the
    triangles as edge pairs: table (16, 2, 3, 2), -1 padded.

    A tet vertex is "inside" when tsdf < 0. Crossing edges connect inside
    to outside vertices; 1 or 3 inside vertices give one triangle, 2 give
    two (a quad). Winding is fixed afterwards using the TSDF gradient, so
    the table only records connectivity.
    """
    table = -np.ones((16, 2, 3, 2), np.int32)
    edges = [(a, b) for a in range(4) for b in range(a + 1, 4)]
    for case in range(16):
        inside = [v for v in range(4) if case & (1 << v)]
        outside = [v for v in range(4) if v not in inside]
        cross = [(a, b) for (a, b) in edges
                 if (a in inside) != (b in inside)]
        if len(inside) in (1, 3):
            # single triangle around the lone vertex
            lone = inside[0] if len(inside) == 1 else outside[0]
            tri = [e for e in cross if lone in e]
            assert len(tri) == 3
            table[case, 0] = np.array(tri)
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            # quad vertices in cyclic order: (a,c), (a,d), (b,d), (b,c)
            q = [tuple(sorted(e)) for e in
                 [(a, c), (a, d), (b, d), (b, c)]]
            table[case, 0] = np.array([q[0], q[1], q[2]])
            table[case, 1] = np.array([q[0], q[2], q[3]])
    return table


_TET_TABLE = _build_tet_table()  # (16, 2, 3, 2)


def _build_corner_table():
    """(case -> cube corner) table of the per-cell phase: CORNER[tet, case,
    tri, vtx, endpoint] is the cube corner (0-7) at `endpoint` of the edge
    that gives triangle vertex (tri, vtx) of tetrahedron `tet` under its
    sign case, 0 where the case emits no such triangle; PRESENT[case, tri]
    whether it does."""
    present = _TET_TABLE[:, :, 0, 0] >= 0                        # (16, 2)
    tet_vtx = np.where(_TET_TABLE >= 0, _TET_TABLE, 0)         # (16,2,3,2)
    corner = np.stack([_TETS[s][tet_vtx] for s in range(6)])   # (6,16,2,3,2)
    corner = np.where(present[None, :, :, None, None], corner, 0)
    return corner.astype(np.int64), present


_CORNER_TABLE, _TRI_PRESENT = _build_corner_table()
# TSDF-gradient weights for winding: g_f = sum_v tv_v * (2*offset_vf - 1)/4
_GRAD_W = ((2.0 * _CORNERS - 1.0) / 4.0).astype(np.float32)   # (8, 3)


def _compact_cells(active: torch.Tensor, max_ids: int):
    """(ids (max_ids,), mask (max_ids,)): the ascending indices of the set
    entries of a 1-D mask, the smallest max_ids of them on overflow, padded
    with 0 under a false mask."""
    waited(active)
    ids = torch.nonzero(active).reshape(-1)[:max_ids]
    n = ids.shape[0]
    mask = torch.arange(max_ids, device=active.device) < n
    return torch.nn.functional.pad(ids, (0, max_ids - n)), mask


def _corner_positions(base: torch.Tensor, voxel_size: float,
                      origin) -> torch.Tensor:
    """(C, 8, 3) world positions of the 8 corners of cells whose base voxel
    is `base` (C, 3) f32: (base + corner + 0.5) * voxel_size + origin."""
    corners = to_device(_CORNERS, base.device, torch.float32)
    org = to_device(origin, base.device, torch.float32)
    return (base[:, None, :] + corners[None]
            + 0.5) * voxel_size + org[None, None, :]


def _soup_from_corners(tv: torch.Tensor, pos: torch.Tensor,
                       cv: torch.Tensor, cell_mask: torch.Tensor):
    """The per-cell phase shared by the dense and block paths.

    tv (C, 8) corner tsdf, pos (C, 8, 3) world positions, cv (C, 8, 3)
    colours [0, 255]; returns the masked soup (verts (C*12, 9), cols
    (C*12, 9), tri_mask (C*12,))."""
    C = tv.shape[0]
    dev = tv.device
    tets = to_device(_TETS, dev, torch.int64)
    bits = (tv[:, tets] < 0).to(torch.int64)                    # (C, 6, 4)
    case = (bits[..., 0] + bits[..., 1] * 2 + bits[..., 2] * 4
            + bits[..., 3] * 8)                                 # (C, 6)

    table = to_device(_CORNER_TABLE, dev)                       # (6,16,...)
    sel = table[torch.arange(6, device=dev)[None, :], case]     # (C,6,2,3,2)
    ia = sel[..., 0].reshape(C, 36)
    ib = sel[..., 1].reshape(C, 36)
    present = to_device(_TRI_PRESENT, dev)[case]                # (C, 6, 2)

    def at(field, idx):
        if field.dim() == 2:
            return torch.gather(field, 1, idx)
        return torch.gather(field, 1, idx[..., None].expand(-1, -1, 3))

    ta, tb = at(tv, ia), at(tv, ib)                             # (C, 36)
    pa, pb = at(pos, ia), at(pos, ib)                           # (C, 36, 3)
    ca, cb = at(cv, ia), at(cv, ib)

    denom = ta - tb
    frac = ta / torch.where(torch.abs(denom) > 1e-12, denom, 1.0)
    frac = torch.clamp(frac, 0.0, 1.0)[..., None]               # (C, 36, 1)
    verts = pa + (pb - pa) * frac
    cols = torch.clamp((ca + (cb - ca) * frac) * recip32(255.0), 0.0, 1.0)

    # wind every triangle toward positive tsdf: compare its geometric normal
    # with the cell's trilinear TSDF gradient g_f = sum_v tv_v * w_vf
    vk = verts.reshape(C, 12, 3, 3)                             # (C,tri,vtx,f)
    ck = cols.reshape(C, 12, 3, 3)
    e1 = vk[:, :, 1] - vk[:, :, 0]
    e2 = vk[:, :, 2] - vk[:, :, 0]
    n_geom = torch.stack([e1[..., 1] * e2[..., 2] - e1[..., 2] * e2[..., 1],
                          e1[..., 2] * e2[..., 0] - e1[..., 0] * e2[..., 2],
                          e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]],
                         dim=-1)                                # (C, 12, 3)
    gw = to_device(_GRAD_W, dev)
    gdir = tv[:, 0:1] * gw[0]
    for v in range(1, 8):
        gdir = gdir + tv[:, v:v + 1] * gw[v]                    # (C, 3)
    g = gdir[:, None, :]
    flip = (n_geom[..., 0] * g[..., 0] + n_geom[..., 1] * g[..., 1]
            + n_geom[..., 2] * g[..., 2]) < 0                   # (C, 12)
    swap = to_device([0, 2, 1], dev)
    f4 = flip[..., None, None]
    v1 = torch.where(f4, vk[:, :, swap], vk)
    c1 = torch.where(f4, ck[:, :, swap], ck)

    tri_mask = (present.reshape(C, 12) & cell_mask[:, None]).reshape(-1)
    return v1.reshape(C * 12, 9), c1.reshape(C * 12, 9), tri_mask


# --- dense volumes -----------------------------------------------------------

def _dense_active(vol: TSDFVolume) -> torch.Tensor:
    """Flat (X-1)(Y-1)(Z-1) mask of the surface cells (all 8 corners
    observed, mixed signs), x-major."""
    X, Y, Z = vol.dims

    def corner(arr, dx, dy, dz):
        return arr[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]

    observed = torch.ones((X - 1, Y - 1, Z - 1), dtype=torch.bool,
                          device=vol.tsdf.device)
    any_neg = torch.zeros_like(observed)
    all_neg = torch.ones_like(observed)
    for c in _CORNERS:
        observed &= corner(vol.weight, *c) > 0
        neg = corner(vol.tsdf, *c) < 0
        any_neg |= neg
        all_neg &= neg
    return (observed & any_neg & ~all_neg).reshape(-1)


def extract_mesh_soup(vol: TSDFVolume, max_cells: int = 131072):
    """Marching-tetrahedra triangle soup of a dense volume.

    Returns (verts (T, 9), cols (T, 9), tri_mask (T,)) with
    T = max_cells * 12 (6 tets x up to 2 triangles) and rows vertex-major
    ([v0x v0y v0z v1x ... v2z]; reshape(-1, 3, 3) recovers triangles).
    Degenerate/absent triangles are masked out. Triangle winding: outward
    (toward tsdf > 0).
    """
    X, Y, Z = vol.dims
    cells, cell_mask = _compact_cells(_dense_active(vol), max_cells)

    cy, cz = Y - 1, Z - 1
    ci = cells // (cy * cz)
    cj = (cells // cz) % cy
    ck = cells % cz
    off = to_device(_CORNERS, cells.device, torch.int64)
    flat = ((off[None, :, 0] + ci[:, None]) * (Y * Z)
            + (off[None, :, 1] + cj[:, None]) * Z
            + (off[None, :, 2] + ck[:, None]))                  # (C, 8)
    tv = vol.tsdf.reshape(-1)[flat].to(torch.float32)
    cf = vol.color.reshape(3, -1)
    cv = torch.stack([cf[c][flat] for c in range(3)], dim=-1).to(
        torch.float32)                                          # (C, 8, 3)
    base = torch.stack([ci, cj, ck], dim=-1).to(torch.float32)
    pos = _corner_positions(base, vol.voxel_size, vol.origin)
    return _soup_from_corners(tv, pos, cv, cell_mask)


def _count_active_cells(vol: TSDFVolume) -> int:
    """Number of surface cells: the exact extract_mesh_soup capacity."""
    active = _dense_active(vol)
    waited(active)
    return int(active.sum())


def _pow2_bucket(n: int, lo: int, cap: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return min(b, cap)


def auto_max_cells(vol: TSDFVolume, cap: int = 131072) -> int:
    """The exact surface-cell count rounded up to a power of two (at least
    1024), at most `cap`: the per-cell phase scales with the capacity, not
    with the active count."""
    return _pow2_bucket(max(_count_active_cells(vol), 1), 1024, cap)


# --- block volumes -----------------------------------------------------------

# the 7 +x/+y/+z neighbour offsets a block's far corners reach into
_BLK_OFFS = tuple((ox, oy, oz) for ox in (0, 1) for oy in (0, 1)
                  for oz in (0, 1) if (ox, oy, oz) != (0, 0, 0))


def _created_ids(vol: BlockTSDFVolume, max_blocks: int) -> torch.Tensor:
    """The ascending created block ids, the smallest max_blocks of them
    (at least one entry: the dead row NB when none is created)."""
    nb = vol.num_blocks
    waited(vol.created)
    ids = torch.nonzero(vol.created[:nb]).reshape(-1)[:max_blocks]
    if ids.shape[0] == 0:
        ids = torch.full((1,), nb, dtype=torch.int64, device=ids.device)
    return ids


def _halo_ids(vol: BlockTSDFVolume, ids: torch.Tensor) -> torch.Tensor:
    """(M, 8) block ids at offsets (ox, oy, oz) in _CORNERS order of each
    id, the block itself first; the dead row NB beyond the grid and for
    the dead row itself."""
    bx, by, bz = vol.grid_blocks
    nb = vol.num_blocks
    ix = ids // (by * bz)
    iy = (ids // bz) % by
    iz = ids % bz
    ok0 = ids < nb
    out = []
    for ox, oy, oz in _CORNERS.tolist():
        ok = ok0 & (ix + ox < bx) & (iy + oy < by) & (iz + oz < bz)
        out.append(torch.where(ok, ids + ox * by * bz + oy * bz + oz, nb))
    return torch.stack(out, dim=1)


def _corner_fields(rows: torch.Tensor, halo: torch.Tensor) -> torch.Tensor:
    """(8, M, 512): the field `rows` (NB+1, 512) at cube corner k (in
    _CORNERS order) of every voxel of the M blocks, read from a 16^3 cube
    of each block and its 7 halo blocks (the dead row's zeros beyond the
    grid)."""
    M = halo.shape[0]
    cube = rows[halo].reshape(M, 2, 2, 2, BLOCK, BLOCK, BLOCK)
    cube = cube.permute(0, 1, 4, 2, 5, 3, 6).reshape(
        M, 2 * BLOCK, 2 * BLOCK, 2 * BLOCK)
    return torch.stack([
        cube[:, ox:ox + BLOCK, oy:oy + BLOCK, oz:oz + BLOCK].reshape(
            M, BLOCK_VOXELS)
        for ox, oy, oz in _CORNERS.tolist()])


def _block_active_cells(vol: BlockTSDFVolume, max_blocks: int):
    """(ids (M,), halo (M, 8), t8 (8, M, 512), active (M*512,)): the
    created blocks, their halos, their tsdf corner fields and the flat
    block-major active-cell mask."""
    ids = _created_ids(vol, max_blocks)
    halo = _halo_ids(vol, ids)
    t8 = _corner_fields(vol.tsdf, halo)
    w8 = _corner_fields(vol.weight, halo)
    # the dead-row entry of an empty volume is no cell, even if a caller
    # dirtied the dead row
    valid = (ids < vol.num_blocks)[:, None]
    observed = torch.all(w8 > 0, dim=0) & valid
    neg = t8 < 0
    mixed = torch.any(neg, dim=0) & ~torch.all(neg, dim=0)
    return ids, halo, t8, (observed & mixed).reshape(-1)


def extract_mesh_soup_block(vol: BlockTSDFVolume, max_blocks: int = 4096,
                            max_cells: int = 32768):
    """Marching-tetrahedra triangle soup of a BlockTSDFVolume.

    Same contract as ``extract_mesh_soup`` (verts (T, 9), cols (T, 9),
    tri_mask (T,), T = max_cells * 12, rows vertex-major); the triangles
    equal the densified path's as a set (the soup order is block-major).
    Touches only the created blocks (the smallest max_blocks ids) and
    their +x/+y/+z halo rows."""
    by, bz = vol.grid_blocks[1], vol.grid_blocks[2]
    ids, halo, t8, active = _block_active_cells(vol, max_blocks)
    cells, cell_mask = _compact_cells(active, max_cells)

    mi = cells // BLOCK_VOXELS
    l = cells % BLOCK_VOXELS
    lx = l // (BLOCK * BLOCK)
    ly = (l // BLOCK) % BLOCK
    lz = l % BLOCK
    bid = ids[mi]                 # padded cells decode row 0: masked
    ix = bid // (by * bz)
    iy = (bid // bz) % by
    iz = bid % bz
    base = torch.stack([ix * BLOCK + lx, iy * BLOCK + ly, iz * BLOCK + lz],
                       dim=-1).to(torch.float32)
    pos = _corner_positions(base, vol.voxel_size, vol.origin)
    tv = t8[:, mi, l].T                                         # (C, 8)
    cv = torch.stack([
        _corner_fields(vol.color[:, c * BLOCK_VOXELS:(c + 1) * BLOCK_VOXELS],
                       halo)[:, mi, l].T
        for c in range(3)], dim=-1)                             # (C, 8, 3)
    return _soup_from_corners(tv, pos, cv, cell_mask)


def _count_active_cells_block(vol: BlockTSDFVolume, max_blocks: int) -> int:
    active = _block_active_cells(vol, max_blocks)[3]
    waited(active)
    return int(active.sum())


def auto_mesh_block_config(vol: BlockTSDFVolume, blocks_cap: int = 32768,
                           cells_cap: int = 131072,
                           max_cells: int | None = None):
    """(max_blocks, max_cells) sized to the volume: the exact created-block
    and surface-cell counts, bucketed to powers of two (the block-path
    analog of auto_max_cells)."""
    waited(vol.created)
    nbk = max(int(vol.created[:vol.num_blocks].sum()), 1)
    mb = _pow2_bucket(nbk, 256, blocks_cap)
    if max_cells is None:
        n = max(_count_active_cells_block(vol, mb), 1)
        max_cells = _pow2_bucket(n, 1024, cells_cap)
    return mb, max_cells


def _validate_batch(vols, max_blocks=None, max_cells=None):
    """Shared checks of batched block extraction: the volumes must be
    same-shape; capacities default to the max of the per-volume auto
    configs. Returns (max_blocks, max_cells)."""
    v0 = vols[0]
    for v in vols[1:]:
        if (v.grid_blocks != v0.grid_blocks
                or v.voxel_size != v0.voxel_size
                or v.sdf_trunc != v0.sdf_trunc):
            raise ValueError("batched extraction needs same-shape volumes")
    if max_blocks is None or max_cells is None:
        cfgs = [auto_mesh_block_config(v) for v in vols]
        max_blocks = max_blocks or max(mb for mb, _ in cfgs)
        max_cells = max_cells or max(mc for _, mc in cfgs)
    return max_blocks, max_cells


def extract_meshes_block(vols, max_blocks: int | None = None,
                         max_cells: int | None = None):
    """Triangle soups of B same-shape BlockTSDFVolumes at shared capacities:
    (verts (B, T, 9), cols (B, T, 9), masks (B, T)), each volume's equal
    to its extract_mesh_soup_block at those capacities. Volumes may have
    different origins; grid shape, voxel size and truncation must match.
    Capacities default to the max of the per-volume auto configs."""
    mb, mc = _validate_batch(vols, max_blocks, max_cells)
    soups = [extract_mesh_soup_block(v, mb, mc) for v in vols]
    return tuple(torch.stack(parts) for parts in zip(*soups))


def extract_mesh(vol, max_cells: int | None = None):
    """Welded mesh: (vertices (V,3), faces (F,3), colors (V,3), normals
    (V,3)) numpy. Vertices quantized to 1e-5 m for welding.

    Accepts a dense TSDFVolume or a BlockTSDFVolume (extracted from its
    created blocks). max_cells None = auto (exact active-cell count,
    bucketed)."""
    with span("extract.march"):
        if isinstance(vol, BlockTSDFVolume):
            mb, mc = auto_mesh_block_config(vol, max_cells=max_cells)
            soup = extract_mesh_soup_block(vol, mb, mc)
        else:
            if max_cells is None:
                max_cells = auto_max_cells(vol)
            soup = extract_mesh_soup(vol, max_cells)
    return _weld_mesh(*soup, extent=_extent(vol))


def _extent(vol) -> float:
    """The widest side of `vol`'s box in metres; its vertices lie inside."""
    if isinstance(vol, BlockTSDFVolume):
        n = max(vol.grid_blocks) * BLOCK
    else:
        n = max(vol.dims)
    return n * vol.voxel_size


def _masked_rows(a, mask) -> np.ndarray:
    """The rows of `a` where `mask` holds, as a host array: a tensor is
    masked on its device, so only the kept rows cross to the host."""
    if isinstance(a, torch.Tensor):
        mask = to_device(mask, a.device)
        waited(mask)            # the masked rows' count
        return to_host(a[mask])
    return np.asarray(a)[np.asarray(mask)]


# the weld's quantum in metres, and the widest box whose keys fit 21 bits an
# axis: (2^21 - 1) * 1e-5 = 20.97 m, less room for the vertices' rounding
_QUANTUM = 1e-5
_PACK_EXTENT = 20.0


def _weld_mesh(verts, cols, mask, extent: float | None = None):
    """Vertex welding of a masked (T, 9) triangle soup (1e-5 m
    quantization) into host (vertices, faces, colors, normals). A soup on
    the card is welded there (`_weld_device`; `extent`, the widest side in
    metres of a box holding the vertices, lets it sort one packed key); a
    host soup, arrays or CPU tensors, by numpy's `_weld`."""
    if isinstance(verts, torch.Tensor) and verts.is_cuda:
        with span("extract.to_host"):
            rows = torch.nonzero(to_device(mask, verts.device)).reshape(-1)
            waited(rows)        # the masked rows' count
            v = verts[rows].reshape(-1, 3)
            c = cols[rows].reshape(-1, 3)
        return _weld_device(v, c, extent)
    with span("extract.to_host"):
        v = _masked_rows(verts, mask).reshape(-1, 3)
        c = _masked_rows(cols, mask).reshape(-1, 3)
    with span("extract.weld"):
        return _weld(v, c)


def _weld_keys(v: torch.Tensor) -> torch.Tensor:
    """numpy's weld keys of `v`, ``np.round(v / 1e-5)`` as int64, bit for
    bit: float32 true division by a divisor on `v`'s device (CUDA
    multiplies by the reciprocal of a host scalar, which moves keys at .5
    ties), then round-half-to-even."""
    q = torch.full((), _QUANTUM, dtype=torch.float32, device=v.device)
    return torch.round(v / q).to(torch.int64)


def _weld_device(v: torch.Tensor, c: torch.Tensor,
                 extent: float | None = None):
    """`_weld` on the device that holds the rows `v`, `c` (3 a triangle),
    with the same host arrays out: numpy's keys, welded vertex order,
    first-occurrence rows and faces; normals equal up to the order of the
    card's atomic adds. Two host waits (the counts, the copy back) and one
    copy of the welded arrays.

    np.unique(axis=0) orders the int64 key rows lexicographically; a
    stable sort of the packed offsets from each axis's least key gives
    that order when every axis spans fewer than 2^21 keys, which
    `extent` <= _PACK_EXTENT guarantees (counted ``weld.packed``);
    otherwise three chained stable sorts do (``weld.lexsort``)."""
    n = v.shape[0]
    if n == 0:
        return _weld(to_host(v), to_host(c))
    dev = v.device
    with span("extract.weld"):
        key = _weld_keys(v)
        if extent is not None and extent <= _PACK_EXTENT:
            count("weld.packed")
            off = key - key.amin(0)
            srt, perm = torch.sort(
                (off[:, 0] << 42) | (off[:, 1] << 21) | off[:, 2],
                stable=True)
            new = srt[1:] != srt[:-1]
        else:
            count("weld.lexsort")
            perm = torch.arange(n, device=dev)
            for ax in (2, 1, 0):
                perm = perm[torch.sort(key[perm, ax], stable=True)[1]]
            srt = key[perm]
            new = torch.any(srt[1:] != srt[:-1], dim=1)
        # welded vertex of each sorted row, scattered back to the soup's
        gid = torch.cat([new.new_zeros(1, dtype=torch.int64),
                         torch.cumsum(new, 0)])
        inverse = torch.empty_like(gid)
        inverse[perm] = gid
        faces = inverse.reshape(-1, 3)
        # drop degenerate faces (repeated welded vertices)
        ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
              & (faces[:, 0] != faces[:, 2]))
        kept = torch.cumsum(ok, 0)
        counts = torch.stack([gid[-1] + 1, kept[-1]])
        waited(counts)
        nv, nf = counts.tolist()
        # a group's first sorted row is its first occurrence (stable
        # sort), a kept face is where the running count of kept faces
        # first reaches its number: both without a host wait
        first = perm[torch.searchsorted(gid, torch.arange(nv, device=dev))]
        faces = faces[torch.searchsorted(
            kept, torch.arange(1, nf + 1, device=dev))]
        vertices, colors = v[first], c[first]
        # area-weighted vertex normals, numpy's products and sums one
        # rounding at a time; the float32 square root correctly rounded
        # through float64 (the CPU's float32 one is not)
        tri = vertices[faces]
        a, b = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        nrm = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                           a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                           a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)
        normals = torch.zeros_like(vertices)
        for k in range(3):
            normals.index_add_(0, faces[:, k], nrm)
        sq = normals * normals
        ln = torch.sqrt((sq[:, 0] + sq[:, 1] + sq[:, 2]).double())
        ln = ln.float()[:, None]
        normals = normals / torch.where(ln > 1e-12, ln, 1.0)
        drain(dev)
    with span("extract.to_host"):
        # one copy back: the float32 arrays' bits beside the int32 faces
        host = to_host(torch.cat([
            x.reshape(-1).view(torch.int32)
            for x in (vertices, colors, normals)]
            + [faces.to(torch.int32).reshape(-1)]))
    nv3 = 3 * nv
    vertices, colors, normals = (
        host[k * nv3:(k + 1) * nv3].view(np.float32).reshape(nv, 3)
        for k in range(3))
    return vertices, host[3 * nv3:].reshape(nf, 3), colors, normals


def _weld(v: np.ndarray, c: np.ndarray):
    """The welding itself, on host rows (3 a triangle) of vertices `v` and
    colours `c`."""
    if len(v) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
    key = np.round(v / 1e-5).astype(np.int64)
    uniq, index, inverse = np.unique(key, axis=0, return_index=True,
                                     return_inverse=True)
    vertices = v[index]
    colors = c[index]
    faces = inverse.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces (repeated welded vertices)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]
    # area-weighted vertex normals
    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normals = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(normals, faces[:, k], n)
    ln = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.where(ln > 1e-12, ln, 1.0)
    return (vertices.astype(np.float32), faces, colors.astype(np.float32),
            normals.astype(np.float32))
