"""Temporal evidence grids with dwell accumulation and decay (counterpart of
otslam_tpu/kernels/evidence.py).

Behavioral contract from diff_node.cpp:169-185 (``updateGrid``): cells hit
this scan accumulate dt of dwell (saturating at 1.5 x time_threshold); cells
not hit decay by decay_rate x dt and are erased at <= 0. Cells with dwell
above time_threshold are emitted as points at the cell centers
(key * res + res/2), where key = trunc(coord / res) toward zero
(diff_node.cpp:126, C integer-cast semantics).

The C++ hash map becomes a dense (GH, GW) grid centred on the world origin;
hits are a boolean scatter into the grid plus one dead slot, the dwell
update one elementwise pass.
"""

from __future__ import annotations

import math

import torch


def world_to_key(x: torch.Tensor, y: torch.Tensor, resolution: float):
    """Truncating cell keys, matching the C++ ``(int)(p.x / res)`` cast."""
    res = torch.tensor(resolution, dtype=torch.float32, device=x.device)
    return (x / res).to(torch.int32), (y / res).to(torch.int32)


def scatter_hits(grid_shape_ref: torch.Tensor, xs: torch.Tensor,
                 ys: torch.Tensor, mask: torch.Tensor,
                 resolution: float) -> torch.Tensor:
    """Boolean hit grid(s) from world points. grid_shape_ref: a (GH, GW)
    tensor whose shape defines the grid; cell (0, 0) of the world maps to
    the centre. xs, ys, mask are (N,) for one grid or (K, N) for K grids
    (returns (K, GH, GW))."""
    GH, GW = grid_shape_ref.shape[-2:]
    kx, ky = world_to_key(xs, ys, resolution)
    gx = kx + GW // 2
    gy = ky + GH // 2
    inb = mask & (gx >= 0) & (gx < GW) & (gy >= 0) & (gy < GH)
    lead = xs.shape[:-1]
    k = math.prod(lead)
    base = (torch.arange(k, device=xs.device) * (GH * GW)).reshape(
        *lead, 1) if lead else 0
    dead = k * GH * GW                          # out-of-range -> dead slot
    flat = torch.where(inb, base + gy.long() * GW + gx.long(), dead)
    hits = torch.zeros(dead + 1, dtype=torch.bool, device=xs.device)
    hits.index_put_((flat.reshape(-1),),
                    torch.ones((), dtype=torch.bool, device=xs.device))
    return hits[:-1].reshape(*lead, GH, GW)


def update_evidence(dwell: torch.Tensor, hits: torch.Tensor, dt,
                    time_threshold: float, decay_rate: float) -> torch.Tensor:
    """One dwell/decay step (diff_node.cpp:169-185)."""
    grown = torch.clamp(dwell + dt, max=1.5 * time_threshold)
    decayed = torch.clamp(dwell - decay_rate * dt, min=0.0)
    return torch.where(hits, grown, torch.where(dwell > 0, decayed, 0.0))


def evidence_points(dwell: torch.Tensor, resolution: float,
                    time_threshold: float):
    """Cell-centre world coordinates of confident cells.

    Returns (points (GH*GW, 2), mask): points padded, compacted by mask.
    Centre = key * res + res/2 with the signed key (diff_node.cpp:213-214).
    """
    GH, GW = dwell.shape
    dev = dwell.device
    conf = dwell > time_threshold
    ky = torch.arange(GH, device=dev)[:, None] - GH // 2
    kx = torch.arange(GW, device=dev)[None, :] - GW // 2
    cx = cell_centers(kx, resolution)
    cy = cell_centers(ky, resolution)
    pts = torch.stack([cx.expand(GH, GW).reshape(-1),
                       cy.expand(GH, GW).reshape(-1)], dim=-1)
    return pts, conf.reshape(-1)


def cell_centers(keys: torch.Tensor, resolution: float) -> torch.Tensor:
    """f32 key * res + res/2 with one rounding, as the JAX package's XLA
    path computes it (a fused multiply-add of f32 operands): the product
    and sum are exact in float64 for grid-sized keys, then rounded once."""
    res = float(torch.tensor(resolution, dtype=torch.float32))
    half = float(torch.tensor(resolution / 2.0, dtype=torch.float32))
    return (keys.to(torch.float64) * res + half).to(torch.float32)
