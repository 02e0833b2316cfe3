"""Real-vs-virtual scan differencing, the change detection core
(counterpart of otslam_tpu/kernels/scan_diff.py).

Behavioral contract from diff_node.cpp:102-158:

* NEW: a real return (finite, <= range_max) with no virtual return within
  ``distance_threshold`` (Euclidean, in the sensor frame) inside a +/- W
  beam window.
* REMOVED: a virtual return (finite) with no real return within the window.

The window is exactly the reference's: j in [max(0, i-W), min(N, i+W)), the
right edge i+W excluded. It is built from 2W shifted copies of the padded
beam arrays (`unfold` over a padded row), so a leading batch axis of K
scans is one call.
"""

from __future__ import annotations

import torch


def _beam_xy(ranges, angles):
    return ranges * torch.cos(angles), ranges * torch.sin(angles)


def _window(q: torch.Tensor, W: int, fill) -> torch.Tensor:
    """(..., N, 2W) where [..., i, o] holds q[..., i + o - W], `fill`
    beyond the edges."""
    n = q.shape[-1]
    qp = torch.nn.functional.pad(q, (W, W), value=fill)
    return qp.unfold(-1, 2 * W, 1)[..., :n, :]


def scan_diff(real_ranges: torch.Tensor, virtual_ranges: torch.Tensor,
              angles: torch.Tensor, range_max: float,
              distance_threshold: float = 0.5, search_window: int = 20):
    """(new_mask, removed_mask), each (..., N) bool over beams. Ranges are
    (N,) or (K, N) (one scan diff per row); angles (N,)."""
    W = search_window
    real_finite = torch.isfinite(real_ranges) & (real_ranges <= range_max)
    virt_finite = torch.isfinite(virtual_ranges)
    rx, ry = _beam_xy(real_ranges, angles)
    vx, vy = _beam_xy(virtual_ranges, angles)
    thr2 = distance_threshold * distance_threshold

    def near_in_window(px, py, qx, qy, qvalid):
        """Any valid q within the threshold of p_i in its window; window
        slots beyond the edges carry qvalid=False via the padding,
        reproducing the C++ edge clamping."""
        qxw = _window(qx, W, 0.0)
        qyw = _window(qy, W, 0.0)
        qvw = _window(qvalid, W, False)
        d2 = (px[..., None] - qxw) ** 2 + (py[..., None] - qyw) ** 2
        return (qvw & (d2 < thr2)).any(dim=-1)

    near_wall = near_in_window(rx, ry, vx, vy, virt_finite)
    new_mask = real_finite & ~near_wall
    wall_alive = near_in_window(vx, vy, rx, ry, real_finite)
    removed_mask = virt_finite & ~wall_alive
    return new_mask, removed_mask
