"""Selective 2D map merging.

Equivalent of fusion/2d_selective_merge.py: paste a region of a *new* PGM map
onto the *old* map, copying only pixels that carry information — anything in
the 205 +/- 5 unknown band is left untouched (2d_selective_merge.py:58-69).
The interactive rectangle-selection GUI becomes an explicit region API (and
``selective_merge`` accepts many regions at once).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from otslam_tpu_torch.config import MapConfig


def smart_paste(base_img: np.ndarray, overlay_img: np.ndarray,
                x: int, y: int, w: int, h: int,
                unknown_value: int = 205, threshold: int = 5) -> np.ndarray:
    """Paste overlay's known pixels within the rect onto base (in place);
    returns base. Rect fully outside the image is a no-op, exactly like the
    reference's bounds guard."""
    h_img, w_img = base_img.shape
    if x < 0 or y < 0 or x + w > w_img or y + h > h_img:
        return base_img
    roi_base = base_img[y:y + h, x:x + w]
    roi_new = overlay_img[y:y + h, x:x + w]
    has_data = (roi_new < (unknown_value - threshold)) | (
        roi_new > (unknown_value + threshold))
    roi_base[has_data] = roi_new[has_data]
    base_img[y:y + h, x:x + w] = roi_base
    return base_img


def selective_merge(old_img: np.ndarray, new_img: np.ndarray,
                    regions: Iterable[Tuple[int, int, int, int]],
                    cfg: MapConfig | None = None) -> np.ndarray:
    """Merge the given (x, y, w, h) regions of new_img into a copy of old_img.

    Shapes are reconciled like the reference (resize new to old) — here via
    nearest-neighbor sampling to avoid an OpenCV dependency in the core path.
    """
    cfg = cfg or MapConfig()
    out = old_img.copy()
    if new_img.shape != old_img.shape:
        ys = (np.arange(old_img.shape[0]) * new_img.shape[0]
              // old_img.shape[0])
        xs = (np.arange(old_img.shape[1]) * new_img.shape[1]
              // old_img.shape[1])
        new_img = new_img[ys][:, xs]
    for (x, y, w, h) in regions:
        out = smart_paste(out, new_img, int(x), int(y), int(w), int(h),
                          cfg.unknown_value, cfg.unknown_band)
    return out
