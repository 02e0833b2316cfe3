"""Map-quality evaluation protocol (counterpart of otslam_tpu/eval/metrics.py).

Mirrors the reference's eval scripts (eval_table_chair.py:90-119):
accuracy = mean NN distance map->GT in cm, completeness = mean NN distance
GT->map in cm.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from otslam_tpu_torch.device import resolve_device
from otslam_tpu_torch.kernels.nn import chamfer_metrics


@dataclass
class EvalMetrics:
    accuracy_cm: float       # mean(dist map->GT) * 100
    completeness_cm: float   # mean(dist GT->map) * 100
    icp_fitness: float = 1.0
    icp_rmse: float = 0.0


def _points(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def evaluate_map(map_points, gt_points, use_icp: bool = False,
                 device="cpu") -> EvalMetrics:
    """Accuracy and completeness of `map_points` against `gt_points`
    ((N, 3) arrays or tensors), computed on `device`."""
    if use_icp:
        raise NotImplementedError(
            "use_icp=True needs ICP and the windowed NN kernel K4, which "
            "arrive with the registration slice (ROADMAP M7)")
    dev = resolve_device(device)
    acc, comp = chamfer_metrics(_points(map_points, dev),
                                _points(gt_points, dev))
    return EvalMetrics(float(acc) * 100.0, float(comp) * 100.0)
