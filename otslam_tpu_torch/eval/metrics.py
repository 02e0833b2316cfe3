"""Map-quality evaluation protocol (counterpart of otslam_tpu/eval/metrics.py).

Mirrors the reference's eval scripts (eval_table_chair.py:90-119):
accuracy = mean NN distance map->GT in cm, completeness = mean NN distance
GT->map in cm, with an optional point-to-point ICP snap of the GT onto the
map (threshold 0.05, identity init) before measuring.
"""

from __future__ import annotations

from dataclasses import dataclass

from otslam_tpu_torch.config import EvalConfig
from otslam_tpu_torch.device import resolve_device, to_f32
from otslam_tpu_torch.kernels.icp import icp_point_to_point
from otslam_tpu_torch.kernels.nn import auto_nn_window, chamfer_metrics


@dataclass
class EvalMetrics:
    accuracy_cm: float       # mean(dist map->GT) * 100
    completeness_cm: float   # mean(dist GT->map) * 100
    icp_fitness: float = 1.0
    icp_rmse: float = 0.0


def evaluate_map(map_points, gt_points, use_icp: bool = False,
                 cfg: EvalConfig | None = None, device="cuda") -> EvalMetrics:
    """Accuracy and completeness of `map_points` against `gt_points`
    ((N, 3) arrays or tensors), computed on `device`. use_icp=True first
    aligns the GT onto the map (refine_alignment_icp semantics) with the
    windowed correspondence search, sized on the host."""
    cfg = cfg or EvalConfig()
    dev = resolve_device(device)
    m = to_f32(map_points, dev)
    g = to_f32(gt_points, dev)
    fitness, rmse = 1.0, 0.0
    if use_icp:
        window, axis = auto_nn_window(g.cpu().numpy(), m.cpu().numpy(),
                                      cfg.icp_threshold)
        res = icp_point_to_point(
            g, m, threshold=cfg.icp_threshold,
            max_iterations=min(cfg.icp_max_iterations, 50),
            nn_window=window, nn_axis=axis)
        T = res.transformation
        g = g @ T[:3, :3].T + T[:3, 3]
        fitness, rmse = float(res.fitness), float(res.inlier_rmse)
    acc, comp = chamfer_metrics(m, g)
    return EvalMetrics(float(acc) * 100.0, float(comp) * 100.0, fitness,
                       rmse)
