"""Result reporting: summary table and bar charts (counterpart of
otslam_tpu/eval/report.py).

Equivalent of eval/result_plot.py (grouped accuracy/completeness bars and the
map-file-size comparison) and the eval scripts' summary printout
(eval_table_chair.py:170-174). Host code; matplotlib is imported only by
``plot_results``.
"""

from __future__ import annotations

import os
from typing import Mapping

from otslam_tpu_torch.eval.metrics import EvalMetrics

REFERENCE_RESULTS = {
    # published numbers from eval/result_plot.py:8-18
    "accuracy_cm": {
        "Table & Chair": {"proposal": 2.63, "rtabmap": 5.50},
        "Cone": {"proposal": 2.48, "rtabmap": 4.73},
        "Cardboard Box": {"proposal": 4.15, "rtabmap": 5.52},
    },
    "completeness_cm": {
        "Table & Chair": {"proposal": 8.59, "rtabmap": 2.47},
        "Cone": {"proposal": 4.18, "rtabmap": 1.45},
        "Cardboard Box": {"proposal": 4.39, "rtabmap": 3.33},
    },
    "map_size_mb": {"proposal": 1.7, "rtabmap": 169.0},
}


def print_summary_table(results: Mapping[str, EvalMetrics],
                        baseline: Mapping[str, EvalMetrics] | None = None) -> str:
    lines = [f"{'Scenario':<16} | {'Accuracy':>10} | {'Completeness':>13}"]
    lines.append("-" * 47)
    for name, m in results.items():
        row = f"{name:<16} | {m.accuracy_cm:>8.2f}cm | {m.completeness_cm:>11.2f}cm"
        if baseline and name in baseline:
            b = baseline[name]
            row += (f"   (baseline {b.accuracy_cm:.2f} / "
                    f"{b.completeness_cm:.2f})")
        lines.append(row)
    out = "\n".join(lines)
    print(out)
    return out


def plot_results(results: Mapping[str, EvalMetrics], out_path: str,
                 baseline: Mapping[str, Mapping[str, float]] | None = None
                 ) -> str:
    """Grouped bar charts (accuracy + completeness), saved as a PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    names = list(results.keys())
    acc = [results[n].accuracy_cm for n in names]
    comp = [results[n].completeness_cm for n in names]
    x = np.arange(len(names))
    width = 0.35

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for ax, vals, title in ((axes[0], acc, "Accuracy (cm, lower better)"),
                            (axes[1], comp, "Completeness (cm, lower better)")):
        ax.bar(x - (width / 2 if baseline else 0), vals, width,
               label="otslam_tpu_torch")
        if baseline:
            key = "accuracy_cm" if "Accuracy" in title else "completeness_cm"
            bvals = [baseline[key].get(n, {}).get("proposal", np.nan)
                     for n in names]
            ax.bar(x + width / 2, bvals, width, label="reference")
        ax.set_xticks(x)
        ax.set_xticklabels(names, rotation=15)
        ax.set_title(title)
        ax.legend()
        ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
