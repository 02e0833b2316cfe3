"""refine.graph_ms: the program's `refine.graph` span (the pose graph's
edges uploaded, its Gauss-Newton solve and the poses' copy home;
pipeline/refine.py _pgo_poses), mean per object of the traced window, in
ms."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "refine.graph")
