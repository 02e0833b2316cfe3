"""refine.icp_ms: the program's `refine.icp` spans (each frame pair's
annealed point-to-plane ICP, pipeline/refine.py), summed per object, mean
per object of the traced window, in ms."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "refine.icp")
