"""recon.refine_ms: the program's `recon.refine` span (the pose refiner,
pipeline/refine.py, ending in a drain) from reconstruct_frames(timings=)'s
record, mean per object of the traced window, in ms."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "recon.refine")
