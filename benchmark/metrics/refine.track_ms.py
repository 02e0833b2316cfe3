"""refine.track_ms: the program's `refine.track` spans (each tracked
frame's frame-to-model Gauss-Newton solve on the model fused so far, to
its pose fetch; pipeline/refine.py refine_trajectory_f2m), summed per
object, mean per object of the traced window, in ms."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "refine.track")
