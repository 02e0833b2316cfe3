"""refine.window_ms: the program's `refine.window` spans (each pair's host
fetch of both clouds and auto_nn_window's host sizing, pipeline/
refine.py), summed per object, mean per object of the traced window, in
ms."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "refine.window")
