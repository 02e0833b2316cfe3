"""refine.model_ms: the program's `refine.model` spans (each frame fused
alone into the frame-to-model tracker's model, frame 0's with the model's
allocation, each ending in a drain; pipeline/refine.py
refine_trajectory_f2m), summed per object, mean per object of the traced
window, in ms."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "refine.model")
