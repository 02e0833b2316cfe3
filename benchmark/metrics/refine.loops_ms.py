"""refine.loops_ms: the program's `refine.loops` span (the loop-closure
candidates' search on the host and each one's verification by pair ICP;
pipeline/refine.py detect_loop_closures under _pgo_poses), mean per
object of the traced window, in ms."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "refine.loops")
