"""objects_per_s: objects whose reconstruct_frames returned, with the
result on the host, over all the window's time (host clock)."""


def read(ctx):
    if "latencies" not in ctx or ctx["window_s"] <= 0:
        return None
    return ctx["completed"] / ctx["window_s"]
