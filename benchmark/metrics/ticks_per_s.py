"""ticks_per_s: every perception tick of the missions the window ran over
all their time (host clock); the mission running at the window's end runs
to its end and counts."""


def read(ctx):
    if "ticks" not in ctx or ctx["mission_s"] <= 0:
        return None
    return ctx["ticks"] / ctx["mission_s"]
