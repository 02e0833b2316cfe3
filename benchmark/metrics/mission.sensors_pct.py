"""mission.sensors_pct: the spans around the program's sensors (LiDAR
renders, RGB-D renders and the capture writes) as a share of the traced
missions' time, in %."""


def read(ctx):
    sp = ctx.get("spans")
    if not sp or ctx.get("mission_s", 0) <= 0:
        return None
    return 100.0 * sp.total.get("sensors", 0.0) / ctx["mission_s"]
