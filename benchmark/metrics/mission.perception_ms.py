"""mission.perception_ms: the benchmark's span around each call of the
program's perception step (a device sync before and after), mean per call over
the traced missions, in ms."""


def read(ctx):
    sp = ctx.get("spans")
    if not sp or not sp.calls.get("perception"):
        return None
    return 1e3 * sp.total["perception"] / sp.calls["perception"]
