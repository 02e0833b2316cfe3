"""mission.localize_ms: the benchmark's span around each call of the
program's localize step (a device sync before and after), mean per call over
the traced missions, in ms."""


def read(ctx):
    sp = ctx.get("spans")
    if not sp or not sp.calls.get("localize"):
        return None
    return 1e3 * sp.total["localize"] / sp.calls["localize"]
