"""mission.control_pct: the mission loop's self time (the host control
plane): the traced missions' time less the perception, localization and
sensor spans, as a share of it, in %."""


def read(ctx):
    sp = ctx.get("spans")
    if not sp or ctx.get("mission_s", 0) <= 0:
        return None
    spent = sum(sp.total.get(k, 0.0)
                for k in ("perception", "localize", "sensors"))
    return 100.0 * (ctx["mission_s"] - spent) / ctx["mission_s"]
