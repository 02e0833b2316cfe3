"""Share of the traced stretch with no kernel or copy on the card, in %
(the union of the device intervals against the stretch's length)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("trace_sound") or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
