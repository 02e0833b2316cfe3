"""recon.auto_volume_ms: the program's 'auto_volume' stage seconds from
reconstruct_frames(timings=) (each stage ends in a device sync), mean per
object of the traced window, in ms."""


def read(ctx):
    st = [t["auto_volume"] for t in ctx.get("stages", []) if "auto_volume" in t]
    return 1e3 * sum(st) / len(st) if st else None
