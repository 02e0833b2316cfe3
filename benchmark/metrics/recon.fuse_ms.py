"""recon.fuse_ms: the program's 'fuse' stage seconds from
reconstruct_frames(timings=) (each stage ends in a device sync), mean per
object of the traced window, in ms."""


def read(ctx):
    st = [t["fuse"] for t in ctx.get("stages", []) if "fuse" in t]
    return 1e3 * sum(st) / len(st) if st else None
