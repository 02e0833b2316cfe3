"""recon.syncs: the program's `syncs` counter (the host waits it makes on
the card: counts fetched, work-list checks, compactions and copies) over
one reconstruct_frames call, mean per object of the traced window."""

from benchmark.program import count_mean


def read(ctx):
    return count_mean(ctx, "syncs")
