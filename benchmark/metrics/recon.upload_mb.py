"""recon.upload_mb: the program's `h2d_bytes` counter (bytes copied from
host memory to the card) over one reconstruct_frames call, mean per object
of the traced window, in MB (1e6 bytes)."""

from benchmark.program import count_mean


def read(ctx):
    n = count_mean(ctx, "h2d_bytes")
    return None if n is None else 1e-6 * n
