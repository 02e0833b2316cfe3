"""recon.upload_ms: the program's `fuse.upload` span (fuse_frames' copy of
the host frames and poses to the card: pageable, with a host wait each),
mean per object of the traced window, in ms."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "fuse.upload")
