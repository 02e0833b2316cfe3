"""recon.decode_ms: the program's `load.decode` spans (each frame's JPG and
PNG decodes, inside `recon.load`), summed per object, mean per object of
the traced window, in ms. None where the program has no such span."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "load.decode")
