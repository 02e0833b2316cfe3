"""recon.weld_ms: the program's `extract.weld` span (the mesh's host weld:
numpy unique over the quantized vertices, faces, area-weighted normals),
mean per object of the traced window, in ms."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "extract.weld")
