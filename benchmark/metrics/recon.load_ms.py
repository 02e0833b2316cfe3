"""recon.load_ms: the program's `recon.load` span (reconstruct_object's
CaptureDataset.load_object: the files' bytes, the JPG and PNG decodes, the
float conversions, the poses and the stacking), mean per object of the
traced window, in ms. None where the program has no such span."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "recon.load")
