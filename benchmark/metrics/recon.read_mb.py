"""recon.read_mb: the program's `load.bytes` counter (the bytes of the
colour, depth and pose files CaptureDataset.load_object read) over one
reconstruct_object call, mean per object of the traced window, in MB
(1e6 bytes). None where no object's record holds the counter."""

from benchmark.program import count_mean, records

NAME = "load.bytes"


def read(ctx):
    if not any(NAME in r.get("counts", {}) for r in records(ctx)):
        return None
    return 1e-6 * count_mean(ctx, NAME)
