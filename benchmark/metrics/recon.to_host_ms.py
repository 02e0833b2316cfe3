"""recon.to_host_ms: the program's `extract.to_host` and `extract.floor`
spans (the sampled cloud's copies to the host and the floor filter in
numpy), summed per object, mean per object of the traced window, in ms."""

from benchmark.program import span_ms


def read(ctx):
    return span_ms(ctx, "extract.to_host", "extract.floor")
