"""K2's least time a step (one byte a pixel in, one out, at HBM's peak)
over its kernels' profiled time a step."""
from h100_bench.readers import roofline_pct


def read(m):
    return roofline_pct(m, "k2", ("K2_ccl", "K2_ccl3d"))
