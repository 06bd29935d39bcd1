"""K1's least time a step (its bytes, counts/kernel_bytes.py, at HBM's
peak) over its kernels' profiled time a step."""
from h100_bench.readers import roofline_pct


def read(m):
    return roofline_pct(m, "k1", ("K1_fwd", "K1_bwd"))
