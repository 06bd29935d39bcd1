"""K3's least time a volume (every patch's logits read once, at HBM's
peak) over its kernels' profiled time a volume."""
from h100_bench.readers import roofline_pct


def read(m):
    return roofline_pct(m, "k3", ("K3_sw",))
