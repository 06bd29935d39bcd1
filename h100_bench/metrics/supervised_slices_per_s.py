"""2D slices of the supervised step's batch trained over the window's
whole wall time, from the first step's dispatch to the synchronize()
after the last."""
from h100_bench.readers import rate


def read(m):
    return rate(m, "train")
