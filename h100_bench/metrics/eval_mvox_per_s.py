"""Voxels of the volumes whose label maps reached the host, in millions,
over the window's whole wall time."""
from h100_bench.readers import rate


def read(m):
    return rate(m, "sliding_window_eval", 1e6)
