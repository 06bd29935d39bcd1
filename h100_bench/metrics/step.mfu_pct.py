"""The step's FLOPs (FlopCounterMode over the plain reference's step, no
recomputation) times the window's steps, over the window, as a share of
the peak of the configuration's precision (counts/peaks.py)."""
from h100_bench.readers import mfu_pct


def read(m):
    return mfu_pct(m)
