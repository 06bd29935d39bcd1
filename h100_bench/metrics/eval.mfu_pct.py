"""The forward FLOPs of a volume (FlopCounterMode over the plain
reference's sliding window) times the window's volumes, over the window,
as a share of the bf16 peak."""
from h100_bench.readers import BF16_PEAK, mfu_pct


def read(m):
    return mfu_pct(m, BF16_PEAK)
