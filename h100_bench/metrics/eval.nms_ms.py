"""Host ms a volume inside the sliding-window engine's ``chap.sw.nms``
span (scipy's largest-CC of the label map), over the profiled stretch."""
from h100_bench.program_trace import host_ms, install

install()


def read(m):
    return host_ms(m, "chap.sw.nms")
