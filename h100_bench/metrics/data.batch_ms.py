"""Device ms a step of the kernels launched inside the span around the
batch function (data/device_data.py), over the profiled stretch."""
from h100_bench.readers import span_ms


def read(m):
    return span_ms(m, "bench.data")
