"""Device ms a step of the BatchNorm kernels, over the profiled stretch."""
from h100_bench.readers import class_ms


def read(m):
    return class_ms(m, "batchnorm")
