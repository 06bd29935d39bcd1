"""Device operations (kernels, copies, fills) a step whose launching
runtime call, on any thread, fell inside the program's ``chap.step`` span,
over the profiled stretch."""
from h100_bench.program_trace import install, step_launches

install()


def read(m):
    return step_launches(m)
