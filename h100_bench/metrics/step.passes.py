"""The program's ``chap.model.pass`` spans a step, over the profiled
stretch: the CHAP step's train-mode passes, each recomputation under
``optim.remat`` included."""
from h100_bench.program_trace import install, passes

install()


def read(m):
    return passes(m)
