"""Device idle ms a step of the window while the host was in the step's
``chap.step.gradsim`` phase (GradSim: the labeled and unlabeled
gradients of the level weights); program_trace.idle_ms says how it is
scaled."""
from h100_bench.program_trace import idle_ms, install

install()


def read(m):
    return idle_ms(m, "chap.step.gradsim")
