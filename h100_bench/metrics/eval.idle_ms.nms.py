"""Device idle ms a volume of the window while the host was in the
sliding-window engine's ``chap.sw.nms`` stage (the host's largest-CC);
program_trace.idle_ms says how it is scaled."""
from h100_bench.program_trace import idle_ms, install

install()


def read(m):
    return idle_ms(m, "chap.sw.nms")
