"""max_memory_allocated() over the window, after a reset at its start."""
from h100_bench.readers import peak_mem_gib


def read(m):
    return peak_mem_gib(m)
