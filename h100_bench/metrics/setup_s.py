"""Seconds from the process's start to the window's first dispatch:
imports, the kernels' build or load, the pool and weights made from the
seed, the checked steps and the warm-up."""


def read(m):
    return m.setup_s
