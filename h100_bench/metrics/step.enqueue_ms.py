"""Median host ms for a step call to return, without a sync, over the
traced run's window: where it nears the step's device time, the host
sets the pace."""
from h100_bench.readers import enqueue_ms


def read(m):
    return enqueue_ms(m)
