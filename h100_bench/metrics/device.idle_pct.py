"""The share of the traced run's window in which no device operation
ran: 100 minus the busy seconds (readers.busy_s) over the window."""
from h100_bench.readers import idle_pct


def read(m):
    return idle_pct(m)
