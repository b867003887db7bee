"""Device: share of the traced slice with no device operation running."""

from portbench.harness import readers


def read(record):
    return readers.idle_pct(record)
