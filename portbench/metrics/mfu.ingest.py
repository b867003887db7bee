"""Model step: the slice's model FLOPs, each precision over its peak, over the slice's seconds."""

from portbench.harness import readers


def read(record):
    return readers.mfu_pct(record)
