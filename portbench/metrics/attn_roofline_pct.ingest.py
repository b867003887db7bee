"""Kernels K1/K4 (both precisions): the attention work's bound over the flash kernels' device time in the traced slice."""

from portbench.harness import readers


def read(record):
    return readers.roofline_pct(record, "attn")
