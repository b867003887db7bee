"""Kernels K2/K3 (both precisions): the MLP work's bound over their device time in the traced slice."""

from portbench.harness import readers


def read(record):
    return readers.roofline_pct(record, "mlp")
