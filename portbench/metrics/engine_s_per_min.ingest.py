"""Engine: host seconds of segmentation, consolidate, caption, summary and checkpoint per media minute."""

from portbench.harness import readers


def read(record):
    return readers.layer_s_per_min(record, "engine_s")
