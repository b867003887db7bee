"""ASR: host seconds of the transcribe stage per media minute."""

from portbench.harness import readers


def read(record):
    return readers.layer_s_per_min(record, "transcribe_s")
