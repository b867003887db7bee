"""VLM: host seconds of the engine's caption and summary stages (Kimi-VL in process) per media minute."""

from portbench.harness import readers


def read(record):
    return readers.layer_s_per_min(record, "vlm_s")
