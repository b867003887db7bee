"""Towers: host seconds per media minute of the vision stream's worker (resize and launches), the hand-off of key frames to it, and the engine's encode_vision and encode_audio stages."""

from portbench.harness import readers


def read(record):
    return readers.layer_s_per_min(record, "encode_s")
