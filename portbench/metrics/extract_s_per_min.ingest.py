"""Ingest CLI and readers: host seconds of the top-level extract_* stages (decode, score, seg_ssim, jpeg_save) per media minute, less the hand-off of key frames to the vision tower's stream."""

from portbench.harness import readers


def read(record):
    return readers.layer_s_per_min(record, "extract_s")
