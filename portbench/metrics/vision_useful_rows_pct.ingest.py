"""Towers: share of the vision tower rows launched (the 32-row chunks, every candidate the 30 fps path streams) whose features the engine keeps: the key frames it indexes (`vision.rows_kept` over `vision.rows_launched`)."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or not {"vision.rows_kept", "vision.rows_launched"} <= got[1].keys():
        return None
    return 100.0 * got[1]["vision.rows_kept"] / got[1]["vision.rows_launched"]
