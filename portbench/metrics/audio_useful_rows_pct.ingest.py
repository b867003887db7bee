"""Towers: share of the audio tower rows launched (the 32-segment chunks) that hold a real segment (`audio.rows_real` over `audio.rows_launched`)."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or not {"audio.rows_real", "audio.rows_launched"} <= got[1].keys():
        return None
    return 100.0 * got[1]["audio.rows_real"] / got[1]["audio.rows_launched"]
