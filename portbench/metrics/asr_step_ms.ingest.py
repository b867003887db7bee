"""ASR: host milliseconds of one greedy or beam decode position (the `asr.decode_step` spans: launches and the read of the exit flag)."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or "asr.decode_step" not in got[0]:
        return None
    s, k = got[0]["asr.decode_step"]
    return 1000.0 * s / k
