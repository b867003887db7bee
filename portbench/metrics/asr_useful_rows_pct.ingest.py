"""ASR: share of the Whisper chunk rows launched (the 4 / 16 / 32-row buckets) that hold a real 30 s window (`asr.chunks_real` over `asr.chunks_launched`)."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or not {"asr.chunks_real", "asr.chunks_launched"} <= got[1].keys():
        return None
    return 100.0 * got[1]["asr.chunks_real"] / got[1]["asr.chunks_launched"]
