"""ASR: host milliseconds a decode position spends outside its read of the exit flag, per step (the `asr.decode_step` spans less the `asr.read_wait` spans nested in them): its launches, and any wait for the interpreter lock that the extraction and vision threads of the same process hold meanwhile."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or "asr.decode_step" not in got[0] or "asr.read_wait" not in got[0]:
        return None
    step_s, k = got[0]["asr.decode_step"]
    return 1000.0 * (step_s - got[0]["asr.read_wait"][0]) / k
