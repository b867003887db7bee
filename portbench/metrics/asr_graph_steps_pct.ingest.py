"""ASR: share of the decode positions in the slice that replayed a captured CUDA graph of the greedy step instead of launching its kernels from the host (Σ `asr.graph_steps`, counted once per decode loop, over the `asr.decode_step` spans)."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or "asr.decode_step" not in got[0] or "asr.graph_steps" not in got[1]:
        return None
    return 100.0 * got[1]["asr.graph_steps"] / got[0]["asr.decode_step"][1]
