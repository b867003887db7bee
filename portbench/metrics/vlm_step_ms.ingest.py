"""VLM: milliseconds of one greedy decode position, whole loops timed (Σ `vlm.decode` spans, each closed after its tokens reach the host, over the `vlm.decode_step` positions)."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or "vlm.decode" not in got[0] or "vlm.decode_step" not in got[0]:
        return None
    return 1000.0 * got[0]["vlm.decode"][0] / got[0]["vlm.decode_step"][1]
