"""Ingest CLI and readers: host milliseconds a frame of the Y4M reader's RGB fetch, file reads and YUV420→RGB together (Σ `media.y4m_rgb` span seconds over Σ `media.y4m_rgb_frames`)."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or "media.y4m_rgb" not in got[0] or not got[1].get("media.y4m_rgb_frames"):
        return None
    return 1000.0 * got[0]["media.y4m_rgb"][0] / got[1]["media.y4m_rgb_frames"]
