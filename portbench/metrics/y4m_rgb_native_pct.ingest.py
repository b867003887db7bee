"""Ingest CLI and readers: share of the Y4M frames fetched as RGB that the native YUV420→RGB call converted rather than numpy (`media.y4m_rgb_native_frames` over `media.y4m_rgb_frames`)."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or "media.y4m_rgb_native_frames" not in got[1] or not got[1].get("media.y4m_rgb_frames"):
        return None
    return 100.0 * got[1]["media.y4m_rgb_native_frames"] / got[1]["media.y4m_rgb_frames"]
