"""Ingest CLI and readers: share of the traced slice in which the engine thread waits on the next video's extraction (the `ingest.extract_wait` spans)."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or "ingest.extract_wait" not in got[0]:
        return None
    return 100.0 * got[0]["ingest.extract_wait"][0] / record["trace"].window_s
