"""VLM: share of the decode rows launched that were real rows and not a bucket's padding (Σ `vlm.rows_real` over Σ `vlm.rows_launched`, each counted once per loop)."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or not got[1].get("vlm.rows_launched") or "vlm.rows_real" not in got[1]:
        return None
    return 100.0 * got[1]["vlm.rows_real"] / got[1]["vlm.rows_launched"]
