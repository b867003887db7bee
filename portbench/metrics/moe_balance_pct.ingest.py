"""VLM: balance of the routed experts, Σ `moe.rows_routed` over (experts × Σ `moe.rows_busiest`), each summed over layers and forwards on the device and counted once per loop: 100 when every expert takes as many rows as the busiest."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    experts = (record.get("vlm") or {}).get("experts")
    if got is None or not experts or not got[1].get("moe.rows_busiest") or "moe.rows_routed" not in got[1]:
        return None
    return 100.0 * got[1]["moe.rows_routed"] / (experts * got[1]["moe.rows_busiest"])
