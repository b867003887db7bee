"""VLM: share of the MoE layer passes (each MoE layer once per prefill forward and once per decode step) that ran the routed experts' dispatch and combine kernels (Σ `moe.fused_passes` over Σ `moe.layer_passes`, each counted once per forward or decode loop)."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    if got is None or not got[1].get("moe.layer_passes") or "moe.fused_passes" not in got[1]:
        return None
    return 100.0 * got[1]["moe.fused_passes"] / got[1]["moe.layer_passes"]
