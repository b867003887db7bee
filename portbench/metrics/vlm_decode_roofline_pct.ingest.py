"""VLM: Σ each decode step's bound (bytes of the weights read, the experts hit, the latent cache to each row's position and the logits; FLOPs of the real rows) over Σ `vlm.decode`, whole loops timed."""

from portbench.harness import spans


def read(record):
    got = spans.in_slice(record)
    bound = (record.get("work") or {}).get("vlm_decode_bound_s")
    if got is None or not bound or "vlm.decode" not in got[0]:
        return None
    return 100.0 * bound / got[0]["vlm.decode"][0]
