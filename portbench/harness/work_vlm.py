"""Kimi-VL-A3B-Instruct's operations and bytes, from the configuration
file's sizes; torch-free, as `work.py`.

Model FLOPs count real rows and real tokens only: MoonViT over each key
frame's patches, the prefill over each row's prompt (the unabsorbed MLA,
causal attention counted over its lower triangle, the vocabulary
projection at the last token), and each decode step over the real rows
(the absorbed MLA over the positions a row has, the vocabulary projection).
The fp32 router is float32 work, the rest bfloat16. A decode step's bytes
are what it has to read and write once: the weights of every layer but the
routed experts, the routed experts that got a row (the loop's count of
experts hit, spread evenly over its steps), the latent cache up to each
real row's position, and the real rows' fp32 logits.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.harness.work import HBM_BYTES_PER_S, PEAK_FLOPS


def vit_tokens(cfg: Dict, height: int, width: int) -> int:
    """MoonViT's patches of one image padded to whole merged tokens."""
    vc = cfg["vision_config"]
    m = vc["patch_size"] * vc["merge_kernel_size"][0]
    return (-(-height // m) * m // vc["patch_size"]) * (-(-width // m) * m // vc["patch_size"])


def vit_flops(cfg: Dict, n: int) -> float:
    """One image of n patches: patchify, the blocks, the merge projector."""
    vc = cfg["vision_config"]
    w, f, ps = vc["hidden_size"], vc["intermediate_size"], vc["patch_size"]
    pw = vc["projector_hidden_size"]
    m = n // (vc["merge_kernel_size"][0] * vc["merge_kernel_size"][1])
    block = 2.0 * n * w * 3 * w + 4.0 * n * n * w + 2.0 * n * w * w + 4.0 * n * w * f
    return 2.0 * n * 3 * ps * ps * w + vc["num_hidden_layers"] * block + 2.0 * m * pw * (pw + cfg["hidden_size"])


def _proj_flops(cfg: Dict) -> float:
    """One token's MLA projections in one layer (q, kv_a, kv_b, o)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, lora = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    return 2.0 * d * (h * (nope + rope) + lora + rope) + 2.0 * lora * h * (nope + vd) + 2.0 * h * vd * d


def _mlp_flops(cfg: Dict, layer: int) -> float:
    """One token's MLP in `layer`, bf16: the dense SwiGLU, or the routed
    experts it picks and the shared expert."""
    d = cfg["hidden_size"]
    if layer < cfg["first_k_dense_replace"]:
        return 6.0 * d * cfg["intermediate_size"]
    fe = cfg["moe_intermediate_size"]
    return 6.0 * d * fe * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])


def _router_flops(cfg: Dict) -> float:
    """One token's fp32 router over all MoE layers."""
    return 2.0 * cfg["hidden_size"] * cfg["n_routed_experts"] * (cfg["num_hidden_layers"] - cfg["first_k_dense_replace"])


def token_flops(cfg: Dict) -> float:
    """One token through every layer, bf16, attention itself left out."""
    return sum(_proj_flops(cfg) + _mlp_flops(cfg, i) for i in range(cfg["num_hidden_layers"]))


def prefill_flops(cfg: Dict, length: int) -> Dict[str, float]:
    """One row's prompt of `length` tokens, and the logits at its last."""
    h, L = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    qk, vd = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    attn = L * 2.0 * h * (qk + vd) * length * (length + 1) / 2
    head = 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
    return {"bfloat16": length * token_flops(cfg) + attn + head, "float32": length * _router_flops(cfg)}


def decode_token_flops(cfg: Dict, position: int) -> Dict[str, float]:
    """One real row's decode step at `position` (the absorbed MLA over
    position + 1 cached tokens) and its logits."""
    h, L = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    nope, rope, vd, lora = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    absorb = 2.0 * h * nope * lora + 2.0 * h * lora * vd  # W_UK into q, W_UV after
    attn = 2.0 * h * (lora + rope) * (position + 1) + 2.0 * h * lora * (position + 1)
    head = 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
    return {"bfloat16": token_flops(cfg) + L * (absorb + attn) + head, "float32": _router_flops(cfg)}


def expert_bytes(cfg: Dict) -> float:
    """One routed expert's bf16 weights (gate, up, down)."""
    return 2.0 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def step_weight_bytes(cfg: Dict) -> float:
    """A decode step's bf16 weights but the routed experts: every layer's
    MLA projections and norms, the dense MLP, the shared experts, the fp32
    routers and correction biases, the final norm and the lm_head."""
    d, L, h = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"]
    nope, rope, vd, lora = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    moe = L - cfg["first_k_dense_replace"]
    proj = d * h * (nope + rope) + d * (lora + rope) + lora * h * (nope + vd) + h * vd * d
    dense = 3 * d * cfg["intermediate_size"] * cfg["first_k_dense_replace"]
    shared = 3 * d * cfg["moe_intermediate_size"] * cfg["n_shared_experts"] * moe
    routers = 4.0 * moe * cfg["n_routed_experts"] * (d + 1)
    norms = 4.0 * (L * (2 * d + lora) + d)
    return 2.0 * (L * proj + dense + shared + d * cfg["vocab_size"]) + routers + norms


def latent_bytes(cfg: Dict) -> float:
    """One token's latent cache over all layers (bf16)."""
    return 2.0 * cfg["num_hidden_layers"] * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"])


def decode_loop(cfg: Dict, loop: Dict) -> Dict[str, float]:
    """A decode loop's model FLOPs by precision and the sum of its steps'
    bounds. `loop`: the program's record (rows launched, real rows, their
    prompt lengths and tokens decoded, steps, experts hit over its steps
    and layers by the rows still decoding). A real row counts at the steps
    before it reached <|im_end|>; a bucket's padding at none."""
    steps = loop["steps"]
    flops = {"bfloat16": 0.0, "float32": 0.0}
    bound = 0.0
    if steps <= 0:
        return {"flops": flops, "bound_s": bound}
    experts = loop["experts_hit"] / steps * expert_bytes(cfg)
    const = step_weight_bytes(cfg) + experts
    for s in range(steps):
        fl_b = fl_f = 0.0
        cache = 0.0
        live = 0
        for ln, dec in zip(loop["lengths"], loop["decoded"]):
            if s >= dec:  # the row's token at this step is <|im_end|>
                continue
            live += 1
            pos = ln + s  # the token a step reads sits one past the row's last
            f = decode_token_flops(cfg, pos)
            fl_b += f["bfloat16"]
            fl_f += f["float32"]
            cache += (pos + 1) * latent_bytes(cfg)
        nbytes = const + cache + 4.0 * live * cfg["vocab_size"]
        bound += max(fl_b / PEAK_FLOPS["bfloat16"] + fl_f / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S)
        flops["bfloat16"] += fl_b
        flops["float32"] += fl_f
    return {"flops": flops, "bound_s": bound}


def loops_work(cfg: Dict, loops: List[Dict]) -> Dict:
    """The prefill and decode FLOPs of a slice's generate loops, and the
    decode steps' summed bound."""
    flops = {"bfloat16": 0.0, "float32": 0.0}
    bound = 0.0
    for lp in loops:
        for ln in lp["lengths"]:
            for dt, v in prefill_flops(cfg, ln).items():
                flops[dt] += v
        d = decode_loop(cfg, lp)
        bound += d["bound_s"]
        for dt, v in d["flops"].items():
            flops[dt] += v
    return {"flops": flops, "decode_bound_s": bound}
