"""Kimi-VL-A3B-Instruct's random weights from the seed, made on the device
in two `randn` calls (`weights.make_tree`), in the layout of the port's
`models/kimi_vl` (each SwiGLU's gate and up as one matrix, blocks and
layers as lists), from the configuration file's sizes."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.harness.weights import Leaf, make_tree

# norms 1 + N(0, 0.05²); the router's correction bias N(0, 0.1²), non-zero
NORM_STD, SCORE_BIAS_STD = 0.05, 0.1


def kimi_vl_leaves(cfg: Dict) -> List[Leaf]:
    std = cfg["initializer_range"]
    vc = cfg["vision_config"]
    w, ps, f, g = vc["hidden_size"], vc["patch_size"], vc["intermediate_size"], vc["init_pos_emb_height"]
    pw = vc["projector_hidden_size"]
    d, h, vocab = cfg["hidden_size"], cfg["num_attention_heads"], cfg["vocab_size"]
    nope, rope, vd, lora = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    e, fe = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * fe

    def mm(path, shape):
        return (path, shape, True, std, 0.0)

    def vec(path, shape, s=std):
        return (path, shape, False, s, 0.0)

    def norm(path, n):
        return (path, (n,), False, NORM_STD, 1.0)

    def ln(path, n):
        return [norm(path + ("weight",), n), vec(path + ("bias",), (n,))]

    def lin(path, n_in, n_out):
        return [mm(path + ("weight",), (n_out, n_in)), vec(path + ("bias",), (n_out,))]

    leaves = [*lin(("vision", "patch"), 3 * ps * ps, w), vec(("vision", "pos_emb"), (g, vc["init_pos_emb_width"], w))]
    for i in range(vc["num_hidden_layers"]):
        b = ("vision", "blocks", i)
        leaves += [*ln(b + ("norm0",), w), *lin(b + ("qkv",), w, 3 * w), *lin(b + ("proj",), w, w),
                   *ln(b + ("norm1",), w), *lin(b + ("fc0",), w, f), *lin(b + ("fc1",), f, w)]
    leaves += [*ln(("vision", "final_norm"), w), *ln(("projector", "pre_norm"), w),
               *lin(("projector", "linear_1"), pw, pw), *lin(("projector", "linear_2"), pw, d),
               mm(("embed",), (vocab, d)), norm(("norm",), d), mm(("lm_head",), (vocab, d))]
    for i in range(cfg["num_hidden_layers"]):
        b = ("layers", i)
        leaves += [norm(b + ("input_norm",), d), mm(b + ("q_proj",), (h * (nope + rope), d)),
                   mm(b + ("kv_a",), (lora + rope, d)), norm(b + ("kv_norm",), lora),
                   mm(b + ("kv_b",), (h * (nope + vd), lora)), mm(b + ("o_proj",), (d, h * vd)),
                   norm(b + ("post_norm",), d)]
        if i < cfg["first_k_dense_replace"]:
            fd = cfg["intermediate_size"]
            leaves += [mm(b + ("mlp", "gate_up"), (2 * fd, d)), mm(b + ("mlp", "down"), (d, fd))]
        else:
            leaves += [vec(b + ("moe", "router"), (e, d)), vec(b + ("moe", "bias"), (e,), SCORE_BIAS_STD),
                       mm(b + ("moe", "gate_up"), (e, 2 * fe, d)), mm(b + ("moe", "down"), (e, d, fe)),
                       mm(b + ("moe", "shared", "gate_up"), (2 * fs, d)), mm(b + ("moe", "shared", "down"), (d, fs))]
    return leaves


def kimi_vl_params(cfg: Dict, seed: int, device) -> Dict:
    return make_tree(kimi_vl_leaves(cfg), getattr(torch, cfg["vlm_dtype"]), seed, 404, device)
