"""Random weights from the seed, made on the device in a few large calls.

The trees have the layout of the port's parameter dicts (the layout its
checkpoint loaders produce): matmul weights in the served compute dtype,
norms, biases, embeddings and convolution kernels in float32. Every leaf
is a view into one of two flat buffers, each filled by one `randn` call of
a generator seeded from `--seed`, then scaled group by group; a leaf starts
on a 128-element boundary so the kernels' TMA descriptors see aligned
operands. The program and the reference are handed these same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.harness.seeds import torch_seed

ALIGN = 128

# (path, shape, is_matmul_weight, std, shift): a leaf is shift + std · N(0, 1)
Leaf = Tuple[Tuple, Tuple[int, ...], bool, float, float]


def _ln(path, d) -> List[Leaf]:
    return [(path + ("weight",), (d,), False, 0.05, 1.0), (path + ("bias",), (d,), False, 0.02, 0.0)]


def _lin(path, d_in, d_out, bias=True) -> List[Leaf]:
    out = [(path + ("weight",), (d_out, d_in), True, 1.0 / math.sqrt(d_in), 0.0)]
    if bias:
        out.append((path + ("bias",), (d_out,), False, 0.02, 0.0))
    return out


def _ib_block(path, d, f, bias_kv) -> List[Leaf]:
    leaves = [
        (path + ("attn", "in_proj", "weight"), (3 * d, d), True, 1.0 / math.sqrt(d), 0.0),
        (path + ("attn", "in_proj", "bias"), (3 * d,), False, 0.02, 0.0),
        *_lin(path + ("attn", "out_proj"), d, d),
        *_lin(path + ("mlp", "fc1"), d, f),
        *_lin(path + ("mlp", "fc2"), f, d),
        *_ln(path + ("norm_1",), d),
        *_ln(path + ("norm_2",), d),
    ]
    if bias_kv:
        leaves += [(path + ("attn", "bias_k"), (1, 1, d), False, 0.02, 0.0),
                   (path + ("attn", "bias_v"), (1, 1, d), False, 0.02, 0.0)]
    return leaves


def imagebind_leaves(cfg: Dict) -> List[Leaf]:
    ib = cfg["imagebind"]
    v, a, t = ib["vision"], ib["audio"], ib["text"]
    p, e = ib["patch_size"], ib["embed_dim"]
    vtok = (ib["image_size"] // p) ** 2 + 1
    h = (ib["audio_mel_bins"] - ib["audio_kernel"]) // ib["audio_stride"] + 1
    w = (ib["audio_target_len"] - ib["audio_kernel"]) // ib["audio_stride"] + 1
    leaves: List[Leaf] = [
        (("vision", "patch_conv", "weight"), (v["width"], 3, 2, p, p), False,
         1.0 / math.sqrt(6 * p * p), 0.0),
        (("vision", "cls_token"), (1, 1, v["width"]), False, 0.02, 0.0),
        (("vision", "pos_embed"), (1, vtok, v["width"]), False, 0.02, 0.0),
        *_ln(("vision", "pre_ln"), v["width"]),
        *_ln(("vision", "head_ln"), v["width"]),
        *_lin(("vision", "head_proj"), v["width"], e, bias=False),
        (("audio", "patch_conv", "weight"), (a["width"], 1, ib["audio_kernel"], ib["audio_kernel"]),
         False, 1.0 / ib["audio_kernel"], 0.0),
        *_ln(("audio", "patch_norm"), a["width"]),
        (("audio", "cls_token"), (1, 1, a["width"]), False, 0.02, 0.0),
        (("audio", "pos_embed"), (1, h * w + 1, a["width"]), False, 0.02, 0.0),
        *_ln(("audio", "head_ln"), a["width"]),
        *_lin(("audio", "head_proj"), a["width"], e, bias=False),
        (("text", "token_embedding"), (ib["vocab_size"], t["width"]), False, 0.02, 0.0),
        (("text", "pos_embed"), (1, ib["context_length"], t["width"]), False, 0.01, 0.0),
        *_ln(("text", "final_ln"), t["width"]),
        *_lin(("text", "head_proj"), t["width"], e, bias=False),
    ]
    for name, tw, kv in (("vision", v, False), ("audio", a, True), ("text", t, False)):
        f = int(tw["width"] * tw["mlp_ratio"])
        for i in range(tw["depth"]):
            leaves += _ib_block((name, "blocks", i), tw["width"], f, kv)
    return leaves


def _wh_attn(path, d) -> List[Leaf]:
    return [*_lin(path + ("q_proj",), d, d), *_lin(path + ("k_proj",), d, d, bias=False),
            *_lin(path + ("v_proj",), d, d), *_lin(path + ("out_proj",), d, d)]


def whisper_leaves(cfg: Dict) -> List[Leaf]:
    w = cfg["whisper"]
    d, m = w["d_model"], w["num_mel_bins"]
    leaves: List[Leaf] = [
        (("encoder", "conv1", "weight"), (d, m, 3), False, 1.0 / math.sqrt(3 * m), 0.0),
        (("encoder", "conv1", "bias"), (d,), False, 0.02, 0.0),
        (("encoder", "conv2", "weight"), (d, d, 3), False, 1.0 / math.sqrt(3 * d), 0.0),
        (("encoder", "conv2", "bias"), (d,), False, 0.02, 0.0),
        *_ln(("encoder", "ln"), d),
        (("decoder", "token_embedding"), (w["vocab_size"], d), False, 0.02, 0.0),
        (("decoder", "pos_embed"), (w["max_target_positions"], d), False, 0.01, 0.0),
        *_ln(("decoder", "ln"), d),
    ]
    for side, n, ffn, cross in (("encoder", w["encoder_layers"], w["encoder_ffn_dim"], False),
                                ("decoder", w["decoder_layers"], w["decoder_ffn_dim"], True)):
        for i in range(n):
            base = (side, "blocks", i)
            leaves += [*_wh_attn(base + ("self_attn",), d), *_ln(base + ("self_ln",), d),
                       *_lin(base + ("mlp", "fc1"), d, ffn), *_lin(base + ("mlp", "fc2"), ffn, d),
                       *_ln(base + ("final_ln",), d)]
            if cross:
                leaves += [*_wh_attn(base + ("cross_attn",), d), *_ln(base + ("cross_ln",), d)]
    return leaves


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions."""
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _set(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(k, int):
            while len(node) <= k:
                node.append({})
            node = node[k]
            continue
        if k not in node:
            node[k] = [] if isinstance(nxt, int) else {}
        node = node[k]
    node[path[-1]] = value


@torch.no_grad()
def make_tree(leaves: List[Leaf], matmul_dtype: torch.dtype, seed: int, salt: int, device) -> Dict:
    """Two flat buffers (matmul weights in `matmul_dtype`, the rest fp32),
    one randn each, scaled per (std, shift) group; leaves are views."""
    tree: Dict = {}
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, salt))
    for want_mm, dtype in ((True, matmul_dtype), (False, torch.float32)):
        group = sorted((lf for lf in leaves if lf[2] == want_mm), key=lambda lf: (lf[3], lf[4]))
        offs, off = [], 0
        for lf in group:
            offs.append(off)
            off += -(-math.prod(lf[1]) // ALIGN) * ALIGN
        buf = torch.randn((off,), generator=g, device=device, dtype=dtype)
        lo = 0
        while lo < len(group):
            hi = lo
            while hi < len(group) and group[hi][3:] == group[lo][3:]:
                hi += 1
            end = offs[hi] if hi < len(group) else off
            buf[offs[lo]:end].mul_(group[lo][3]).add_(group[lo][4])
            lo = hi
        for lf, o in zip(group, offs):
            _set(tree, lf[0], buf[o:o + math.prod(lf[1])].view(lf[1]))
    return tree


def imagebind_params(cfg: Dict, seed: int, device) -> Dict:
    dtype = getattr(torch, cfg["imagebind_dtype"])
    tree = make_tree(imagebind_leaves(cfg), dtype, seed, 101, device)
    tree["text"]["logit_scale"] = torch.tensor(math.log(1 / 0.07), device=device)
    return tree


def whisper_params(cfg: Dict, seed: int, device) -> Dict:
    dtype = getattr(torch, cfg["whisper_dtype"])
    tree = make_tree(whisper_leaves(cfg), dtype, seed, 202, device)
    w = cfg["whisper"]
    tree["encoder"]["pos_embed"] = torch.from_numpy(
        sinusoids(w["max_source_positions"], w["d_model"])).to(device)
    return tree
