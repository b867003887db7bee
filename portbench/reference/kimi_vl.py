"""Plain float32 forward of Kimi-VL-A3B-Instruct: MoonViT, the projector and
the DeepSeek-V3-style language model (MLA, sigmoid-routed experts), with no
cache, no batching buckets, no graphs and no kernel of the port.

Written from the published equations (the model's config.json and
modeling code; MoonViT from the Kimi-VL report, arXiv:2504.07491). Sizes
come from a dict with config.json's key names (`vision_config` for
MoonViT). Every product goes through `mm(a, b)`: float32 with TF32 off by
default; a caller may pass a rounding product (a lower-precision control).
Departures from the published code, none of which changes a number:
  * each SwiGLU's gate and up projections are one (2F, D) matrix, gate
    rows first (the published layout keeps two);
  * RoPE rotates interleaved pairs in place; the published code first
    de-interleaves q_pe and k_pe into halves, the same permutation of both,
    so every q·k is the same;
  * MoonViT packs images of any size into one sequence with per-image
    attention; here a batch holds images of one size, each attending
    within itself;
  * images are padded at the right and bottom to a multiple of
    patch × merge pixels in place of the published processor's resize.
Attention runs over heads in blocks, so a long sequence fits on a card.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# bytes of one block of attention scores
SCORE_BYTES = 1 << 31


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def _linear(mm: Mm, x, w, b=None):
    y = mm(x, w.float().t())
    return y if b is None else y + b.float()


def _layer_norm(p: Dict, x, eps: float):
    return F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps)


def _rms_norm(w, x, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _rotate_pairs(x, angles):
    """Rotate pairs (x[2i], x[2i+1]) by angles[..., i]."""
    a, b = x[..., 0::2], x[..., 1::2]
    c, s = angles.cos(), angles.sin()
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).flatten(-2)


def _attend(mm: Mm, q, k, v, scale: float, causal: bool):
    """softmax(q·kᵀ·scale) v per head, over blocks of heads; q (B, H, T, d),
    k (B, H, S, d), v (B, H, S, dv)."""
    b, h, t, _ = q.shape
    s = k.shape[2]
    step = max(1, SCORE_BYTES // (4 * b * t * s))
    mask = torch.ones(t, s, dtype=torch.bool, device=q.device).tril(s - t) if causal else None
    outs = []
    for lo in range(0, h, step):
        logits = mm(q[:, lo:lo + step], k[:, lo:lo + step].transpose(-1, -2)) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        outs.append(mm(torch.softmax(logits, dim=-1), v[:, lo:lo + step]))
        del logits
    return torch.cat(outs, dim=1)


# ------------------------------------------------------------------ MoonViT


def vision_forward(params: Dict, cfg: Dict, pixels: torch.Tensor, mm: Mm = _mm) -> torch.Tensor:
    """(B, 3, H, W) pixels normalised and padded to a multiple of patch ×
    merge -> (B, H·W / (patch·merge)², hidden_size) image tokens."""
    no_tf32()
    vc = cfg["vision_config"]
    p, w = params["vision"], vc["hidden_size"]
    ps, heads, eps = vc["patch_size"], vc["num_attention_heads"], vc["layer_norm_eps"]
    bsz, _, hh, ww = pixels.shape
    gh, gw = hh // ps, ww // ps
    cols = pixels.float().reshape(bsz, 3, gh, ps, gw, ps).permute(0, 2, 4, 1, 3, 5).reshape(bsz, gh * gw, -1)
    x = _linear(mm, cols, p["patch"]["weight"], p["patch"]["bias"])
    table = p["pos_emb"].float()
    if table.shape[:2] != (gh, gw):
        table = F.interpolate(table.permute(2, 0, 1)[None], size=(gh, gw), mode="bicubic",
                              align_corners=False)[0].permute(1, 2, 0)
    x = x + table.reshape(gh * gw, w)
    # 2-D RoPE: pair j of a head turns by x·f[j/2] (j even) or y·f[(j-1)/2]
    hd = w // heads
    freqs = 1.0 / vc["rope_theta"] ** (torch.arange(0, hd, 4, device=x.device)[: hd // 4].float() / hd)
    idx = torch.arange(gh * gw, device=x.device)
    angles = torch.stack([torch.outer((idx % gw).float(), freqs), torch.outer((idx // gw).float(), freqs)],
                         dim=-1).flatten(-2)  # (N, hd / 2)
    for blk in p["blocks"]:
        h = _layer_norm(blk["norm0"], x, eps)
        qkv = _linear(mm, h, blk["qkv"]["weight"], blk["qkv"]["bias"]).reshape(bsz, -1, 3, heads, hd)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        q, k = _rotate_pairs(q, angles), _rotate_pairs(k, angles)
        o = _attend(mm, q, k, v, 1.0 / math.sqrt(hd), False).transpose(1, 2).reshape(bsz, -1, w)
        x = x + _linear(mm, o, blk["proj"]["weight"], blk["proj"]["bias"])
        h = _layer_norm(blk["norm1"], x, eps)
        h = F.gelu(_linear(mm, h, blk["fc0"]["weight"], blk["fc0"]["bias"]), approximate="tanh")
        x = x + _linear(mm, h, blk["fc1"]["weight"], blk["fc1"]["bias"])
    x = _layer_norm(p["final_norm"], x, eps)
    # 2 × 2 patch merge, then the projector
    m = vc["merge_kernel_size"][0]
    x = x.reshape(bsz, gh // m, m, gw // m, m, w).permute(0, 1, 3, 2, 4, 5).reshape(bsz, -1, m * m, w)
    pj = params["projector"]
    x = _layer_norm(pj["pre_norm"], x, eps).reshape(bsz, -1, m * m * w)
    x = F.gelu(_linear(mm, x, pj["linear_1"]["weight"], pj["linear_1"]["bias"]))
    return _linear(mm, x, pj["linear_2"]["weight"], pj["linear_2"]["bias"])


# ------------------------------------------------------- the language model


def _swiglu(mm: Mm, p: Dict, x):
    gu = _linear(mm, x, p["gate_up"])
    g, u = gu.chunk(2, dim=-1)
    return _linear(mm, F.silu(g) * u, p["down"])


def route(cfg: Dict, p: Dict, h: torch.Tensor, use_bias: bool = True):
    """The router: (chosen experts (T, k), their weights (T, k)). σ of the
    float32 logits; the top k of σ + e_score_correction_bias are chosen
    (one group); the weights are σ of the chosen, normalised to sum 1, times
    routed_scaling_factor."""
    scores = torch.sigmoid(h.float() @ p["router"].float().t())
    choice = scores + p["bias"].float() if use_bias else scores
    idx = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    return idx, w * cfg["routed_scaling_factor"]


def _moe(mm: Mm, cfg: Dict, p: Dict, h):
    t, d = h.shape
    idx, wts = route(cfg, p, h)
    out = torch.zeros(t, d, device=h.device)
    for e in torch.unique(idx).tolist():
        rows, slot = (idx == e).nonzero(as_tuple=True)
        gu = mm(h[rows], p["gate_up"][e].float().t())
        g, u = gu.chunk(2, dim=-1)
        y = mm(F.silu(g) * u, p["down"][e].float().t())
        out.index_add_(0, rows, y * wts[rows, slot][:, None])
    return out + _swiglu(mm, p["shared"], h)


def _mla(mm: Mm, cfg: Dict, p: Dict, h):
    """Causal multi-head latent attention over one sequence h (T, D)."""
    t = h.shape[0]
    heads, nope, rope, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                             cfg["v_head_dim"])
    lora = cfg["kv_lora_rank"]
    q = _linear(mm, h, p["q_proj"]).reshape(t, heads, nope + rope)
    kva = _linear(mm, h, p["kv_a"])
    c = _rms_norm(p["kv_norm"], kva[:, :lora], cfg["rms_norm_eps"])
    kv = _linear(mm, c, p["kv_b"]).reshape(t, heads, nope + vd)
    inv = 1.0 / cfg["rope_theta"] ** (torch.arange(0, rope, 2, device=h.device).float() / rope)
    angles = torch.outer(torch.arange(t, device=h.device).float(), inv)
    q_pe = _rotate_pairs(q[..., nope:], angles[:, None])
    k_pe = _rotate_pairs(kva[:, lora:], angles)
    qq = torch.cat([q[..., :nope], q_pe], dim=-1).transpose(0, 1)[None]
    kk = torch.cat([kv[..., :nope], k_pe[:, None].expand(t, heads, rope)], dim=-1).transpose(0, 1)[None]
    o = _attend(mm, qq, kk, kv[..., nope:].transpose(0, 1)[None], 1.0 / math.sqrt(nope + rope), True)
    return _linear(mm, o[0].transpose(0, 1).reshape(t, heads * vd), p["o_proj"])


def embed(params: Dict, cfg: Dict, ids: torch.Tensor, image_rows: Optional[torch.Tensor] = None,
          media_pad: Optional[int] = None) -> torch.Tensor:
    """ids (T,) -> (T, D) embeddings, the first M media_pad positions
    replaced by image_rows (M, D) in order (a media_pad id that the model
    wrote later is a token like any other)."""
    x = params["embed"].float()[ids.long()]
    if image_rows is not None:
        rows = image_rows.float().reshape(-1, x.shape[-1])
        x[(ids == media_pad).nonzero()[: len(rows), 0]] = rows
    return x


def lm_hidden(params: Dict, cfg: Dict, x: torch.Tensor, mm: Mm = _mm) -> torch.Tensor:
    """One sequence's embeddings (T, D) -> its final normed hidden (T, D)."""
    no_tf32()
    eps = cfg["rms_norm_eps"]
    for i, lp in enumerate(params["layers"]):
        x = x + _mla(mm, cfg, lp, _rms_norm(lp["input_norm"], x, eps))
        h = _rms_norm(lp["post_norm"], x, eps)
        x = x + (_swiglu(mm, lp["mlp"], h) if i < cfg["first_k_dense_replace"] else _moe(mm, cfg, lp["moe"], h))
    return _rms_norm(params["norm"], x, eps)


def logits(params: Dict, hidden: torch.Tensor, mm: Mm = _mm) -> torch.Tensor:
    """(T, D) final hidden -> (T, vocab) float32 logits (the untied lm_head)."""
    return _linear(mm, hidden, params["lm_head"])


def forward(params: Dict, cfg: Dict, ids: torch.Tensor, pixels: Optional[torch.Tensor] = None,
            media_pad: Optional[int] = None, mm: Mm = _mm) -> torch.Tensor:
    """The full teacher-forced forward of one sequence: ids (T,) and, for an
    image turn, its (1, 3, H, W) pixels -> logits (T, vocab); row t scores
    the token at t + 1."""
    rows = vision_forward(params, cfg, pixels, mm)[0] if pixels is not None else None
    return logits(params, lm_hidden(params, cfg, embed(params, cfg, ids, rows, media_pad), mm), mm)
