"""Plain float32 forward passes of ImageBind-Huge's three towers and of
Whisper's encoder and decoder, from the published architectures.

Written from the descriptions, not from the program: ImageBind's vision
stem is the Conv3d over a 2-frame clip of the repeated image, its audio
stem a Conv2d over the fbank, each tower pre-LN blocks with torch
MultiheadAttention's packed projection (the audio trunk with add_bias_kv),
CLS or EOS pooling, LN and a bias-free projection; Whisper's encoder is two
Conv1d + GELU, fixed positions, pre-LN blocks and a final LN, its decoder
causal self-attention, cross-attention and a tied vocabulary projection.
Every product goes through `Prec.mm`: float32 with TF32 off, or, for the
controls, TF32 (inputs rounded to a 10-bit mantissa) or fp8 e4m3 (inputs
scaled per tensor and rounded to fp8), each accumulated in float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """Full float32 products on the card (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest even at TF32's 10-bit mantissa."""
    i = x.float().contiguous().view(torch.int32)
    bias = ((i >> 13) & 1) + 0xFFF
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled e4m3 rounding (the fp8 tensor cores' input)."""
    x = x.float()
    amax = x.abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Prec:
    """The precision of every product: 'fp32', 'tf32' or 'fp8'."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32":
            return _round_tf32(x)
        if self.mode == "fp8":
            return _round_fp8(x)
        return x.float()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b in float32 after rounding both inputs to the precision."""
        return torch.matmul(self._in(a), self._in(b))

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        y = self.mm(x, w.float().t())
        return y if b is None else y + b.float()


FP32 = Prec("fp32")


def layer_norm(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps)


def mha(pr: Prec, q, k, v, heads: int, mask=None) -> torch.Tensor:
    """softmax(q kᵀ / √hd + mask) v over heads; q (B, T, D), k/v (B, S, D)."""
    b, t, d = q.shape
    s = k.shape[1]
    hd = d // heads
    qh = q.reshape(b, t, heads, hd).transpose(1, 2)
    kh = k.reshape(b, s, heads, hd).transpose(1, 2)
    vh = v.reshape(b, s, heads, hd).transpose(1, 2)
    logits = pr.mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        logits = logits + mask
    out = pr.mm(torch.softmax(logits, dim=-1), vh)
    return out.transpose(1, 2).reshape(b, t, d)


# ------------------------------------------------------------------ ImageBind


def _ib_block(pr: Prec, p: Dict, x: torch.Tensor, heads: int, eps: float, mask=None):
    a = p["attn"]
    h = layer_norm(p["norm_1"], x, eps)
    qkv = pr.linear(h, a["in_proj"]["weight"], a["in_proj"]["bias"])
    q, k, v = qkv.chunk(3, dim=-1)
    if "bias_k" in a:  # nn.MultiheadAttention(add_bias_kv=True)
        bsz, d = k.shape[0], k.shape[-1]
        k = torch.cat([k, a["bias_k"].float().reshape(1, 1, d).expand(bsz, 1, d)], dim=1)
        v = torch.cat([v, a["bias_v"].float().reshape(1, 1, d).expand(bsz, 1, d)], dim=1)
        if mask is not None:
            mask = F.pad(mask, (0, 1))
    o = mha(pr, q, k, v, heads, mask)
    x = x + pr.linear(o, a["out_proj"]["weight"], a["out_proj"]["bias"])
    h = layer_norm(p["norm_2"], x, eps)
    m = p["mlp"]
    h = F.gelu(pr.linear(h, m["fc1"]["weight"], m["fc1"]["bias"]))
    return x + pr.linear(h, m["fc2"]["weight"], m["fc2"]["bias"])


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-8)


def vision_forward(params: Dict, cfg: Dict, images: torch.Tensor, pr: Prec = FP32) -> torch.Tensor:
    """(B, 3, S, S) normalized images -> (B, E) unit rows."""
    ib = cfg["imagebind"]
    p = params["vision"]
    w = p["patch_conv"]["weight"].float()  # (W, 3, 2, ps, ps)
    clip = images.float()[:, :, None].expand(-1, -1, 2, -1, -1)  # the image as a 2-frame clip
    ps = ib["patch_size"]
    if pr.mode == "fp32":
        x = F.conv3d(clip, w, stride=(2, ps, ps))
    else:  # the stem as a product, so the control rounds it too
        b, c, _, s, _ = clip.shape
        g = s // ps
        cols = clip.reshape(b, c, 2, g, ps, g, ps).permute(0, 3, 5, 1, 2, 4, 6).reshape(b, g * g, -1)
        x = pr.mm(cols, w.reshape(w.shape[0], -1).t()).transpose(1, 2)
    x = x.flatten(2).transpose(1, 2)  # (B, N, W)
    x = torch.cat([p["cls_token"].float().expand(x.shape[0], -1, -1), x], dim=1) + p["pos_embed"].float()
    x = layer_norm(p["pre_ln"], x, ib["eps"])
    for pb in p["blocks"]:
        x = _ib_block(pr, pb, x, ib["vision"]["heads"], ib["eps"])
    x = layer_norm(p["head_ln"], x[:, 0], ib["eps"])
    return _l2(pr.linear(x, p["head_proj"]["weight"]))


def audio_forward(params: Dict, cfg: Dict, fbank: torch.Tensor, pr: Prec = FP32) -> torch.Tensor:
    """(B, clips, mel, T) normalized fbank -> (B, E): each clip's unit row
    × the logit scale, averaged over the clips."""
    ib = cfg["imagebind"]
    p = params["audio"]
    b, c = fbank.shape[:2]
    x = fbank.reshape(b * c, 1, *fbank.shape[2:]).float()
    w = p["patch_conv"]["weight"].float()
    if pr.mode == "fp32":
        x = F.conv2d(x, w, stride=ib["audio_stride"]).flatten(2).transpose(1, 2)
    else:
        cols = F.unfold(x, ib["audio_kernel"], stride=ib["audio_stride"]).transpose(1, 2)
        x = pr.mm(cols, w.reshape(w.shape[0], -1).t())
    x = layer_norm(p["patch_norm"], x, ib["eps"])
    x = torch.cat([p["cls_token"].float().expand(x.shape[0], -1, -1), x], dim=1) + p["pos_embed"].float()
    for pb in p["blocks"]:
        x = _ib_block(pr, pb, x, ib["audio"]["heads"], ib["eps"])
    x = layer_norm(p["head_ln"], x[:, 0], ib["eps"])
    x = _l2(pr.linear(x, p["head_proj"]["weight"])) * ib["audio_logit_scale"]
    return x.reshape(b, c, -1).mean(dim=1)


# -------------------------------------------------------------------- Whisper


def _wh_attn(pr: Prec, p: Dict, x, kv, heads: int, mask=None):
    q = pr.linear(x, p["q_proj"]["weight"], p["q_proj"]["bias"])
    k = pr.linear(kv, p["k_proj"]["weight"])
    v = pr.linear(kv, p["v_proj"]["weight"], p["v_proj"]["bias"])
    return pr.linear(mha(pr, q, k, v, heads, mask), p["out_proj"]["weight"], p["out_proj"]["bias"])


def _wh_block(pr: Prec, p: Dict, x, heads: int, eps: float, mask=None, enc=None):
    h = layer_norm(p["self_ln"], x, eps)
    x = x + _wh_attn(pr, p["self_attn"], h, h, heads, mask)
    if enc is not None:
        x = x + _wh_attn(pr, p["cross_attn"], layer_norm(p["cross_ln"], x, eps), enc, heads)
    h = F.gelu(pr.linear(layer_norm(p["final_ln"], x, eps), p["mlp"]["fc1"]["weight"],
                         p["mlp"]["fc1"]["bias"]))
    return x + pr.linear(h, p["mlp"]["fc2"]["weight"], p["mlp"]["fc2"]["bias"])


def _conv1d(pr: Prec, x, p: Dict, stride: int):
    w = p["weight"].float()
    if pr.mode == "fp32":
        return F.conv1d(x, w, p["bias"].float(), stride=stride, padding=1)
    cols = F.pad(x, (1, 1)).unfold(2, 3, stride)  # (B, C, T', 3)
    cols = cols.permute(0, 2, 1, 3).reshape(x.shape[0], cols.shape[2], -1)
    return (pr.mm(cols, w.reshape(w.shape[0], -1).t()) + p["bias"].float()).transpose(1, 2)


def whisper_encode(params: Dict, cfg: Dict, mel: torch.Tensor, pr: Prec = FP32) -> torch.Tensor:
    """(B, mels, 3000) log-mel -> (B, 1500, d)."""
    w = cfg["whisper"]
    p = params["encoder"]
    x = F.gelu(_conv1d(pr, mel.float(), p["conv1"], 1))
    x = F.gelu(_conv1d(pr, x, p["conv2"], 2)).transpose(1, 2)
    x = x + p["pos_embed"].float()[: x.shape[1]]
    for pb in p["blocks"]:
        x = _wh_block(pr, pb, x, w["encoder_attention_heads"], w["layer_norm_eps"])
    return layer_norm(p["ln"], x, w["layer_norm_eps"])


def whisper_logits(params: Dict, cfg: Dict, tokens: torch.Tensor, enc: torch.Tensor,
                   pr: Prec = FP32) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, T) -> logits (B, T, vocab); row t
    scores the token at t + 1."""
    w = cfg["whisper"]
    p = params["decoder"]
    t = tokens.shape[1]
    x = p["token_embedding"].float()[tokens.long()] + p["pos_embed"].float()[:t]
    mask = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
    for pb in p["blocks"]:
        x = _wh_block(pr, pb, x, w["decoder_attention_heads"], w["layer_norm_eps"], mask, enc)
    x = layer_norm(p["ln"], x, w["layer_norm_eps"])
    return pr.mm(x, p["token_embedding"].float().t())


def in_blocks(fn, xs: torch.Tensor, rows: int) -> torch.Tensor:
    """fn over row blocks of xs, so the float32 activations fit."""
    return torch.cat([fn(xs[i:i + rows]) for i in range(0, xs.shape[0], rows)]) if len(xs) else xs
