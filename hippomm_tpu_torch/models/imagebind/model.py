"""ImageBind joint-embedding model in PyTorch (vision / audio / text towers).

Counterpart of hippomm_tpu/models/imagebind/model.py, same architecture and
parameter tree (blocks as a per-layer list instead of depth-stacked leaves):

  * vision: ViT-H/14 — 2-frame repeated patchify Conv3d(2,14,14) (a 2-D
    patchify with the time-summed kernel), width 1280, depth 32, heads 16,
    pre-LN blocks, CLS pooling, LN+Linear head → 1024
  * audio:  mel(128×204) → Conv2d k16 s10 patchify, ViT-B (768/12/12) with
    bias_kv attention, CLS pooling, LN+Linear head → 1024, logit scale 20
  * text:   CLIP-style causal transformer, width 1024, depth 24, heads 16,
    context 77, EOS pooling, Linear head → 1024 × exp(logit_scale); its
    masked attention takes the plain route, its MLP K2 (K3 when fused)

Each patchify convolution is an unfold plus one matmul that returns fp32
from compute-dtype operands (JAX's preferred_element_type=float32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F

from hippomm_tpu_torch.models import layers as L
from hippomm_tpu_torch.utils.device import as_tensors

EMBED_DIM = 1024


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    width: int
    depth: int
    heads: int
    mlp_ratio: float = 4.0
    eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class ImageBindConfig:
    vision: TowerConfig = TowerConfig(width=1280, depth=32, heads=16)
    audio: TowerConfig = TowerConfig(width=768, depth=12, heads=12)
    text: TowerConfig = TowerConfig(width=1024, depth=24, heads=16)
    embed_dim: int = EMBED_DIM
    image_size: int = 224
    patch_size: int = 14
    audio_mel_bins: int = 128
    audio_target_len: int = 204
    audio_kernel: int = 16
    audio_stride: int = 10
    vocab_size: int = 49408
    context_length: int = 77
    audio_logit_scale: float = 20.0

    @property
    def vision_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @property
    def audio_tokens(self) -> int:
        h = (self.audio_mel_bins - self.audio_kernel) // self.audio_stride + 1
        w = (self.audio_target_len - self.audio_kernel) // self.audio_stride + 1
        return h * w + 1


def huge_config() -> ImageBindConfig:
    return ImageBindConfig()


def tiny_config() -> ImageBindConfig:
    """Same topology, tiny dims — hermetic tests + stub pipelines."""
    return ImageBindConfig(
        vision=TowerConfig(width=64, depth=2, heads=4),
        audio=TowerConfig(width=48, depth=2, heads=4),
        text=TowerConfig(width=64, depth=2, heads=4),
        image_size=56,
        patch_size=14,
        vocab_size=512,
        context_length=16,
    )


def get_config(variant: str) -> ImageBindConfig:
    if variant == "huge":
        return huge_config()
    if variant == "tiny":
        return tiny_config()
    raise ValueError(f"unknown imagebind variant: {variant}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_imagebind(cfg: ImageBindConfig, device, dtype=torch.bfloat16, seed: int = 0) -> Dict:
    """Random init of all three towers on `device` from a torch.Generator
    seeded with `seed`. Matmul weights are stored in `dtype` (the forward
    casts them to it anyway); norms, biases, embeddings and patchify kernels
    stay fp32. Training takes dtype=torch.float32: every leaf an fp32 master,
    as the JAX package's init keeps them (train/contrastive). Not the JAX
    package's random numbers — tests carry weights across with
    carry.params_from_jax instead."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(shape, std):
        return std * torch.randn(shape, generator=g, device=device)

    vw, aw, tw = cfg.vision.width, cfg.audio.width, cfg.text.width
    return {
        "vision": {
            "patch_conv": {"weight": normal((vw, 3, 2, cfg.patch_size, cfg.patch_size), 0.02)},
            "cls_token": torch.zeros((1, 1, vw), device=device),
            "pos_embed": normal((1, cfg.vision_tokens, vw), 0.02),
            "pre_ln": L.init_layer_norm(vw, device),
            "blocks": [
                L.init_block(g, vw, device, dtype, cfg.vision.mlp_ratio)
                for _ in range(cfg.vision.depth)
            ],
            "head_ln": L.init_layer_norm(vw, device),
            "head_proj": {"weight": normal((cfg.embed_dim, vw), 0.02).to(dtype)},
        },
        "audio": {
            "patch_conv": {"weight": normal((aw, 1, cfg.audio_kernel, cfg.audio_kernel), 0.02)},
            "patch_norm": L.init_layer_norm(aw, device),
            "cls_token": torch.zeros((1, 1, aw), device=device),
            "pos_embed": normal((1, cfg.audio_tokens, aw), 0.02),
            "blocks": [
                # the public audio trunk uses add_bias_kv=True
                L.init_block(g, aw, device, dtype, cfg.audio.mlp_ratio, bias_kv=True)
                for _ in range(cfg.audio.depth)
            ],
            "head_ln": L.init_layer_norm(aw, device),
            "head_proj": {"weight": normal((cfg.embed_dim, aw), 0.02).to(dtype)},
        },
        "text": {
            "token_embedding": normal((cfg.vocab_size, tw), 0.02),
            "pos_embed": normal((1, cfg.context_length, tw), 0.01),
            "blocks": [
                L.init_block(g, tw, device, dtype, cfg.text.mlp_ratio)
                for _ in range(cfg.text.depth)
            ],
            "final_ln": L.init_layer_norm(tw, device),
            "head_proj": {"weight": normal((cfg.embed_dim, tw), 0.02).to(dtype)},
            "logit_scale": torch.tensor(math.log(1 / 0.07), device=device),
        },
    }


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


def vision_embed(params: Dict, images: torch.Tensor, cfg: ImageBindConfig, dtype=torch.bfloat16) -> torch.Tensor:
    """Patchify + CLS + pos-embed + pre-LN: (B, 3, S, S) -> (B, N, W) fp32.

    ImageBind repeats an image into a 2-frame clip before its Conv3d with
    temporal kernel and stride 2, so the Conv3d equals a 2-D patchify with
    the kernel summed over time. Stride = kernel, so the patches are a pure
    reshape, in row-major patch order with (c, kh, kw) inside each patch."""
    p = params["vision"]
    w = p["patch_conv"]["weight"].float().sum(dim=2).to(dtype)  # (W, 3, ph, pw)
    b, c, s, _ = images.shape
    ps = cfg.patch_size
    g = s // ps
    patches = (
        images.to(dtype).reshape(b, c, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, c * ps * ps)
    )
    x = L.matmul_f32(patches, w.reshape(w.shape[0], -1))  # (B, N, W) fp32
    cls = p["cls_token"].float().expand(b, 1, cfg.vision.width)
    x = torch.cat([cls, x], dim=1) + p["pos_embed"].float()
    return L.layer_norm(p["pre_ln"], x, cfg.vision.eps)


def vision_head(params: Dict, cls_tok: torch.Tensor, cfg: ImageBindConfig, dtype=torch.bfloat16) -> torch.Tensor:
    """Final LN + projection on the CLS token: (B, W) -> (B, 1024) unit-norm."""
    p = params["vision"]
    x = L.layer_norm(p["head_ln"], cls_tok, cfg.vision.eps)
    x = L.matmul_f32(x.to(dtype), p["head_proj"]["weight"].to(dtype))
    return _l2norm(x)


def vision_forward(params: Dict, images: torch.Tensor, cfg: ImageBindConfig, dtype=torch.bfloat16) -> torch.Tensor:
    """images: (B, 3, S, S) normalized fp32 -> (B, 1024) L2-normalized."""
    x = vision_embed(params, images, cfg, dtype)
    x = L.stacked_blocks(params["vision"]["blocks"], x, cfg.vision.heads, eps=cfg.vision.eps, dtype=dtype)
    return vision_head(params, x[:, 0], cfg, dtype)


def audio_forward(params: Dict, mel: torch.Tensor, cfg: ImageBindConfig, dtype=torch.bfloat16) -> torch.Tensor:
    """mel: (B, 1, 128, 204) normalized fbank -> (B, 1024) L2-normalized ×20.

    Multi-clip inputs (B, C, 1, 128, 204) are averaged after embedding, like
    ImageBind's clip ensembling."""
    multi_clip = mel.dim() == 5
    if multi_clip:
        b_, c_ = mel.shape[:2]
        mel = mel.reshape(b_ * c_, *mel.shape[2:])
    p = params["audio"]
    k = cfg.audio_kernel
    # (B, 1·k·k, L): column order (c, kh, kw), L row-major over the output grid
    patches = F.unfold(mel.float(), kernel_size=k, stride=cfg.audio_stride).transpose(1, 2)
    w = p["patch_conv"]["weight"].to(dtype)
    x = L.matmul_f32(patches.to(dtype), w.reshape(w.shape[0], -1))  # (B, N, W) fp32
    b = x.shape[0]
    x = L.layer_norm(p["patch_norm"], x, cfg.audio.eps)
    cls = p["cls_token"].float().expand(b, 1, cfg.audio.width)
    x = torch.cat([cls, x], dim=1) + p["pos_embed"].float()
    x = L.stacked_blocks(p["blocks"], x, cfg.audio.heads, eps=cfg.audio.eps, dtype=dtype)
    x = L.layer_norm(p["head_ln"], x[:, 0], cfg.audio.eps)
    x = L.matmul_f32(x.to(dtype), p["head_proj"]["weight"].to(dtype))
    x = _l2norm(x) * cfg.audio_logit_scale
    if multi_clip:
        x = x.reshape(b_, c_, -1).mean(dim=1)
    return x


def text_embed(params: Dict, tokens: torch.Tensor, cfg: ImageBindConfig) -> torch.Tensor:
    """Token + position embeddings: (B, context) int -> (B, context, W) fp32."""
    p = params["text"]
    t = tokens.shape[1]
    return p["token_embedding"][tokens.long()].float() + p["pos_embed"][:, :t].float()


def causal_mask(t: int, device) -> torch.Tensor:
    """Additive (t, t) fp32 mask: -inf above the diagonal."""
    return torch.triu(torch.full((t, t), float("-inf"), device=device), diagonal=1)


def text_head(params: Dict, x: torch.Tensor, tokens: torch.Tensor, cfg: ImageBindConfig,
              dtype=torch.bfloat16) -> torch.Tensor:
    """Final LN, EOS pooling and projection: (B, context, W) -> (B, 1024)
    L2-normalized × exp(logit_scale). EOS pooling follows CLIP: the position
    of each row's largest token id (EOS has the largest id of the
    vocabulary)."""
    p = params["text"]
    x = L.layer_norm(p["final_ln"], x, cfg.text.eps)
    eos = torch.argmax(tokens.long(), dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eos]
    x = L.matmul_f32(x.to(dtype), p["head_proj"]["weight"].to(dtype))
    return _l2norm(x) * torch.exp(p["logit_scale"].float())


def text_forward(params: Dict, tokens: torch.Tensor, cfg: ImageBindConfig, dtype=torch.bfloat16) -> torch.Tensor:
    """tokens: (B, context) int, 0-padded after EOS -> (B, 1024) L2-normalized
    × exp(logit_scale)."""
    x = text_embed(params, tokens, cfg)
    mask = causal_mask(tokens.shape[1], x.device)
    x = L.stacked_blocks(params["text"]["blocks"], x, cfg.text.heads, mask=mask, eps=cfg.text.eps, dtype=dtype)
    return text_head(params, x, tokens, cfg, dtype)


def extract_features(
    params: Dict,
    cfg: ImageBindConfig,
    vision=None,
    audio=None,
    text=None,
    dtype=torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """Joint forward over any subset of modalities -> {modality: (N, 1024)},
    as hippomm_tpu.models.imagebind.model.extract_features (the reference's
    ImageBind.extract_features): each given input through its tower's
    forward. An array goes to the parameters' device, a tensor stays on
    its own."""
    dev = params["vision"]["pos_embed"].device
    out = {}
    for name, x, forward in (("vision", vision, vision_forward), ("audio", audio, audio_forward),
                             ("text", text, text_forward)):
        if x is not None:
            out[name] = forward(params, as_tensors(x, device=dev)[0], cfg, dtype)
    return out
