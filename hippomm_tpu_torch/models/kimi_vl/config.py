"""Sizes of Kimi-VL-A3B-Instruct (the published config.json's text model,
and MoonViT from the Kimi-VL report, arXiv:2504.07491, at SigLIP-so400m
widths) and of a tiny variant for the CPU tests."""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 163840
    hidden: int = 2048
    intermediate: int = 11264  # layer 0's dense SwiGLU
    moe_intermediate: int = 1408  # each routed expert's SwiGLU
    layers: int = 27
    heads: int = 16
    n_shared: int = 2  # one shared SwiGLU of n_shared × moe_intermediate
    n_routed: int = 64
    topk: int = 6
    routed_scale: float = 2.446
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128
    first_dense: int = 1
    eps: float = 1e-5
    rope_theta: float = 800000.0
    max_positions: int = 131072

    @property
    def qk_dim(self) -> int:
        return self.nope_dim + self.rope_dim


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    patch: int = 14
    width: int = 1152
    depth: int = 27
    heads: int = 16
    mlp: int = 4304
    pos_grid: int = 64  # the learned position table is pos_grid × pos_grid
    rope_theta: float = 10000.0
    merge: int = 2  # merge × merge patches give one image token
    projector: int = 4608  # the projector's hidden width (= merge² × width)
    eps: float = 1e-5

    @property
    def pad_to(self) -> int:
        """Images pad to a multiple of this many pixels (whole merged tokens)."""
        return self.patch * self.merge


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    text: TextConfig = TextConfig()
    vision: VisionConfig = VisionConfig()
    # the chat template's special tokens take the top n_special ids
    n_special: int = 256
    # the latent cache's token slots, shared by every decode bucket: a bucket
    # of r rows holds cache_slots // r positions a row
    cache_slots: int = 131072
    max_rows: int = 256  # rows of the largest decode bucket
    # the prefill's rows × padded length per forward
    prefill_tokens: int = 32768
    # images per ViT forward
    vision_chunk: int = 32


CONFIGS: Dict[str, KimiVLConfig] = {
    "kimi-vl-a3b-instruct": KimiVLConfig(),
    "tiny": KimiVLConfig(
        text=TextConfig(vocab_size=768, hidden=64, intermediate=96, moe_intermediate=32, layers=3,
                        heads=4, n_shared=2, n_routed=8, topk=3, kv_lora=32, rope_dim=16, nope_dim=16,
                        v_dim=16, max_positions=4096),
        vision=VisionConfig(width=128, depth=2, heads=4, mlp=200, pos_grid=8, projector=512),
        cache_slots=4096, max_rows=16, prefill_tokens=512, vision_chunk=4,
    ),
}


def get_config(variant: str) -> KimiVLConfig:
    if variant not in CONFIGS:
        raise ValueError(f"unknown Kimi-VL variant {variant!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[variant]
