"""Vendored name/shape manifest of the public `imagebind_huge.pth` checkpoint
(the subset the converter consumes: vision / audio / text).

The port's copy of hippomm_tpu/models/imagebind/manifest.py, over the port's
own ImageBindConfig.

Transcribed from the public facebookresearch/ImageBind model definition
(imagebind/models/imagebind_model.py `imagebind_huge()` + default
ImageBindModel args, multimodal_preprocessors.py, transformer.py):

  * vision: ViT-H — width 1280, depth 32, heads 16; PadIm2Video(2) →
    Conv3d(3→1280, k=(2,14,14), s=(2,14,14), bias=False) inside
    `rgbt_stem.proj` (a Sequential, conv at index 1);
    pre_transformer_layer = Sequential(LayerNorm, EinOpsRearrange) — LN at 0
  * audio: width 768, depth 12, heads 12; Conv2d(1→768, k16 s10, bias=False)
    at `audio_stem.proj.0` + `audio_stem.norm_layer`; trunk built with
    add_bias_kv=True → every block has attn.bias_k / attn.bias_v
  * text: width 1024, depth 24, heads 16, vocab 49408, context 77; head =
    SelectEOSAndProject(Sequential(LayerNorm, Linear(bias=False))) →
    `proj.0.*`, `proj.1.weight`; postprocessor =
    Sequential(Normalize, LearnableLogitScaling) → `1.log_logit_scale`
  * heads for vision/audio: Sequential(LayerNorm, SelectElement, Linear) →
    `0.*`, `2.weight` (Linear bias=False)

The real checkpoint additionally carries depth / thermal / imu modalities;
those keys are intentionally NOT consumed (the reference only ever uses
vision/audio/text, foundation_models.py:116-151).

This manifest exists so the converter's naming assumptions are testable
offline: tests and chip_smoke.py build a synthetic checkpoint from exactly
these (name, shape) pairs and load it through both packages' converters.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from hippomm_tpu_torch.models.imagebind.model import ImageBindConfig, huge_config


def _block_entries(prefix: str, d: int, mlp: int, depth: int, bias_kv: bool) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    for i in range(depth):
        b = f"{prefix}.blocks.{i}"
        out[f"{b}.attn.in_proj_weight"] = (3 * d, d)
        out[f"{b}.attn.in_proj_bias"] = (3 * d,)
        if bias_kv:
            out[f"{b}.attn.bias_k"] = (1, 1, d)
            out[f"{b}.attn.bias_v"] = (1, 1, d)
        out[f"{b}.attn.out_proj.weight"] = (d, d)
        out[f"{b}.attn.out_proj.bias"] = (d,)
        out[f"{b}.norm_1.weight"] = (d,)
        out[f"{b}.norm_1.bias"] = (d,)
        out[f"{b}.norm_2.weight"] = (d,)
        out[f"{b}.norm_2.bias"] = (d,)
        out[f"{b}.mlp.fc1.weight"] = (mlp, d)
        out[f"{b}.mlp.fc1.bias"] = (mlp,)
        out[f"{b}.mlp.fc2.weight"] = (d, mlp)
        out[f"{b}.mlp.fc2.bias"] = (d,)
    return out


def checkpoint_manifest(cfg: ImageBindConfig = None) -> Dict[str, Tuple[int, ...]]:
    """{state_dict key: shape} for the consumed subset of imagebind_huge.pth
    (or the same layout at any ImageBindConfig's dims)."""
    cfg = cfg or huge_config()
    v, a, t = cfg.vision, cfg.audio, cfg.text
    e = cfg.embed_dim
    m: Dict[str, Tuple[int, ...]] = {}

    # ---- vision -------------------------------------------------------------
    m["modality_preprocessors.vision.cls_token"] = (1, 1, v.width)
    m["modality_preprocessors.vision.rgbt_stem.proj.1.weight"] = (
        v.width, 3, 2, cfg.patch_size, cfg.patch_size,
    )
    m["modality_preprocessors.vision.pos_embedding_helper.pos_embed"] = (
        1, cfg.vision_tokens, v.width,
    )
    m["modality_trunks.vision.pre_transformer_layer.0.weight"] = (v.width,)
    m["modality_trunks.vision.pre_transformer_layer.0.bias"] = (v.width,)
    m.update(
        _block_entries(
            "modality_trunks.vision", v.width, int(v.width * v.mlp_ratio), v.depth, False
        )
    )
    m["modality_heads.vision.0.weight"] = (v.width,)
    m["modality_heads.vision.0.bias"] = (v.width,)
    m["modality_heads.vision.2.weight"] = (e, v.width)

    # ---- audio --------------------------------------------------------------
    m["modality_preprocessors.audio.cls_token"] = (1, 1, a.width)
    m["modality_preprocessors.audio.audio_stem.proj.0.weight"] = (
        a.width, 1, cfg.audio_kernel, cfg.audio_kernel,
    )
    m["modality_preprocessors.audio.audio_stem.norm_layer.weight"] = (a.width,)
    m["modality_preprocessors.audio.audio_stem.norm_layer.bias"] = (a.width,)
    m["modality_preprocessors.audio.pos_embedding_helper.pos_embed"] = (
        1, cfg.audio_tokens, a.width,
    )
    m.update(
        _block_entries(
            "modality_trunks.audio", a.width, int(a.width * a.mlp_ratio), a.depth, True
        )
    )
    m["modality_heads.audio.0.weight"] = (a.width,)
    m["modality_heads.audio.0.bias"] = (a.width,)
    m["modality_heads.audio.2.weight"] = (e, a.width)

    # ---- text ---------------------------------------------------------------
    m["modality_preprocessors.text.token_embedding.weight"] = (cfg.vocab_size, t.width)
    m["modality_preprocessors.text.pos_embed"] = (1, cfg.context_length, t.width)
    m.update(
        _block_entries(
            "modality_trunks.text", t.width, int(t.width * t.mlp_ratio), t.depth, False
        )
    )
    m["modality_heads.text.proj.0.weight"] = (t.width,)
    m["modality_heads.text.proj.0.bias"] = (t.width,)
    m["modality_heads.text.proj.1.weight"] = (e, t.width)
    m["modality_postprocessors.text.1.log_logit_scale"] = ()

    return m


def random_state_dict(cfg: ImageBindConfig = None, seed: int = 0) -> Dict[str, np.ndarray]:
    """A checkpoint's state_dict with exactly the manifest's names and
    shapes, fp32 numpy values drawn from `seed`: linear and patchify weights
    ~ N(0, 1/fan_in), LayerNorm weights 1 + N(0, 0.02²), biases, tokens,
    position embeddings and the bias_k/v rows N(0, 0.02²), the logit scale
    log(1/0.07). Real weights are not in the repository; this is what
    hermetic tests and chip_smoke.py write to a `.pth` or
    `.safetensors` file to drive the loader."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, shape in checkpoint_manifest(cfg).items():
        if not shape:  # the text head's log logit scale
            out[name] = np.asarray(np.log(1 / 0.07), np.float32)
            continue
        x = rng.standard_normal(shape, dtype=np.float32)
        is_weight = name.endswith("weight") and "token_embedding" not in name
        if is_weight and len(shape) == 1:  # LayerNorm
            x = 1.0 + np.float32(0.02) * x
        elif is_weight:
            x *= np.float32(float(np.prod(shape[1:])) ** -0.5)
        else:
            x *= np.float32(0.02)
        out[name] = x
    return out
