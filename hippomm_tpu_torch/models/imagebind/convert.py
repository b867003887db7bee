"""Convert the public ImageBind checkpoint (`imagebind_huge.pth` or a
`.safetensors` export, a torch state_dict) into the port's parameters.

Counterpart of hippomm_tpu/models/imagebind/convert.py, with the same name
map (that module's docstring lists it) and the same checks.
`convert_state_dict` builds the JAX package's tree of numpy leaves, except
that each block leaf is a list of per-layer arrays where the JAX converter
stacks them along a leading depth axis (np.stack of the list is the JAX
leaf): the leaves stay views of the loaded state_dict, so the host never
holds a second, stacked copy of the 4.3 GB fp32 checkpoint.
`load_imagebind` carries the tree onto the device one tensor at a time
(carry.params_from_jax), as the port's Whisper loader does.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from hippomm_tpu_torch.models.ckpt_io import load_state_dict
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
from hippomm_tpu_torch.models.imagebind.manifest import checkpoint_manifest
from hippomm_tpu_torch.models.imagebind.model import ImageBindConfig, huge_config

LOGIT_SCALE_KEY = "modality_postprocessors.text.1.log_logit_scale"


def _np(t) -> np.ndarray:
    """fp32 numpy of a tensor or array: a view where it already is one."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _collect_blocks(sd: Dict, trunk: str, depth: int) -> Dict:
    """Per-block tensors as lists of `depth` per-layer arrays."""

    def grab(name):
        return [_np(sd[f"modality_trunks.{trunk}.blocks.{i}.{name}"]) for i in range(depth)]

    def pair(name):
        return {"weight": grab(f"{name}.weight"), "bias": grab(f"{name}.bias")}

    out = {
        "attn": {
            "in_proj": {"weight": grab("attn.in_proj_weight"), "bias": grab("attn.in_proj_bias")},
            "out_proj": pair("attn.out_proj"),
        },
        "mlp": {"fc1": pair("mlp.fc1"), "fc2": pair("mlp.fc2")},
        "norm_1": pair("norm_1"),
        "norm_2": pair("norm_2"),
    }
    # the public audio trunk has add_bias_kv=True: bias_k / bias_v per block
    if f"modality_trunks.{trunk}.blocks.0.attn.bias_k" in sd:
        out["attn"]["bias_k"] = grab("attn.bias_k")
        out["attn"]["bias_v"] = grab("attn.bias_v")
    return out


def convert_state_dict(sd: Dict, cfg: ImageBindConfig = None) -> Dict:
    """torch state_dict (name -> tensor) -> the JAX-layout ImageBind tree
    (numpy leaves, each block leaf a per-layer list)."""
    cfg = cfg or huge_config()

    def pair(prefix):
        return {"weight": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}

    vp, ap = "modality_preprocessors.vision", "modality_preprocessors.audio"
    params: Dict = {
        "vision": {
            "patch_conv": {"weight": _np(sd[f"{vp}.rgbt_stem.proj.1.weight"])},
            "cls_token": _np(sd[f"{vp}.cls_token"]),
            "pos_embed": _np(sd[f"{vp}.pos_embedding_helper.pos_embed"]),
            "pre_ln": pair("modality_trunks.vision.pre_transformer_layer.0"),
            "blocks": _collect_blocks(sd, "vision", cfg.vision.depth),
            "head_ln": pair("modality_heads.vision.0"),
            "head_proj": {"weight": _np(sd["modality_heads.vision.2.weight"])},
        },
        "audio": {
            "patch_conv": {"weight": _np(sd[f"{ap}.audio_stem.proj.0.weight"])},
            "patch_norm": pair(f"{ap}.audio_stem.norm_layer"),
            "cls_token": _np(sd[f"{ap}.cls_token"]),
            "pos_embed": _np(sd[f"{ap}.pos_embedding_helper.pos_embed"]),
            "blocks": _collect_blocks(sd, "audio", cfg.audio.depth),
            "head_ln": pair("modality_heads.audio.0"),
            "head_proj": {"weight": _np(sd["modality_heads.audio.2.weight"])},
        },
        "text": {
            "token_embedding": _np(sd["modality_preprocessors.text.token_embedding.weight"]),
            "pos_embed": _np(sd["modality_preprocessors.text.pos_embed"]),
            "blocks": _collect_blocks(sd, "text", cfg.text.depth),
            "final_ln": pair("modality_heads.text.proj.0"),
            "head_proj": {"weight": _np(sd["modality_heads.text.proj.1.weight"])},
            # re-exported checkpoints saved with learnable=False omit it
            "logit_scale": _np(sd.get(LOGIT_SCALE_KEY, np.asarray(np.log(1 / 0.07), np.float32)))
            .reshape(()),
        },
    }
    return params


def expected_keys(cfg: ImageBindConfig = None) -> list:
    """Every state_dict key the converter reads, for the given config: the
    shape manifest's keys."""
    return list(checkpoint_manifest(cfg or huge_config()))


def infer_depths(sd: Dict) -> Dict[str, int]:
    """Depth per trunk from state_dict names."""
    depths: Dict[str, int] = {}
    pat = re.compile(r"modality_trunks\.(\w+)\.blocks\.(\d+)\.")
    for k in sd:
        m = pat.match(k)
        if m:
            depths[m.group(1)] = max(depths.get(m.group(1), 0), int(m.group(2)) + 1)
    return depths


def validate_state_dict(sd: Dict, cfg: ImageBindConfig = None) -> None:
    """KeyError naming every missing key, a depth that is not the config's
    (a deeper checkpoint holds every shallower config's keys), or a shape
    that is not the manifest's, before any conversion."""
    cfg = cfg or huge_config()
    manifest = checkpoint_manifest(cfg)
    exp = set(manifest) - {LOGIT_SCALE_KEY}
    have = set(sd.keys())
    missing = sorted(exp - have)
    depths = infer_depths(sd)
    want_depths = {"vision": cfg.vision.depth, "audio": cfg.audio.depth, "text": cfg.text.depth}
    if depths and any(depths.get(k) not in (None, v) for k, v in want_depths.items()):
        raise KeyError(
            f"ImageBind checkpoint depths {depths} != config depths {want_depths} — wrong variant/config"
        )
    bad_shapes = [
        f"{k}: {tuple(sd[k].shape)} != {tuple(shape)}"
        for k, shape in manifest.items()
        if k in have and tuple(getattr(sd[k], "shape", ())) != tuple(shape)
    ]
    if bad_shapes:
        raise KeyError(f"ImageBind checkpoint shape mismatch ({len(bad_shapes)}): {bad_shapes[:5]}")
    if missing:
        extra = sorted(k for k in have - exp if "vision" in k or "audio" in k or "text" in k)
        raise KeyError(
            f"ImageBind checkpoint naming mismatch: {len(missing)} expected keys "
            f"absent (first 10: {missing[:10]}); {len(extra)} unmapped "
            f"modality keys present (first 10: {extra[:10]}). Depths inferred "
            f"from checkpoint: {depths}"
        )


def load_imagebind(checkpoint_path: str, cfg: ImageBindConfig = None, device="cpu",
                   dtype=torch.bfloat16) -> Dict:
    """Checkpoint file (torch pickle or safetensors) -> validated port
    parameters on `device`, matmul weights in `dtype`."""
    cfg = cfg or huge_config()
    sd = load_state_dict(checkpoint_path)
    validate_state_dict(sd, cfg)
    return params_from_jax(convert_state_dict(sd, cfg), cfg, torch.device(device), dtype)
