"""Convert HuggingFace `WhisperModel` state_dicts to the port's Whisper params.

Counterpart of hippomm_tpu/models/whisper/convert.py: any openai/whisper-*
or distil-whisper checkpoint in transformers format loads through this.
`convert_state_dict` builds the JAX package's tree (numpy leaves, blocks
stacked along a leading depth axis) so both packages load one checkpoint
alike; `load_whisper` then carries it into the port's per-layer tensors
(carry.params_from_jax).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from hippomm_tpu_torch.models.whisper.carry import params_from_jax
from hippomm_tpu_torch.models.whisper.model import WhisperConfig


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _stack(sd: Dict, base: str, depth: int, name: str) -> np.ndarray:
    return np.stack([_np(sd[f"{base}.{i}.{name}"]) for i in range(depth)])


def _attn(sd: Dict, base: str, depth: int, prefix: str) -> Dict:
    def grab(name, bias=True):
        out = {"weight": _stack(sd, base, depth, f"{prefix}.{name}.weight")}
        if bias and f"{base}.0.{prefix}.{name}.bias" in sd:
            out["bias"] = _stack(sd, base, depth, f"{prefix}.{name}.bias")
        return out

    return {
        "q_proj": grab("q_proj"),
        "k_proj": grab("k_proj", bias=False),  # whisper k_proj is bias-free
        "v_proj": grab("v_proj"),
        "out_proj": grab("out_proj"),
    }


def _ln(sd: Dict, base: str, depth: int, name: str) -> Dict:
    return {"weight": _stack(sd, base, depth, f"{name}.weight"),
            "bias": _stack(sd, base, depth, f"{name}.bias")}


def _mlp(sd: Dict, base: str, depth: int) -> Dict:
    return {name: {"weight": _stack(sd, base, depth, f"{name}.weight"),
                   "bias": _stack(sd, base, depth, f"{name}.bias")}
            for name in ("fc1", "fc2")}


def convert_state_dict(sd: Dict, cfg: WhisperConfig) -> Dict:
    """HF WhisperModel state_dict → the JAX-layout param tree (numpy).

    Accepts both `model.encoder...` (WhisperForConditionalGeneration) and
    `encoder...` (WhisperModel) prefixes."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model.") :]: v for k, v in sd.items() if k.startswith("model.")}
    eb, db = "encoder.layers", "decoder.layers"
    ne, nd = cfg.encoder_layers, cfg.decoder_layers
    enc_blocks = {
        "self_attn": _attn(sd, eb, ne, "self_attn"),
        "self_ln": _ln(sd, eb, ne, "self_attn_layer_norm"),
        "mlp": _mlp(sd, eb, ne),
        "final_ln": _ln(sd, eb, ne, "final_layer_norm"),
    }
    dec_blocks = {
        "self_attn": _attn(sd, db, nd, "self_attn"),
        "self_ln": _ln(sd, db, nd, "self_attn_layer_norm"),
        "cross_attn": _attn(sd, db, nd, "encoder_attn"),
        "cross_ln": _ln(sd, db, nd, "encoder_attn_layer_norm"),
        "mlp": _mlp(sd, db, nd),
        "final_ln": _ln(sd, db, nd, "final_layer_norm"),
    }

    def pair(prefix):
        return {"weight": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}

    return {
        "encoder": {
            "conv1": pair("encoder.conv1"),
            "conv2": pair("encoder.conv2"),
            "pos_embed": _np(sd["encoder.embed_positions.weight"]),
            "blocks": enc_blocks,
            "ln": pair("encoder.layer_norm"),
        },
        "decoder": {
            "token_embedding": _np(sd["decoder.embed_tokens.weight"]),
            "pos_embed": _np(sd["decoder.embed_positions.weight"]),
            "blocks": dec_blocks,
            "ln": pair("decoder.layer_norm"),
        },
    }


def checkpoint_depths(sd: Dict) -> Dict[str, int]:
    """Encoder and decoder layer counts present in a checkpoint's keys."""
    out = {"encoder": 0, "decoder": 0}
    for k in sd:
        m = re.match(r"(?:model\.)?(encoder|decoder)\.layers\.(\d+)\.", k)
        if m:
            out[m.group(1)] = max(out[m.group(1)], int(m.group(2)) + 1)
    return out


def validate_state_dict(sd: Dict, cfg: WhisperConfig) -> None:
    """Depth and width check BEFORE conversion: a wrong-variant checkpoint
    (e.g. 32-layer large-v3 weights under the 2-layer distil config) would
    otherwise silently truncate into a garbage model."""
    depths = checkpoint_depths(sd)
    if depths["encoder"] != cfg.encoder_layers or depths["decoder"] != cfg.decoder_layers:
        raise ValueError(
            f"Whisper checkpoint has encoder={depths['encoder']}/"
            f"decoder={depths['decoder']} layers but the config expects "
            f"{cfg.encoder_layers}/{cfg.decoder_layers} — wrong variant? "
            "(set models.whisper_variant to match the checkpoint)"
        )
    for k, v in sd.items():
        if k.endswith("embed_tokens.weight") or k.endswith("token_embedding.weight"):
            shape = tuple(getattr(v, "shape", ()))
            if shape and shape != (cfg.vocab_size, cfg.d_model):
                raise ValueError(
                    f"Whisper checkpoint token embedding {shape} != expected "
                    f"({cfg.vocab_size}, {cfg.d_model})"
                )


def load_state_dict(path: str) -> Dict:
    """Checkpoint file -> flat {name: tensor or array} state_dict: torch
    pickles (`.pth`, `pytorch_model.bin`) through torch.load(weights_only=True),
    `.safetensors` through the safetensors package."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(
                f"{path} is a safetensors checkpoint and the `safetensors` package is not "
                "installed; install it or convert the checkpoint to pytorch_model.bin"
            ) from e
        return dict(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def load_whisper(checkpoint_path: str, cfg: WhisperConfig, device, dtype=torch.bfloat16) -> Dict:
    """Checkpoint file -> validated, converted, carried port params on `device`."""
    sd = load_state_dict(checkpoint_path)
    validate_state_dict(sd, cfg)
    return params_from_jax(convert_state_dict(sd, cfg), cfg, device, dtype)
