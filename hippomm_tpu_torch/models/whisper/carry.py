"""Carry a JAX Whisper parameter tree into the port's parameters.

The JAX tree (hippomm_tpu.models.whisper.model.init_whisper, or the
checkpoint converter's output, which convert.convert_state_dict here builds
identically), pulled to numpy by the caller, already uses the torch Linear
(out, in) and Conv1d (out, in, k) layouts, so no transposes are needed. As
for ImageBind (models/imagebind/carry.py): each `blocks` leaf's leading depth
axis is unstacked into a per-layer list, and 2-D `weight` matrices are stored
in the compute dtype; embeddings, convolution kernels, norms and biases stay
fp32.
"""

from __future__ import annotations

from typing import Dict

import torch

from hippomm_tpu_torch.models.imagebind.carry import carry_towers
from hippomm_tpu_torch.models.whisper.model import WhisperConfig


def params_from_jax(tree_of_numpy: Dict, cfg: WhisperConfig, device, dtype=torch.bfloat16) -> Dict:
    """JAX Whisper params (numpy leaves) -> the port's parameter dict."""
    depths = {"encoder": cfg.encoder_layers, "decoder": cfg.decoder_layers}
    return carry_towers(tree_of_numpy, depths, device, dtype)
