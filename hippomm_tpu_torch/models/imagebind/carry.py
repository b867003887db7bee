"""Carry a JAX ImageBind parameter tree into the port's parameters.

The JAX tree (hippomm_tpu.models.imagebind.model.init_imagebind or its
checkpoint converter, or the port's convert.convert_state_dict), pulled to
numpy by the caller, already uses the torch Linear (out, in) layout, so no
transposes are needed. Two changes only: each `blocks` leaf's leading depth
axis is unstacked into a per-layer list (a leaf that is already a list of
per-layer arrays is taken as it is), and 2-D `weight` matrices are stored in
the compute dtype (the forward casts them to it anyway); everything else
stays fp32. Leaves are copied to the device one at a time.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from hippomm_tpu_torch.models.imagebind.model import ImageBindConfig


def _tensor(a, device, dtype, name: str, ndim: int) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)
    return t.to(dtype) if name == "weight" and ndim == 2 else t


def _convert(tree: Any, device, dtype, name: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    a = np.asarray(tree)
    return _tensor(a, device, dtype, name, a.ndim)


def _unstack(tree: Any, depth: int, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, depth, i) for k, v in tree.items()}
    if isinstance(tree, list):  # already per layer (convert.convert_state_dict)
        if len(tree) != depth:
            raise ValueError(f"block leaf has {len(tree)} layers, expected depth {depth}")
        return tree[i]
    a = np.asarray(tree)
    if a.shape[0] != depth:
        raise ValueError(f"stacked block leaf has leading dim {a.shape[0]}, expected depth {depth}")
    return a[i]


def carry_towers(tree_of_numpy: Dict, depths: Dict[str, int], device, dtype) -> Dict:
    """{tower: {key: leaf or subtree}} with depth-stacked `blocks` -> the same
    tree with each tower's `blocks` as a list of `depths[tower]` per-layer
    dicts; 2-D `weight` leaves in `dtype`, everything else fp32 tensors."""
    out: Dict = {}
    for tower, sub in tree_of_numpy.items():
        conv = {}
        for key, val in sub.items():
            if key == "blocks":
                depth = depths[tower]
                conv[key] = [_convert(_unstack(val, depth, i), device, dtype) for i in range(depth)]
            else:
                conv[key] = _convert(val, device, dtype, key)
        out[tower] = conv
    return out


def params_from_jax(tree_of_numpy: Dict, cfg: ImageBindConfig, device, dtype=torch.bfloat16) -> Dict:
    """JAX ImageBind params (numpy leaves) -> the port's parameter dict."""
    depths = {"vision": cfg.vision.depth, "audio": cfg.audio.depth, "text": cfg.text.depth}
    return carry_towers(tree_of_numpy, depths, device, dtype)
