"""Parameter checkpoints of the port's training path: one torch file.

Counterpart of hippomm_tpu/train/checkpoint.py. The JAX package writes orbax
directories; the port imports neither orbax nor jax, so it cannot read them.
Parameters cross between the packages as numpy trees instead
(models/imagebind/carry.params_from_jax).

A tree of Sharded leaves (parallel/mesh) is saved whole: each leaf gathered
from its blocks. `load_params(shardings=specs, mesh=mesh)` places what it
reads by the specs on the mesh, as orbax restores into NamedShardings.

The file is the state dict of the nested parameter tree: dotted paths
("vision.blocks.0.attn.in_proj.weight") to tensors, saved with torch.save
and read back with weights_only=True. A dict whose keys are 0 .. n-1 is a
per-layer list (`blocks`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from hippomm_tpu_torch.parallel.mesh import Mesh, Sharded, shard_tree
from hippomm_tpu_torch.utils.device import DeviceLike, resolve_device


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The nested tree (dicts, per-layer lists, tensor or Sharded leaves) as
    {dotted path: leaf}, in the tree's order."""
    if isinstance(tree, (torch.Tensor, Sharded)):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, torch.Tensor] = {}
    for key, sub in items:
        out.update(flatten_params(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def unflatten_params(flat: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of `flatten_params`."""
    root: Dict = {}
    for path, leaf in flat.items():
        node = root
        *parents, last = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def save_params(path: str, params: Any) -> None:
    """Write the tree's leaves (detached; a Sharded leaf gathered whole on
    the host) to `path` as one torch file."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    flat = {}
    for k, v in flatten_params(params).items():
        flat[k] = (v.full("cpu") if isinstance(v, Sharded) else v).detach()
    torch.save(flat, path)


def load_params(path: str, like: Optional[Any] = None, device: DeviceLike = None,
                shardings: Optional[Any] = None, mesh: Optional[Mesh] = None) -> Dict:
    """Read a `save_params` file. `like` fixes the structure, shapes, dtypes,
    devices and requires_grad of the result, and a mismatch raises
    ValueError; without it the leaves go to `device` (CUDA unless the caller
    asks for the CPU). `shardings` (a tree of specs, as
    parallel/mesh.param_shardings gives) places every leaf by its spec on
    `mesh` instead; a `like` of Sharded leaves gives their specs and
    requires_grad."""
    flat = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if shardings is not None and mesh is None:
        raise ValueError("load_params(shardings=...) needs the mesh the specs name: pass mesh=")
    if like is None:
        tree = unflatten_params(flat)
        if shardings is not None:
            return shard_tree(tree, shardings, mesh)
        dev = resolve_device(device)
        return unflatten_params({k: v.to(dev) for k, v in flat.items()})
    want = flatten_params(like)
    if set(flat) != set(want):
        missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
        raise ValueError(f"checkpoint {path} does not match `like`: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    out = {}
    for key, ref in want.items():
        got = flat[key]
        if tuple(got.shape) != tuple(ref.shape) or got.dtype != ref.dtype:
            raise ValueError(f"checkpoint leaf {key}: {tuple(got.shape)} {got.dtype}, "
                             f"`like` has {tuple(ref.shape)} {ref.dtype}")
        if isinstance(ref, Sharded):
            grad = any(t.requires_grad for t in ref.blocks.values())
            out[key] = Sharded.place(got, ref.spec, ref.mesh, requires_grad=grad)
        elif shardings is None:
            out[key] = got.to(ref.device).requires_grad_(ref.requires_grad)
        else:
            out[key] = got
    tree = unflatten_params(out)
    if shardings is not None and not any(isinstance(v, Sharded) for v in want.values()):
        tree = shard_tree(tree, shardings, mesh)
    return tree
