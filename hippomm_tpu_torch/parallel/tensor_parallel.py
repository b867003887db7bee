"""Tensor parallelism of the ImageBind towers over a mesh, in one process.

Counterpart of what JAX's GSPMD partitioner makes of the towers under
hippomm_tpu/parallel/mesh.param_shardings and data_sharding (the train
step of hippomm_tpu/train/contrastive.py): the batch splits over replica ×
data; in every encoder block the attention heads and the MLP hidden split
over "model", and a psum over the model ranks follows out_proj and fc2, whose
biases are added once. The parameters are `Sharded` leaves placed by
param_shardings; the patchify, embeddings, norms and heads are replicated.

Each model rank's share runs through the port's kernels at its per-shard
shapes (models/layers): K1 (K4 with HIPPOMM_FLASH_BTHD=1) at heads/mp, K2 at
hidden/mp with a zero fc2 bias, or K3 with HIPPOMM_FUSED_BLOCK=1, where the
first rank's call adds the residual and fc2's bias and the others' add
neither, so the psum is the half-block. The text tower's causal attention
takes the plain route, as on one device. `rank_block` is the per-rank block
body, shared with parallel/megatron's TP+SP block: the two layouts differ
only in the collectives around it.

The packed in_proj (3D, D) is split over "model" by rows, as JAX's spec says,
so rank 0 holds all of Q and part of K. Each rank's compute takes its
heads' Q, K and V rows from whichever blocks hold them (`Sharded.take`);
GSPMD reshards the same way without saying so. A block whose weights the
guard left replicated (a dimension "model" does not divide), or whose heads
the model axis does not divide, runs whole on the first model rank.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from hippomm_tpu_torch.models import layers as L
from hippomm_tpu_torch.models.imagebind.model import (
    ImageBindConfig,
    causal_mask,
    text_embed,
    text_head,
    vision_embed,
    vision_head,
)
from hippomm_tpu_torch.ops import fused_mlp as fm
from hippomm_tpu_torch.parallel.collectives import reduce_sum
from hippomm_tpu_torch.parallel.mesh import Mesh, Sharded, device_at, gather, positions

Pos = Tuple[int, ...]


def batch_groups(mesh: Mesh) -> List[List[Pos]]:
    """For each batch shard, in shard order (replica-major, then data), the
    mesh positions of its model ranks, at index 0 of the pipe axis."""
    names = mesh.axis_names
    groups = []
    for pos in positions(mesh):
        coords = dict(zip(names, pos))
        if coords["model"] or coords.get("pipe", 0):
            continue
        groups.append([tuple(j if a == "model" else coords[a] for a in names)
                       for j in range(mesh.shape["model"])])
    return groups


def _split(leaf, dim: int) -> bool:
    return isinstance(leaf, Sharded) and leaf.spec[dim] == "model"


def attn_split(p: Dict, heads: int, mp: int) -> bool:
    """Whether a block's attention splits over the model ranks: its in_proj
    rows and out_proj columns sharded over "model", and whole heads a rank."""
    return mp > 1 and heads % mp == 0 and _split(p["in_proj"]["weight"], 0) and _split(p["out_proj"]["weight"], 1)


def mlp_split(p: Dict, mp: int) -> bool:
    return mp > 1 and _split(p["fc1"]["weight"], 0) and _split(p["fc2"]["weight"], 1)


class LocalParams:
    """Each mesh position's view of a tree of Sharded parameters (or plain
    tensors, moved to the position's device), built once a step and shared
    by the positions of one device and model rank: a replicated leaf is its
    block on the device; a split attention takes its heads' Q/K/V rows of
    in_proj; a block that does not split holds its whole weights on the
    first model rank. `heads` gives each tower's (top-level key's) heads."""

    def __init__(self, tree, mesh: Mesh, heads: Dict[str, int]):
        self.tree, self.mesh, self.heads = tree, mesh, heads
        self._cache: Dict[Tuple[torch.device, int], Dict] = {}

    def at(self, pos: Pos) -> Dict:
        model = dict(zip(self.mesh.axis_names, pos))["model"]
        key = (device_at(self.mesh, pos), model)
        if key not in self._cache:
            self._cache[key] = self._build(self.tree, pos, model, None)
        return self._cache[key]

    def _build(self, node, pos: Pos, model: int, tower: str):
        if isinstance(node, Sharded):
            return node.local(pos)
        if isinstance(node, torch.Tensor):
            return node.to(device_at(self.mesh, pos))
        if isinstance(node, list):
            return [self._build(v, pos, model, tower) for v in node]
        if not isinstance(node, dict):
            return node
        mp = self.mesh.shape["model"]
        if "attn" in node and "mlp" in node:  # an encoder block
            out = {k: self._build(v, pos, model, tower) for k, v in node.items() if k not in ("attn", "mlp")}
            out["attn"] = self._attn(node["attn"], pos, model, attn_split(node["attn"], self.heads[tower], mp))
            split = mlp_split(node["mlp"], mp)
            out["mlp"] = None if model and not split else {k: self._leaves(v, pos, split)
                                                             for k, v in node["mlp"].items()}
            return out
        return {k: self._build(v, pos, model, tower or k) for k, v in node.items()}

    def _leaves(self, sub: Dict, pos: Pos, split: bool) -> Dict:
        """A linear's leaves: its local blocks when split, else its whole
        tensors on the position's device."""
        if split:
            return {k: v.local(pos) for k, v in sub.items()}
        return {k: v.full(device_at(self.mesh, pos)) for k, v in sub.items()}

    def _attn(self, p: Dict, pos: Pos, model: int, split: bool) -> Optional[Dict]:
        if model and not split:
            return None
        out = {k: v.local(pos) for k, v in p.items() if k not in ("in_proj", "out_proj")}
        if not split:
            out.update({k: self._leaves(p[k], pos, False) for k in ("in_proj", "out_proj")})
            return out
        w, b = p["in_proj"]["weight"], p["in_proj"]["bias"]
        d = w.shape[0] // 3
        dl = d // self.mesh.shape["model"]

        def heads_rows(leaf):  # this rank's Q, K and V rows, in that order
            return torch.cat([leaf.take(pos, 0, part * d + model * dl, part * d + (model + 1) * dl)
                              for part in range(3)], dim=0)

        out["in_proj"] = {"weight": heads_rows(w), "bias": heads_rows(b)}
        out["out_proj"] = {k: v.local(pos) for k, v in p["out_proj"].items()}
        return out


def tp_blocks(x: torch.Tensor, locs: List[List[Dict]], devices: List[torch.device], heads: int,
              mask: Optional[torch.Tensor], eps: float, dtype) -> torch.Tensor:
    """A stack of pre-LN encoder blocks over one batch shard's model ranks.

    locs[j]: rank j's LocalParams view of each block (the specs pick the
    split); devices[j]: its device. x (B, T, D) is the residual stream on the first rank's
    device, in `dtype`: each rank reads its LayerNorm there (a broadcast,
    whose gradient is the sum over the ranks), and the ranks' partial
    products sum there (a psum that one rank reads). Returns the stream
    after the last block, on that device."""
    dev0 = devices[0]

    def spread(hs, n):
        return [hs[0].to(dev) for dev in devices[:n]]

    def collect(parts):
        return [reduce_sum(parts, dev0)]

    x = x.to(dtype)
    for i in range(len(locs[0])):
        x = rank_block([loc[i] for loc in locs], [x], heads, spread, collect, eps, dtype, mask=mask)[0]
    return x


def rank_block(locs: List[Dict], xs: List[torch.Tensor], heads: int, spread, collect, eps: float, dtype,
               mask: Optional[torch.Tensor] = None, kv_rows: Optional[int] = None) -> List[torch.Tensor]:
    """One pre-LN encoder block whose attention heads and MLP hidden split
    over model ranks; the per-rank body of both the TP towers (tp_blocks)
    and Megatron's TP+SP block (parallel/megatron.tp_sp_block).

    locs[j]: rank j's block in models/layers' layout, cut to its share:
    in_proj its heads' Q, K and V rows (3·D/mp, D), out_proj (D, D/mp), fc1
    (F/mp, D), fc2 (D, F/mp); "attn" or "mlp" None on a rank that does not
    run that half (a block left whole runs on the first rank). xs: the
    residual stream's pieces in `dtype`, one tensor (TP) or one token shard
    a rank (SP). The two collectives are the layouts' only difference:
    spread(pieces, n) gives the first n ranks their full input from the
    pieces (TP: a broadcast; SP: all_gather over tokens), collect(partials)
    the pieces' sums of the ranks' partial products (TP: a sum on the first
    rank; SP: psum_scatter over tokens). out_proj's and fc2's biases are
    added once, after collect; K3 (HIPPOMM_FUSED_BLOCK=1) instead adds the
    residual and fc2's bias inside the first rank's launch. kv_rows: keys
    and values from the first kv_rows tokens only (padded tokens dropped).
    Returns the pieces after the block."""
    attn = [loc["attn"] for loc in locs if loc["attn"] is not None]
    hs = spread([L.layer_norm(loc["norm_1"], x, eps, out_dtype=dtype) for loc, x in zip(locs, xs)], len(attn))
    parts = [L.attention(dict(pa, out_proj={"weight": pa["out_proj"]["weight"]}), h, num_heads=heads // len(attn),
                         mask=None if mask is None else mask.to(h.device), dtype=dtype, kv_rows=kv_rows)
             for pa, h in zip(attn, hs)]
    xs = [x + (p + loc["attn"]["out_proj"]["bias"].float()).to(dtype) for x, p, loc in zip(xs, collect(parts), locs)]

    mlps = [(loc["mlp"], loc["norm_2"]) for loc in locs if loc["mlp"] is not None]
    f_local, d = mlps[0][0]["fc1"]["weight"].shape
    n = sum(x.numel() for x in xs) // d
    if fm.fused_block_default() and fm.fused_mlp_supported(n, d, f_local):
        parts = []
        for j, ((pm, norm), h) in enumerate(zip(mlps, spread(xs, len(mlps)))):
            b2 = pm["fc2"]["bias"] if j == 0 else torch.zeros_like(pm["fc2"]["bias"])
            parts.append(fm.fused_ln_mlp_residual(
                h.reshape(n, d), norm["weight"], norm["bias"], pm["fc1"]["weight"], pm["fc1"]["bias"],
                pm["fc2"]["weight"], b2, eps, residual=j == 0).float().reshape(h.shape))
        return [p.to(dtype) for p in collect(parts)]
    hs = spread([L.layer_norm(loc["norm_2"], x, eps, out_dtype=dtype) for loc, x in zip(locs, xs)], len(mlps))
    parts = [L.mlp({"fc1": pm["fc1"], "fc2": {"weight": pm["fc2"]["weight"],
                                              "bias": torch.zeros_like(pm["fc2"]["bias"])}},
                   h, dtype=dtype, cast_out=True).float()
             for (pm, _), h in zip(mlps, hs)]
    return [x + (p + loc["mlp"]["fc2"]["bias"].float()).to(dtype) for x, p, loc in zip(xs, collect(parts), locs)]


def _tower_mesh(params: Dict, batch, cfg: ImageBindConfig, mesh: Mesh, dtype, tower: str) -> torch.Tensor:
    groups = batch_groups(mesh)
    b = batch.shape[0]
    if b % len(groups):
        raise ValueError(f"batch {b} does not split over {len(groups)} batch shards")
    per = b // len(groups)
    tcfg = getattr(cfg, tower)
    loc = LocalParams({tower: params[tower]}, mesh, {tower: tcfg.heads})
    outs = []
    for s, group in enumerate(groups):
        devs = [device_at(mesh, pos) for pos in group]
        locs = [loc.at(pos) for pos in group]
        xb = torch.as_tensor(batch[s * per:(s + 1) * per]).to(devs[0])
        blocks = [lp[tower]["blocks"] for lp in locs]
        if tower == "vision":
            x = vision_embed(locs[0], xb, cfg, dtype)
            x = tp_blocks(x, blocks, devs, tcfg.heads, None, tcfg.eps, dtype)
            outs.append(vision_head(locs[0], x[:, 0], cfg, dtype))
        else:
            x = text_embed(locs[0], xb, cfg)
            x = tp_blocks(x, blocks, devs, tcfg.heads, causal_mask(xb.shape[1], devs[0]), tcfg.eps, dtype)
            outs.append(text_head(locs[0], x, xb, cfg, dtype))
    return gather(outs, device_at(mesh, groups[0][0]))


def vision_forward_mesh(params: Dict, images, cfg: ImageBindConfig, mesh: Mesh, dtype=torch.bfloat16) -> torch.Tensor:
    """vision_forward over a mesh: params a tree of Sharded leaves placed by
    param_shardings, images (B, 3, S, S) split over the batch shards, each
    shard's tower tensor-parallel over its model ranks. Returns (B, 1024)
    on the mesh's first device."""
    return _tower_mesh(params, images, cfg, mesh, dtype, "vision")


def text_forward_mesh(params: Dict, tokens, cfg: ImageBindConfig, mesh: Mesh, dtype=torch.bfloat16) -> torch.Tensor:
    """text_forward over a mesh, as vision_forward_mesh."""
    return _tower_mesh(params, tokens, cfg, mesh, dtype, "text")
