"""Megatron-style tensor+sequence parallelism and GPipe pipeline parallelism
for the ImageBind vision tower, over a mesh of torch devices in one process.

Counterpart of hippomm_tpu/parallel/megatron.py, whose `shard_map` program
composes dp × pp × tp × sp. Here the program's per-device locals are lists
of tensors, one per rank of an axis, and its collectives are
parallel/collectives:

  * tp (tensor): attention heads and MLP hidden split over "model";
  * sp (sequence): between blocks the residual stream is split over the
    TOKEN axis across "model" — LayerNorms and residual adds run on 1/mp of
    the tokens; `all_gather` (tokens) feeds attention/MLP and
    `psum_scatter` (tokens) takes the place of a pure-TP block's psum;
  * pp (pipeline): the block stack splits into `pipe` stages, microbatches
    rotate stage to stage through `ppermute` on a GPipe schedule of
    M + S - 1 ticks, every stage running on every tick as in JAX;
  * dp (data): a microbatch's rows split over "data".

Every collective is differentiable torch, so autograd runs the mirrored
pipeline backward (train/contrastive.make_train_step_pp).

Each rank's share is parallel/tensor_parallel.rank_block, the per-rank
body the TP towers run too, with the token all_gather and psum_scatter as
its collectives; it runs the port's kernels through models/layers.
Attention is K1 (ops/flash_attention.flash_mha) with q over all T_pad rows
and k/v over the first t_valid rows: JAX masks the padded KEY positions to
-inf (its `_token_mask`), which is dropping those keys, so every row — the
padded query rows too — gets JAX's result, on the plain route as well. The
LayerNorm (JAX's `_ln`) is models/layers.layer_norm. The MLP is K2
(ops/fused_mlp) per shard with a zero fc2 bias; fc2's bias is added after
the psum_scatter, as JAX adds it (megatron.py:208).

Layout note: the packed torch in_proj (3D, D) cannot be row-sharded directly
(rank 0 would get all of Q plus half of K); `tp_block_layout` re-packs it as
(3, D, D) so the head axis shards cleanly.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from hippomm_tpu_torch.models.imagebind.model import ImageBindConfig, vision_embed, vision_head
from hippomm_tpu_torch.parallel.collectives import all_gather, ppermute, psum_scatter
from hippomm_tpu_torch.parallel.mesh import Mesh, Sharded, device_at, gather, positions
from hippomm_tpu_torch.parallel.tensor_parallel import LocalParams, rank_block

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Layout: per-layer blocks -> TP-shardable stacked leaves (+ pipeline stages)
# ---------------------------------------------------------------------------


def tp_block_layout(blocks: List[Dict]) -> Params:
    """The port's per-layer block list (models/layers.py layout) -> a flat
    dict of depth-stacked leaves that shard cleanly over ("pipe", "model"):

      qkv_w (L, 3, D, D)   qkv_b (L, 3, D)     [head axis = dim 2]
      out_w (L, D, D)      out_b (L, D)        [in-dim sharded]
      fc1_w (L, H, D)      fc1_b (L, H)
      fc2_w (L, D, H)      fc2_b (L, D)
      ln1_w/b, ln2_w/b (L, D)
    """
    if "bias_k" in blocks[0]["attn"]:
        raise NotImplementedError("bias_kv blocks (audio tower) have no TP path")

    def stack(*keys):
        leaves = []
        for b in blocks:
            for k in keys:
                b = b[k]
            leaves.append(b)
        return torch.stack(leaves)

    in_w = stack("attn", "in_proj", "weight")  # (L, 3D, D)
    depth, three_d, d = in_w.shape
    assert three_d == 3 * d
    return {
        "qkv_w": in_w.reshape(depth, 3, d, d),
        "qkv_b": stack("attn", "in_proj", "bias").reshape(depth, 3, d),
        "out_w": stack("attn", "out_proj", "weight"),
        "out_b": stack("attn", "out_proj", "bias"),
        "fc1_w": stack("mlp", "fc1", "weight"),
        "fc1_b": stack("mlp", "fc1", "bias"),
        "fc2_w": stack("mlp", "fc2", "weight"),
        "fc2_b": stack("mlp", "fc2", "bias"),
        "ln1_w": stack("norm_1", "weight"),
        "ln1_b": stack("norm_1", "bias"),
        "ln2_w": stack("norm_2", "weight"),
        "ln2_b": stack("norm_2", "bias"),
    }


def add_stage_axis(packed: Params, stages: int) -> Params:
    """(L, ...) leaves -> (S, L/S, ...) for pipeline-stage sharding."""
    depth = packed["qkv_w"].shape[0]
    if depth % stages != 0:
        raise ValueError(f"depth {depth} not divisible by {stages} stages")
    return {k: v.reshape(stages, depth // stages, *v.shape[1:]) for k, v in packed.items()}


#: spec tails per leaf (leading axes — stage and/or depth — prepended)
_TP_AXIS = {
    "qkv_w": (None, "model", None),
    "qkv_b": (None, "model"),
    "out_w": (None, "model"),
    "out_b": (None,),
    "fc1_w": ("model", None),
    "fc1_b": ("model",),
    "fc2_w": (None, "model"),
    "fc2_b": (None,),
    "ln1_w": (None,),
    "ln1_b": (None,),
    "ln2_w": (None,),
    "ln2_b": (None,),
}


def tp_specs(staged: bool) -> Dict[str, tuple]:
    """Placement specs for tp_block_layout leaves; staged adds the leading
    ("pipe",) stage axis before the depth axis."""
    lead = ("pipe", None) if staged else (None,)
    return {k: lead + tail for k, tail in _TP_AXIS.items()}


def place_tp_params(packed: Params, mesh: Mesh, staged: bool = False, requires_grad: bool = False) -> Dict[str, Sharded]:
    """The packed block leaves placed per tp_specs on `mesh` (Sharded
    leaves; grad leaves for training with requires_grad)."""
    specs = tp_specs(staged)
    return {k: Sharded.place(v, specs[k], mesh, requires_grad=requires_grad) for k, v in packed.items()}


# ---------------------------------------------------------------------------
# The TP+SP block: lists of per-rank tensors along "model"
# ---------------------------------------------------------------------------


def tp_sp_block(pbs: List[Dict], xs: List[torch.Tensor], heads: int, t_valid: int, eps: float,
                dtype) -> List[torch.Tensor]:
    """One pre-LN encoder block over the model ranks, tokens split over
    "model" on entry and exit.

    xs[j]: rank j's (B, T_pad/mp, D) token shard of the residual stream
    (dtype). pbs[j]: its block of tp_block_layout sharded per tp_specs, in
    models/layers' layout (`_as_layers`): in_proj (3·D/mp, D), out_proj (D,
    D/mp), fc1 (H/mp, D), fc2 (D, H/mp). The body is tensor_parallel's
    rank_block: LayerNorm on the local tokens, all_gather (tokens) into
    attention and the MLP, psum_scatter (tokens) of their partial products,
    the biases after it; k/v over the first t_valid tokens."""
    return rank_block(pbs, xs, heads, lambda hs, n: all_gather(hs, axis=1),
                      lambda parts: psum_scatter(parts, scatter_dimension=1), eps, dtype, kv_rows=t_valid)


def _run_blocks(blocks_local: List[List[Dict]], xs: List[torch.Tensor], heads: int, t_valid: int, eps: float,
                dtype, remat: bool) -> List[torch.Tensor]:
    """tp_sp_block over the local blocks: blocks_local[j][i] is rank j's
    block i; `remat` recomputes each block in the backward
    (torch.utils.checkpoint, JAX's jax.checkpoint)."""
    xs = [x.to(dtype) for x in xs]
    for i in range(len(blocks_local[0])):
        pbs = [blocks[i] for blocks in blocks_local]
        if remat:
            xs = checkpoint(tp_sp_block, pbs, xs, heads, t_valid, eps, dtype, use_reentrant=False)
        else:
            xs = tp_sp_block(pbs, xs, heads, t_valid, eps, dtype)
    return xs


# ---------------------------------------------------------------------------
# Token padding (the ViT token count — 257 for huge — is not divisible by mp)
# ---------------------------------------------------------------------------


def _padded_tokens(t: int, mp: int) -> int:
    return ((t + mp - 1) // mp) * mp


# ---------------------------------------------------------------------------
# Mesh plumbing
# ---------------------------------------------------------------------------


def _coords(mesh: Mesh, **fixed) -> tuple:
    return tuple(fixed.get(a, 0) for a in mesh.axis_names)


def _as_layers(pb: Params) -> Dict:
    """A block of tp_block_layout leaves in models/layers' block layout: the
    (3, D/mp, D) qkv rows are the local heads' packed in_proj."""
    three, dl, d = pb["qkv_w"].shape
    return {"norm_1": {"weight": pb["ln1_w"], "bias": pb["ln1_b"]},
            "attn": {"in_proj": {"weight": pb["qkv_w"].reshape(three * dl, d), "bias": pb["qkv_b"].reshape(-1)},
                     "out_proj": {"weight": pb["out_w"], "bias": pb["out_b"]}},
            "norm_2": {"weight": pb["ln2_w"], "bias": pb["ln2_b"]},
            "mlp": {"fc1": {"weight": pb["fc1_w"], "bias": pb["fc1_b"]},
                    "fc2": {"weight": pb["fc2_w"], "bias": pb["fc2_b"]}}}


def _block_locals(packed: Dict[str, Sharded], pos: tuple, staged: bool) -> List[Dict]:
    """Position `pos`'s per-block locals, in models/layers' layout: its
    block of every leaf, split along the (local) depth axis."""
    local = {k: v.local(pos) for k, v in packed.items()}
    if staged:
        local = {k: v[0] for k, v in local.items()}
    depth = local["qkv_w"].shape[0]
    return [_as_layers({k: v[i] for k, v in local.items()}) for i in range(depth)]


def _embed_params(params: Dict, pos: tuple, mesh: Mesh) -> Dict:
    """The vision embed/head leaves at `pos` (replicated Sharded leaves'
    blocks there, or tensors moved to its device)."""
    embed = {k: v for k, v in params["vision"].items() if k != "blocks"}
    return LocalParams({"vision": embed}, mesh, {}).at(pos)


def _check_mesh(mesh: Mesh, heads: int) -> int:
    if "replica" in mesh.axis_names:
        raise ValueError("the Megatron paths run on a ('data', 'model') or ('data', 'pipe', 'model') mesh")
    mp = mesh.shape["model"]
    if heads % mp != 0:
        raise ValueError(f"heads {heads} not divisible by model axis {mp}")
    return mp


# ---------------------------------------------------------------------------
# SP+TP forward (no pipeline): ("data", "model")
# ---------------------------------------------------------------------------


def vision_forward_tp_sp(params: Dict, packed_blocks: Dict[str, Sharded], images, cfg: ImageBindConfig,
                         mesh: Mesh, dtype=torch.bfloat16, remat: bool = False) -> torch.Tensor:
    """ViT forward with tensor+sequence parallelism over `mesh`.

    params: the ordinary tree (its vision embed/head leaves, tensors or
    replicated Sharded leaves); packed_blocks: tp_block_layout(params
    ["vision"]["blocks"]) placed with place_tp_params(staged=False). The
    batch splits over "data"; returns (B, 1024) on the mesh's first device,
    vision_forward's result (dtype=fp32: exact up to psum_scatter's
    summation order)."""
    mp = _check_mesh(mesh, cfg.vision.heads)
    dsize = mesh.shape["data"]
    b = images.shape[0]
    if b % dsize:
        raise ValueError(f"batch {b} does not split over data axis {dsize}")
    per = b // dsize
    outs = []
    for d in range(dsize):
        ranks = [_coords(mesh, data=d, model=j) for j in range(mp)]
        devs = [device_at(mesh, pos) for pos in ranks]
        emb = _embed_params(params, ranks[0], mesh)
        x = vision_embed(emb, torch.as_tensor(images[d * per:(d + 1) * per]).to(devs[0]), cfg, dtype)
        t_valid = x.shape[1]
        t_pad = _padded_tokens(t_valid, mp)
        x = torch.nn.functional.pad(x, (0, 0, 0, t_pad - t_valid))
        tl = t_pad // mp
        xs = [x[:, j * tl:(j + 1) * tl].to(devs[j]) for j in range(mp)]
        locs = [_block_locals(packed_blocks, pos, staged=False) for pos in ranks]
        xs = _run_blocks(locs, xs, cfg.vision.heads, t_valid, cfg.vision.eps, dtype, remat)
        outs.append(vision_head(emb, xs[0][:, 0].float(), cfg, dtype))
    return gather(outs, device_at(mesh, positions(mesh)[0]))


# ---------------------------------------------------------------------------
# GPipe pipeline: ("data", "pipe", "model")
# ---------------------------------------------------------------------------


def pipeline_blocks(staged_blocks: Dict[str, Sharded], x: torch.Tensor, mesh: Mesh, heads: int, t_valid: int,
                    eps: float, dtype, remat: bool = False) -> torch.Tensor:
    """Run the staged block stack as a GPipe pipeline.

    staged_blocks: (S, L/S, ...) leaves placed per tp_specs(staged=True).
    x: (M, mb, T_pad, D) microbatched token stream (fp32 or dtype), of which
    the first t_valid tokens are real. Schedule: M + S - 1 ticks; each tick
    every stage runs its L/S blocks on its current microbatch, then the
    activations rotate one stage over "pipe" (ppermute). Stage 0 injects
    microbatch t; stage S-1 writes output t - (S - 1). Returns the (M, mb,
    T_pad, D) output in `dtype` on x's device."""
    stages, mp, dsize = mesh.shape["pipe"], mesh.shape["model"], mesh.shape["data"]
    n_micro, mb, t_pad, _ = x.shape
    if mb % dsize or t_pad % mp:
        raise ValueError(f"microbatch {mb} / tokens {t_pad} must divide mesh {dsize} x {mp}")
    mbl, tl = mb // dsize, t_pad // mp
    perm = [(i, (i + 1) % stages) for i in range(stages)]
    out = [[None] * dsize for _ in range(n_micro)]
    for d in range(dsize):
        pos = [[_coords(mesh, data=d, pipe=s, model=j) for j in range(mp)] for s in range(stages)]
        devs = [[device_at(mesh, q) for q in row] for row in pos]
        locs = [[_block_locals(staged_blocks, q, staged=True) for q in row] for row in pos]
        state = [[torch.zeros((mbl, tl, x.shape[-1]), dtype=dtype, device=dev) for dev in row] for row in devs]
        for t in range(n_micro + stages - 1):
            inject = x[min(t, n_micro - 1), d * mbl:(d + 1) * mbl]
            hs = []
            for s in range(stages):
                if s == 0:
                    h = [inject[:, j * tl:(j + 1) * tl].to(devs[0][j]).to(dtype) for j in range(mp)]
                else:
                    h = state[s]
                h = _run_blocks(locs[s], h, heads, t_valid, eps, dtype, remat)
                if s == stages - 1 and t >= stages - 1:
                    out[t - (stages - 1)][d] = torch.cat([hj.to(x.device) for hj in h], dim=1)
                hs.append(h)
            # rotate one stage over "pipe", for each model rank
            rotated = [ppermute([hs[s][j] for s in range(stages)], perm) for j in range(mp)]
            state = [[rotated[j][s] for j in range(mp)] for s in range(stages)]
    return torch.stack([torch.cat(row, dim=0) for row in out])


def vision_forward_pp(params: Dict, staged_blocks: Dict[str, Sharded], images, cfg: ImageBindConfig, mesh: Mesh,
                      n_micro: int = 2, dtype=torch.bfloat16, remat: bool = False) -> torch.Tensor:
    """ViT forward as a dp×pp×tp×sp program on a ("data", "pipe", "model")
    mesh: the embedding and head on the mesh's first device, the blocks as
    pipeline_blocks. staged_blocks: add_stage_axis(tp_block_layout(blocks),
    S) placed with place_tp_params(staged=True). The batch must split into
    n_micro microbatches, each divisible by the data axis."""
    mp = _check_mesh(mesh, cfg.vision.heads)
    b = images.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    first = positions(mesh)[0]
    dev = device_at(mesh, first)
    emb = _embed_params(params, first, mesh)
    x = vision_embed(emb, torch.as_tensor(images).to(dev), cfg, dtype)  # (B, T, W) fp32
    t_valid = x.shape[1]
    t_pad = _padded_tokens(t_valid, mp)
    x = torch.nn.functional.pad(x, (0, 0, 0, t_pad - t_valid))
    x = x.reshape(n_micro, b // n_micro, t_pad, x.shape[-1])
    x = pipeline_blocks(staged_blocks, x, mesh, cfg.vision.heads, t_valid, cfg.vision.eps, dtype, remat)
    cls_tok = x.reshape(b, t_pad, -1)[:, 0].float()
    return vision_head(emb, cls_tok, cfg, dtype)
