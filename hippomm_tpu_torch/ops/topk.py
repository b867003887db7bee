"""K5: exact cosine top-k of one query over a feature store — Hopper kernel +
plain version.

Counterpart of hippomm_tpu/ops/pallas_topk.py (the Pallas `_topk_kernel`,
entered through `pallas_top_k_cosine`): query (D,), feats (N, D) → the k
best (values (k,) fp32, row indices (k,) int32) by cosine similarity, rows
normalised by rsqrt(max(Σf², 1e-16)) and the query by max(‖q‖, 1e-8), k ≤
128. Only the k values and k indices leave the card.

The kernel is CUDA C++ in csrc/topk_cosine.cu: one block per 1024-row tile
computes its similarities from one read of the rows and keeps its best k,
then one block merges the tiles' candidates. `top_k_cosine_ref` is the same
function in plain PyTorch. Both order the result by value, then by lower row
index at equal values — lax.top_k's order, which the JAX product route
(ops/similarity.top_k_cosine) uses; the TPU kernel's own merge let a later
tile win a tie. k > N raises (the TPU kernel padded with −3e38 / index 0).

The single-query device route of retrieval/search.FeatureSearchIndex runs
through `top_k_cosine_kernel`: the kernel for a CUDA tensor, the plain
version for a CPU tensor; a CUDA call the kernel cannot take raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

MAX_K = 128  # the TPU kernel's contract (one 128-lane row of running top-k)


def _check(query: torch.Tensor, feats: torch.Tensor, k: int) -> None:
    if feats.dim() != 2 or query.numel() != feats.shape[1]:
        raise ValueError(
            f"top_k_cosine_kernel takes query (D,) and feats (N, D), got {tuple(query.shape)} "
            f"and {tuple(feats.shape)}"
        )
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds kernel contract (<= {MAX_K})")
    if not 1 <= k <= feats.shape[0]:
        raise ValueError(f"k={k} must be in [1, N={feats.shape[0]}]")
    if query.device != feats.device:
        raise ValueError("top_k_cosine_kernel: query and feats must be on one device")


def top_k_cosine_ref(query: torch.Tensor, feats: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: normalise each row, mat-vec with the unit query, then
    the k best by a stable descending sort (value, then lower row index)."""
    _check(query, feats, k)
    f = feats.float()
    q = query.reshape(-1).float()
    q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-8)
    inv = torch.rsqrt(torch.clamp((f * f).sum(dim=1), min=1e-16))
    sims = (f * inv[:, None]) @ q
    vals, idx = torch.sort(sims, descending=True, stable=True)
    return vals[:k], idx[:k].to(torch.int32)


def top_k_cosine_kernel(query: torch.Tensor, feats: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (k,) fp32, indices (k,) int32): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Counts kernel launches in
    `top_k_cosine_kernel.launches`."""
    _check(query, feats, k)
    if feats.device.type == "cpu":
        return top_k_cosine_ref(query, feats, k)
    if feats.device.type != "cuda":
        raise ValueError(f"top_k_cosine_kernel: unsupported device {feats.device}")
    n, d = feats.shape
    if d % 4:
        raise NotImplementedError(f"the top-k CUDA kernel reads rows as float4: D % 4 == 0, got D={d}")
    feats = feats.float().contiguous()
    q = query.reshape(-1).float().contiguous()
    if feats.data_ptr() % 16:
        raise ValueError("top_k_cosine_kernel takes a 16-byte aligned store")
    from hippomm_tpu_torch.ops import _native

    lib = _native.kernels()
    nb = -(-n // lib.hmm_topk_tile_rows())
    dev = feats.device
    cand_v = torch.empty((nb * k,), dtype=torch.float32, device=dev)
    cand_i = torch.empty((nb * k,), dtype=torch.int32, device=dev)
    vals = torch.empty((k,), dtype=torch.float32, device=dev)
    idx = torch.empty((k,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hmm_topk_cosine_f32(
            q.data_ptr(), feats.data_ptr(), n, d, k, cand_v.data_ptr(), cand_i.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"hmm_topk_cosine_f32 kernel launch failed: CUDA error {rc}")
    top_k_cosine_kernel.launches += 1
    return vals, idx


top_k_cosine_kernel.launches = 0
