"""Cosine similarity, top-k search and greedy key-frame dedup.

Counterpart of hippomm_tpu/ops/similarity.py:
  * `top_k_cosine` — both sides normalized per call (the JAX package's
    public search op), in plain torch ops;
  * `top_k_cosine_prenorm` — normalize + matmul + top-k in plain torch ops
    (XLA ran it with no hand kernel): the batched search route of
    retrieval/search.FeatureSearchIndex and its route for k > 128. Its tie
    order is torch.topk's, which does not promise lax.top_k's lower index
    first; the single-query route's K5 (ops/topk) does.
  * `select_keyframes_mask` / `select_keyframes` — up to 256 rows the dedup
    runs on host numpy (a device round trip costs more than the N²·D sim
    matrix); above that, on the device, over a shape-bucketed padded stack.
"""

from __future__ import annotations

import numpy as np
import torch

from hippomm_tpu_torch.ops.bucketing import bucket_size
from hippomm_tpu_torch.utils.device import resolve_device

_EPS = 1e-8
_HOST_DEDUP_MAX_N = 256


def l2_normalize(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """x / max(‖x‖, 1e-8) along `axis`."""
    n = torch.sqrt(torch.sum(x.square(), dim=axis, keepdim=True))
    return x / torch.clamp(n, min=_EPS)


def cosine_sim_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) cosine similarity in fp32."""
    a = l2_normalize(a.float())
    b = l2_normalize(b.float())
    return a @ b.t()


def top_k_cosine(query: torch.Tensor, feats: torch.Tensor, k: int):
    """Normalize both sides + matmul + top-k, as
    hippomm_tpu.ops.similarity.top_k_cosine: query (D,) or (Q, D), feats
    (N, D) → (values, indices), each (..., k), sorted descending, in fp32 on
    the tensors' device. Ties follow torch.topk (see top_k_cosine_prenorm)."""
    q = l2_normalize(torch.atleast_2d(query.float()))
    sims = q @ l2_normalize(feats.float()).t()
    vals, idx = torch.topk(sims, k, dim=-1)
    if query.dim() == 1:
        return vals[0], idx[0]
    return vals, idx


def top_k_cosine_prenorm(query: torch.Tensor, feats_unit: torch.Tensor, k: int):
    """normalize the query + matmul + top-k over a store whose rows are
    already unit-norm (normalized once at upload,
    FeatureSearchIndex._device_feats). query (D,) or (Q, D); feats_unit
    (N, D). Returns (values, indices), each (..., k), sorted descending."""
    q = l2_normalize(torch.atleast_2d(query.float()))
    vals, idx = torch.topk(q @ feats_unit.t(), k, dim=-1)
    return (vals[0], idx[0]) if query.dim() == 1 else (vals, idx)


def select_keyframes_mask(features: torch.Tensor, threshold: float = 0.9, n=None) -> torch.Tensor:
    """Greedy key-frame selection: take frame 0; take frame i iff its cosine
    similarity to every already-selected frame is < threshold. Rows at and
    past `n` (bucket padding) are never selected. Returns a bool (N,) mask.

    The scan over rows stays on the device: one (N,) mask carried through N
    masked row-max steps, with no host read until the caller's."""
    sims = cosine_sim_matrix(features, features)
    rows = sims.shape[0]
    valid = torch.arange(rows, device=sims.device) < (rows if n is None else n)
    mask = torch.zeros((rows,), dtype=torch.bool, device=sims.device)
    mask[0] = valid[0]
    neg = torch.tensor(float("-inf"), device=sims.device)
    for i in range(1, rows):
        take = (torch.where(mask, sims[i], neg).max() < threshold) & valid[i]
        mask[i] = take
    return mask


def keyframe_bucket(n: int) -> int:
    """Shape rungs for the device dedup: 32-quantum up to 128, then powers of two."""
    if n <= 128:
        return bucket_size(n)
    b = 256
    while b < n:
        b *= 2
    return b


def _select_keyframes_host(features: np.ndarray, threshold: float) -> np.ndarray:
    """Host greedy dedup, semantics identical to select_keyframes_mask."""
    norms = np.maximum(np.linalg.norm(features, axis=1, keepdims=True), _EPS)
    unit = features / norms
    sims = unit @ unit.T
    selected = [0]
    for i in range(1, features.shape[0]):
        if np.max(sims[i, selected]) < threshold:
            selected.append(i)
    return np.asarray(selected, dtype=np.int64)


def select_keyframes(features: np.ndarray, threshold: float = 0.9, device=None) -> np.ndarray:
    """Host wrapper: returns selected indices (ascending), like the reference.
    Above the host threshold the scan runs on `device` (None:
    resolve_device, CUDA)."""
    device = resolve_device(device)
    features = np.asarray(features, dtype=np.float32)
    n = features.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int64)
    if n == 1:
        return np.zeros((1,), dtype=np.int64)
    if n <= _HOST_DEDUP_MAX_N:
        return _select_keyframes_host(features, float(threshold))
    b = keyframe_bucket(n)
    if b != n:
        features = np.concatenate([features, np.zeros((b - n,) + features.shape[1:], features.dtype)])
    mask = select_keyframes_mask(
        torch.from_numpy(features).to(device), threshold=float(threshold), n=n
    )
    return np.nonzero(mask.cpu().numpy()[:n])[0]
