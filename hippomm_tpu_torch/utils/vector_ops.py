"""Vector/feature helpers (reference: hippomm/utils/vector_ops.py:1-188).

Counterpart of hippomm_tpu/utils/vector_ops.py. The two hot functions,
`cosine_similarity` and `top_k_cosine_similarity`, are fp32 torch ops on the
device, as the JAX package's run on its default accelerator: a tensor input
stays on its own device, numpy input goes to `device` (CUDA unless the caller
says otherwise). The rest are small host numpy helpers, as in the JAX
package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hippomm_tpu_torch.utils.device import as_tensors

_EPS = 1e-8


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=_EPS)


def cosine_similarity(a, b, device=None) -> float:
    """Cosine similarity between two vectors (reference: vector_ops.py:6-20)."""
    a, b = (x.float() for x in as_tensors(a, b, device=device))
    return float(torch.sum(_unit(a) * _unit(b), dim=-1))


def top_k_cosine_similarity(query, features, k: int = 5, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k cosine similarity of `query` (D,) against `features` (N, D), on
    the features' device when they are a tensor. Returns (indices,
    similarities) sorted descending, ties to the lower index (lax.top_k's
    order) — the reference's contract (vector_ops.py:151-188)."""
    features, query = (x.float() for x in as_tensors(features, query, device=device))
    if features.dim() == 1:
        features = features[None, :]
    query = query.reshape(-1)
    k = min(int(k), features.shape[0])
    if k <= 0:  # an empty store or k = 0: empty arrays, as the reference
        return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
    sims = _unit(features) @ _unit(query)
    vals, idx = torch.sort(sims, descending=True, stable=True)
    return idx[:k].cpu().numpy(), vals[:k].cpu().numpy()


def compute_entropy(features) -> float:
    """Entropy of a feature vector: |features| normalized to a probability
    distribution, then Shannon entropy (reference: vector_ops.py:22-35)."""
    p = np.abs(np.asarray(features, dtype=np.float64).reshape(-1))
    s = p.sum()
    if s <= 0:
        return 0.0
    p = p / s
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def temporal_overlap(t1: Tuple[float, float], t2: Tuple[float, float], threshold: float = 0.5) -> bool:
    """True when two (start, end) intervals overlap by at least `threshold` of
    the shorter interval (reference: vector_ops.py:37-54)."""
    start1, end1 = t1
    start2, end2 = t2
    overlap = min(end1, end2) - max(start1, start2)
    if overlap <= 0:
        return False
    shorter = min(end1 - start1, end2 - start2)
    return bool(overlap / max(shorter, _EPS) >= threshold)


def spatial_distance(coord1: Tuple[int, int], coord2: Tuple[int, int],
                     grid_size: Tuple[int, int] = (16, 16)) -> float:
    """Euclidean distance between grid coordinates, normalized by the grid
    diagonal (reference: vector_ops.py:56-70)."""
    x1, y1 = coord1
    x2, y2 = coord2
    dist = float(np.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2))
    max_dist = float(np.sqrt(grid_size[0] ** 2 + grid_size[1] ** 2))
    return dist / max(max_dist, _EPS)


def feature_flow(features1, features2, threshold: float = 0.7, device=None) -> bool:
    """True when two feature vectors are cosine-similar enough to be a smooth
    flow (reference: vector_ops.py:72-79)."""
    return bool(cosine_similarity(features1, features2, device) >= threshold)


def merge_features(features_list, weights=None) -> np.ndarray:
    """Weighted sum of feature vectors, L2-normalized (reference:
    vector_ops.py:81-100: the weights are not normalized, the sum is)."""
    if weights is None:
        weights = [1.0] * len(features_list)
    feats = np.stack([np.asarray(f, dtype=np.float32).reshape(-1) for f in features_list])
    w = np.asarray(weights, dtype=np.float32)
    merged = (feats * w[:, None]).sum(axis=0)
    return merged / max(np.linalg.norm(merged), _EPS)


def gaussian_temporal_weighting(times, center, sigma: float = 1.0) -> np.ndarray:
    """Gaussian pdf of timestamps around a center (reference:
    vector_ops.py:102-108, scipy.stats.norm.pdf: the 1/(σ√2π) factor is part
    of the contract)."""
    t = np.asarray(times, dtype=np.float64)
    sigma = max(float(sigma), _EPS)
    return np.exp(-0.5 * ((t - center) / sigma) ** 2) / (sigma * np.sqrt(2 * np.pi))


def compute_feature_statistics(features) -> Tuple[float, float, float]:
    """(mean, std, entropy) of a flattened feature vector (reference:
    vector_ops.py:110-122)."""
    f = np.asarray(features, dtype=np.float32).reshape(-1)
    return float(f.mean()), float(f.std()), float(compute_entropy(f))


def normalize_features(features, method: str = "l2") -> np.ndarray:
    """Normalize a flattened feature vector by l2 / l1 / max norm (reference:
    vector_ops.py:124-149)."""
    f = np.asarray(features, dtype=np.float32).reshape(-1)
    if method == "l2":
        denom = np.linalg.norm(f)
    elif method == "l1":
        denom = np.sum(np.abs(f))
    elif method == "max":
        denom = np.max(np.abs(f))
    else:
        raise ValueError(f"Unknown normalization method: {method}")
    return f / max(float(denom), _EPS)
