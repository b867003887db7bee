"""Detailed-recall feature search over ThetaEvent stores.

Counterpart of hippomm_tpu/retrieval/search.py (reference behavior:
hippocampal_memory.py:3127-3279, 3281-3383 — per-event top-5 cosine of a
1024-d query against that event's vision or audio features, a global cut to
the best 5, ±window time expansion).

Event features are packed once into one (ΣN, 1024) matrix with an
owner/time sidecar; the device copy is normalized once at upload. A query is
one top-k over the packed store, then the per-event caps run on the small
candidate list on the host. Routes:
  * single query, k ≤ 128: K5 (ops/topk.top_k_cosine_kernel) — the CUDA
    kernel on the card, its plain version for a store on the CPU;
  * single query, k > 128 (the widened rounds of `search`), and the batched
    `search_batch`: ops/similarity.top_k_cosine_prenorm (matmul + topk);
  * host: numpy mat-vec over the raw features divided by their row norms.
A query runs on the device that holds the store (the CUDA card unless the
caller built the index with device="cpu"); HIPPOMM_TOPK_ROUTE=host asks for
the host route instead. A device fault raises: there is no fallback to the
host route.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hippomm_tpu_torch.memory.schema import ThetaEvent
from hippomm_tpu_torch.ops.similarity import l2_normalize, top_k_cosine_prenorm
from hippomm_tpu_torch.ops.topk import MAX_K, top_k_cosine_kernel
from hippomm_tpu_torch.utils.device import fetch, resolve_device


def topk_packed(q: torch.Tensor, feats: torch.Tensor, k: int) -> torch.Tensor:
    """One query's top-k over unit rows `feats`, on their device: a (2, k)
    int32 tensor, the values' bits then the rows. K5 for k ≤ MAX_K, else
    top_k_cosine_prenorm (the widened rounds of `search`)."""
    if k <= MAX_K:
        return top_k_cosine_kernel(q, feats, k, True)
    vals, idx = top_k_cosine_prenorm(q, feats, k)
    return torch.stack((vals.view(torch.int32), idx.to(torch.int32)))


def read_packed(both: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """One device→host copy (and one wait) of a packed top-k: the values
    (from their bits) and int64 rows."""
    both = both.cpu().numpy()
    return both[0].view(np.float32), both[1].astype(np.int64)


@dataclasses.dataclass
class SearchHit:
    event_id: str
    video_id: str
    time: float
    similarity: float
    index_in_event: int
    window: Tuple[float, float] = (0.0, 0.0)


class FeatureSearchIndex:
    """Packed feature store for one modality across many events; its device
    copy lives on `device` (CUDA unless the caller says otherwise)."""

    def __init__(self, modality: str, device=None):
        self.modality = modality
        self.device = resolve_device(device)
        self._feats: Optional[np.ndarray] = None
        self._device: Optional[torch.Tensor] = None
        self.owners: List[str] = []  # event_id per row
        self.videos: List[str] = []
        self.times: np.ndarray = np.zeros((0,), np.float64)
        self.in_event_idx: np.ndarray = np.zeros((0,), np.int64)
        self._row_norms: Optional[np.ndarray] = None

    @classmethod
    def build(cls, events: Sequence[ThetaEvent], modality: str, device=None) -> "FeatureSearchIndex":
        self = cls(modality, device)
        rows, owners, videos, times, iei = [], [], [], [], []
        for ev in events:
            f = ev.features.get(modality)
            if f is None or len(f) == 0:
                continue
            t = list(ev.feature_times.get(modality, []))
            for i in range(f.shape[0]):
                rows.append(f[i])
                owners.append(ev.event_id)
                videos.append(ev.video_id)
                times.append(t[i] if i < len(t) else ev.start_time)
                iei.append(i)
        if rows:
            self._feats = np.stack(rows).astype(np.float32)
            self.owners = owners
            self.videos = videos
            self.times = np.asarray(times)
            self.in_event_idx = np.asarray(iei)
        return self

    def __len__(self) -> int:
        return 0 if self._feats is None else self._feats.shape[0]

    def _device_feats(self) -> Optional[torch.Tensor]:
        """Packed store on the device, rows normalized once at upload (a
        per-query normalization would read and write a second (N, D) copy)."""
        if self._device is None and self._feats is not None:
            self._device = l2_normalize(torch.from_numpy(self._feats).to(self.device))
        return self._device

    def _route(self) -> str:
        """"device" (the store's own device), or "host" where the caller
        asks for the numpy route with HIPPOMM_TOPK_ROUTE=host."""
        return "host" if os.environ.get("HIPPOMM_TOPK_ROUTE") == "host" else "device"

    def _norms(self) -> np.ndarray:
        if self._row_norms is None:
            self._row_norms = np.maximum(np.linalg.norm(self._feats, axis=1), 1e-8).astype(np.float32)
        return self._row_norms

    def _topk_host(self, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact cosine top-k on host numpy: raw-feature mat-vec divided by
        precomputed row norms (no normalized second copy of the store)."""
        q = fetch(q, np.float32).reshape(-1)
        qn = q / max(float(np.linalg.norm(q)), 1e-8)
        s = (self._feats @ qn) / self._norms()
        k = min(k, s.shape[0])
        part = np.argpartition(-s, k - 1)[:k]
        order = part[np.argsort(-s[part], kind="stable")]
        return s[order], order.astype(np.int64)

    def _topk_batch_host(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        qn = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-8)
        s = (qn @ self._feats.T) / self._norms()[None, :]
        k = min(k, s.shape[1])
        part = np.argpartition(-s, k - 1, axis=1)[:, :k]
        order = np.argsort(-np.take_along_axis(s, part, 1), axis=1, kind="stable")
        idx = np.take_along_axis(part, order, 1)
        return np.take_along_axis(s, idx, 1), idx.astype(np.int64)

    def _topk(self, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """One top-k over the packed store; host (k,) values + global row
        indices."""
        return self._topk_host(q, k) if self._route() == "host" else self._topk_device(q, k)

    def _topk_device(self, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device).reshape(-1)
        return read_packed(topk_packed(q, self._device_feats(), k))

    def _topk_batch(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) queries → ((Q, k) values, (Q, k) global indices), routed
        like _topk (one mat-mat either way)."""
        if self._route() == "host":
            return self._topk_batch_host(queries, k)
        return self._topk_batch_device(queries, k)

    def _topk_batch_device(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        vals, idx = top_k_cosine_prenorm(q, self._device_feats(), k)
        return fetch(vals, np.float32), idx.cpu().numpy().astype(np.int64)

    def search(
        self,
        query,
        top_k_per_event: int = 5,
        global_top_k: int = 5,
        window_s: float = 1.0,
    ) -> List[SearchHit]:
        """One top-k over the packed store, then the reference's per-event
        cap and global cut. The over-fetch widens geometrically until
        global_top_k survivors exist (or the whole store is ranked), so
        stores whose best rows share one event still return the reference's
        per-event-top-5-then-global-5 result. `query` is a numpy vector or a
        tensor (the text embedding, left on the device)."""
        n = len(self)
        if n == 0:
            return []
        if isinstance(query, torch.Tensor):
            q = query.reshape(-1)
        else:
            q = np.asarray(query, np.float32).reshape(-1)
        k = min(n, max(global_top_k * 4, top_k_per_event * 8))
        while True:
            vals, idx = self._topk(q, k)
            hits = self._cap_and_cut(vals, idx, top_k_per_event, global_top_k, window_s)
            if len(hits) >= global_top_k or k >= n:
                return hits
            k = min(n, k * 4)

    def search_batch(
        self,
        queries: np.ndarray,
        top_k_per_event: int = 5,
        global_top_k: int = 5,
        window_s: float = 1.0,
    ) -> List[List[SearchHit]]:
        """Q queries in one (Q, D) @ (D, N) matmul + top-k. Per-query results
        match search()."""
        n = len(self)
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if n == 0:
            return [[] for _ in range(len(queries))]
        k = min(n, max(global_top_k * 4, top_k_per_event * 8))
        vals, idx = self._topk_batch(queries, k)
        out: List[List[SearchHit]] = []
        for qi in range(len(queries)):
            hits = self._cap_and_cut(vals[qi], idx[qi], top_k_per_event, global_top_k, window_s)
            if len(hits) < global_top_k and k < n:
                # rare deficient query: widen individually
                hits = self.search(queries[qi], top_k_per_event, global_top_k, window_s)
            out.append(hits)
        return out

    def _cap_and_cut(
        self, vals, idx, top_k_per_event: int, global_top_k: int, window_s: float
    ) -> List[SearchHit]:
        per_event: Dict[str, int] = {}
        hits: List[SearchHit] = []
        for v, i in zip(vals, idx):
            if not np.isfinite(v) or i < 0 or i >= len(self.owners):
                continue
            eid = self.owners[i]
            if per_event.get(eid, 0) >= top_k_per_event:
                continue
            per_event[eid] = per_event.get(eid, 0) + 1
            t = float(self.times[i])
            hits.append(
                SearchHit(
                    event_id=eid,
                    video_id=self.videos[i],
                    time=t,
                    similarity=float(v),
                    index_in_event=int(self.in_event_idx[i]),
                    window=(max(0.0, t - window_s), t + window_s),
                )
            )
            if len(hits) >= global_top_k:
                break
        return hits


def merge_windows(
    windows: Sequence[Tuple[float, float]], gap: float = 2.0
) -> List[Tuple[float, float]]:
    """Merge overlapping or nearby time windows (reference:
    hippocampal_memory.py:2470-2482)."""
    if not windows:
        return []
    ws = sorted(windows)
    out = [list(ws[0])]
    for s, e in ws[1:]:
        if s <= out[-1][1] + gap:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]
