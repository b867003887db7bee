"""Sharded ThetaEvent feature store: exact top-k over a row-sharded store.

Counterpart of hippomm_tpu/parallel/sharded_store.py. The (N, 1024) feature
matrix is unit-normalized once on the host and split row-wise over the
mesh's "data" shards, each shard's rows on its device. A query runs

    each shard: local top-k on its device  →  the shards' candidates to the
    first device  →  re-rank the pool  →  one read

which is the exact global top-k: every true top-k row is in its shard's
local top-k. The local top-k of one query is the single-device index's
(retrieval/search.topk_packed: K5 for k ≤ MAX_K, else
ops/similarity.top_k_cosine_prenorm); the batched search's is
top_k_cosine_prenorm.

Layout: JAX pads the store to a multiple of the shard count and masks the
pads with -inf. K5 has no mask, and a zero pad row would score 0 and push a
real row with a negative score out of a shard's local top-k. So the rows are
split without pads in JAX's layout — shard s holds global rows
[s·per, min((s+1)·per, N)) with per = ceil(N / shards) — so the global row
numbers equal JAX's; the last shards are short or empty, and an empty shard
is skipped. A shard's k is min(k, its rows).

The re-rank is a stable descending sort of the pool in shard order, so equal
values go to the lower global row, as lax.top_k's merge does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hippomm_tpu_torch.memory.schema import ThetaEvent
from hippomm_tpu_torch.ops.similarity import top_k_cosine_prenorm
from hippomm_tpu_torch.parallel import mesh as pmesh
from hippomm_tpu_torch.retrieval.search import FeatureSearchIndex, read_packed, topk_packed
from hippomm_tpu_torch.utils.device import resolve_device


def _normalize_rows(feats: np.ndarray) -> np.ndarray:
    """Unit-normalize rows once on the host (fp32); zero rows stay zero."""
    return feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-8)


class _RowShards:
    """Unit rows split over a mesh's "data" shards: [(first global row,
    (rows, D) fp32 tensor on the shard's device)], empty shards left out;
    results gather on `home`, the first data shard's device."""

    def __init__(self, feats_unit: np.ndarray, mesh: pmesh.Mesh):
        devs = pmesh.data_devices(mesh)
        n = feats_unit.shape[0]
        per = -(-n // len(devs))
        self.home = resolve_device(devs[0])
        self.parts = [(lo, torch.from_numpy(np.ascontiguousarray(feats_unit[lo:lo + per])).to(dev))
                      for lo, dev in zip(range(0, n, per), devs)]

    def topk(self, q, k: int) -> torch.Tensor:
        """One query's exact top-k: a (2, k) int32 tensor on `home`, the
        values' bits then the global rows."""
        vals, rows = [], []
        for lo, f in self.parts:
            both = topk_packed(q.to(f.device), f, min(k, f.shape[0]))
            vals.append(both[0].view(torch.float32))
            rows.append(both[1] + lo)
        v, i = self._merge(vals, rows, k, dim=0)
        return torch.stack((v.view(torch.int32), i))

    def topk_batch(self, queries: torch.Tensor, k: int) -> torch.Tensor:
        """(Q, D) queries' exact top-k: a (2, Q, k) int32 tensor on `home`."""
        vals, rows = [], []
        for lo, f in self.parts:
            v, i = top_k_cosine_prenorm(queries.to(f.device), f, min(k, f.shape[0]))
            vals.append(v)
            rows.append(i.to(torch.int32) + lo)
        v, i = self._merge(vals, rows, k, dim=1)
        return torch.stack((v.view(torch.int32), i))

    def _merge(self, vals, rows, k: int, dim: int):
        """The pool in shard order, re-ranked by a stable descending sort:
        equal values keep the lower global row first."""
        v = pmesh.gather(vals, self.home, dim)
        i = pmesh.gather(rows, self.home, dim)
        v, order = torch.sort(v, dim=dim, descending=True, stable=True)
        order = order.narrow(dim, 0, k)
        return v.narrow(dim, 0, k).contiguous(), torch.take_along_dim(i, order, dim=dim)


class ShardedFeatureIndex(FeatureSearchIndex):
    """FeatureSearchIndex whose device top-k runs row-sharded over a mesh:
    the search backend of a multi-device engine (retrieval/qa.py).

    Same packing, sidecars, per-event cap, geometric widening and SearchHit
    results as the one-device index; only the device top-k is replaced. The
    host route (HIPPOMM_TOPK_ROUTE=host) is the one-device index's."""

    def __init__(self, modality: str, mesh: pmesh.Mesh):
        super().__init__(modality, pmesh.data_devices(mesh)[0])
        self.mesh = mesh
        self._shards = None

    @classmethod
    def build(  # type: ignore[override]
        cls, events: Sequence[ThetaEvent], modality: str, mesh: pmesh.Mesh
    ) -> "ShardedFeatureIndex":
        packed = FeatureSearchIndex.build(events, modality, pmesh.data_devices(mesh)[0])
        self = cls(modality, mesh)
        if packed._feats is None:
            return self
        self.owners = packed.owners
        self.videos = packed.videos
        self.times = packed.times
        self.in_event_idx = packed.in_event_idx
        self._feats = packed._feats  # host copy: len(), the host route
        self._shards = _RowShards(_normalize_rows(packed._feats), mesh)
        return self

    def _topk_device(self, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = torch.as_tensor(q, dtype=torch.float32).reshape(-1)
        return read_packed(self._shards.topk(q, k))

    def _topk_batch_device(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        return read_packed(self._shards.topk_batch(torch.as_tensor(queries, dtype=torch.float32), k))


class ShardedFeatureStore:
    """Row-sharded (N, 1024) store with host sidecars, built from ThetaEvents."""

    def __init__(self, mesh: pmesh.Mesh, modality: str = "vision"):
        self.mesh = mesh
        self.modality = modality
        self.n_rows = 0
        self._shards = None
        self.owners: List[str] = []
        self.videos: List[str] = []
        self.times: np.ndarray = np.zeros((0,))

    @classmethod
    def build(
        cls, events: Sequence[ThetaEvent], mesh: pmesh.Mesh, modality: str = "vision"
    ) -> "ShardedFeatureStore":
        self = cls(mesh, modality)
        packed = FeatureSearchIndex.build(events, modality, pmesh.data_devices(mesh)[0])
        if packed._feats is None:
            return self
        self.n_rows = len(packed)
        self.owners, self.videos, self.times = packed.owners, packed.videos, packed.times
        self._shards = _RowShards(_normalize_rows(packed._feats), mesh)
        return self

    def __len__(self) -> int:
        return self.n_rows

    def search(self, query, k: int = 5) -> List[Tuple[str, str, float, float]]:
        """query (D,) -> [(event_id, video_id, time, similarity)], the exact
        top-k."""
        if self.n_rows == 0:
            return []
        q = torch.as_tensor(np.asarray(query, np.float32)).reshape(-1)
        vals, idx = read_packed(self._shards.topk(q, min(k, self.n_rows)))
        return [(self.owners[i], self.videos[i], float(self.times[i]), float(v))
                for v, i in zip(vals, idx) if np.isfinite(v)]
