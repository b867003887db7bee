"""K5: exact cosine top-k of one query over a feature store — Hopper kernel +
plain version.

Counterpart of hippomm_tpu/ops/pallas_topk.py (the Pallas `_topk_kernel`,
entered through `pallas_top_k_cosine`): query (D,), feats (N, D) → the k
best (values (k,) fp32, row indices (k,) int32) by cosine similarity, rows
normalised by rsqrt(max(Σf², 1e-16)) and the query by max(‖q‖, 1e-8), k ≤
128. Only the k values and k indices leave the card.

The kernel is CUDA C++ in csrc/topk_cosine.cu, one launch: a persistent,
balanced grid (`_topk_plan`) of blocks that each stream one contiguous row
range through a shared-memory ring filled by bulk copies, keep their running
top-k behind a threshold filter, and hand their k candidates to the block
that finishes last, which merges them. `top_k_cosine_ref` is the same
function in plain PyTorch. The kernel takes any D and a store view at any
element offset: where D % 4 == 0 and the store is 16-byte aligned it reads
rows as float4, else one element a lane, with each chunk's unaligned head
and tail read apart from its bulk copy (no copy of the store). Both order
the result by value, then by lower row index at equal values — lax.top_k's order, which the JAX product route
(ops/similarity.top_k_cosine) uses; the TPU kernel's own merge let a later
tile win a tie. k > N raises (the TPU kernel padded with −3e38 / index 0).

The single-query device route of retrieval/search.FeatureSearchIndex runs
through `top_k_cosine_kernel`: the kernel for a CUDA tensor, the plain
version for a CPU tensor; a CUDA call the kernel cannot take raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from hippomm_tpu_torch.ops import _native

MAX_K = 128  # the TPU kernel's contract (one 128-lane row of running top-k)

# The kernel's fixed sizes (csrc/topk_cosine.cu): a block's list and
# candidate buffer, its ring's bounds, and the card's shared memory.
_LIST = 1024  # entries: the running top-k, then the candidate buffer
_CHUNK_BYTES = 32 * 1024  # a ring slot: whole rows, about this many bytes
_RING_BYTES = 96 * 1024  # a block's ring, about this many bytes
_MAX_STAGES = 8
_MAX_BLOCKS_PER_SM = 2
_SMEM_BLOCK = 232_448  # the most a block may use (H100)
_SMEM_SM = 233_472  # an SM's, shared by its blocks, each of which reserves 1 KB
_SMEM_STATIC = 256  # the kernel's static shared memory (128 bytes), rounded up
_MERGE_MIN = 4096  # entries the merge needs in the ring's shared memory


class TopkPlan(NamedTuple):
    """One kernel call: `blocks` blocks, block b over rows
    [b·n // blocks, (b+1)·n // blocks) (`_block_rows`), streamed in chunks
    of `chunk_rows` rows through a ring of `stages` slots of `slot_floats`
    (a chunk, and 3 floats before and after it where chunks are not
    16-byte aligned: `vec` False); `smem_bytes` of
    dynamic shared memory a block, `blocks_per_sm` of them resident on an
    SM; `scratch_entries` (= blocks · k) candidates handed to the merge."""

    blocks: int
    rows_per_block: int
    chunk_rows: int
    stages: int
    smem_bytes: int
    blocks_per_sm: int
    scratch_entries: int
    vec: bool
    slot_floats: int


def _slot_floats(d: int, chunk_rows: int, vec: bool) -> int:
    return chunk_rows * d if vec else -(-(chunk_rows * d + 3) // 4) * 4


def _smem_bytes(d: int, chunk_rows: int, stages: int, blocks: int, vec: bool = True) -> int:
    """The kernel's shared-memory layout (`Layout` in the source): ring
    (128-byte aligned, at least the merge's entries), q (16-byte aligned),
    list and buffer, a count per block, barriers."""
    ring = max(-(-stages * _slot_floats(d, chunk_rows, vec) * 4 // 128) * 128, 8 * _MERGE_MIN)
    return ring + -(-4 * d // 16) * 16 + 8 * _LIST + -(-4 * (blocks + 1) // 16) * 16 + 16 * stages


def _pow2_at_least(x: int) -> int:
    p = 2
    while p < x:
        p *= 2
    return p


@functools.lru_cache(maxsize=256)
def _topk_plan(n: int, d: int, k: int, sm_count: int, offset: int = 0) -> TopkPlan:
    """The kernel's plan for a store (n, d) whose first element sits
    `offset` elements past a 16-byte boundary, and k, on a card of
    `sm_count` SMs: about 32 KB of whole rows a chunk, a ring of about 96 KB
    (2-8 chunks), as many blocks as fit on an SM up to 2, and min(chunks,
    SMs × blocks per SM) blocks with ranges that differ by at most one row.
    The float4 instance (`vec`) where D % 4 == 0 and offset % 4 == 0."""
    if n < 1 or d < 1 or not 1 <= k <= min(MAX_K, n) or sm_count < 1:
        raise ValueError(f"no top-k plan for n={n} d={d} k={k} sm_count={sm_count}")
    vec = d % 4 == 0 and offset % 4 == 0
    chunk_rows = max(1, min(_LIST - MAX_K, _CHUNK_BYTES // (4 * d)))
    stages = max(2, min(_MAX_STAGES, _RING_BYTES // (4 * d * chunk_rows)))
    most = _smem_bytes(d, chunk_rows, stages, _MAX_BLOCKS_PER_SM * sm_count, vec)
    per_sm = min(_MAX_BLOCKS_PER_SM, _SMEM_SM // (most + _SMEM_STATIC + 1024))
    if most + _SMEM_STATIC > _SMEM_BLOCK or per_sm < 1:
        raise ValueError(f"top-k kernel: rows of D={d} do not fit its shared memory")
    blocks = min(-(-n // chunk_rows), sm_count * per_sm)
    # the merge: the lists' heads (at least k of them) and a group behind k
    # rows in the ring's shared memory
    if _pow2_at_least(blocks * -(-k // blocks)) > _MERGE_MIN:
        raise ValueError(f"no top-k plan for n={n} d={d} k={k} sm_count={sm_count}")
    return TopkPlan(blocks, n // blocks, chunk_rows, stages,
                    _smem_bytes(d, chunk_rows, stages, blocks, vec), per_sm, blocks * k, vec,
                    _slot_floats(d, chunk_rows, vec))


def _block_rows(n: int, blocks: int, b: int) -> Tuple[int, int]:
    """Block b's rows [start, stop), as the kernel computes them."""
    return b * n // blocks, (b + 1) * n // blocks


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


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# (device index, stream) -> int32 scratch: [ticket, -, -, -], then the
# blocks' candidates. The ticket starts at 0 and every call leaves it at 0,
# so the buffer is kept and never cleared; one per stream, so that calls on
# two streams never share a ticket.
_scratch = {}


def _scratch_for(dev: torch.device, stream: int, entries: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < 4 + 2 * entries:
        most = 4 + 2 * _MAX_BLOCKS_PER_SM * _sm_count(dev.index) * MAX_K
        buf = _scratch[key] = torch.zeros((max(most, 4 + 2 * entries),), dtype=torch.int32, device=dev)
    return buf


def top_k_cosine_kernel(query: torch.Tensor, feats: torch.Tensor, k: int, packed: bool = False):
    """(values (k,) fp32, indices (k,) int32): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. With `packed`, one (2, k)
    int32 tensor instead — the values' bits, then the indices — which a
    caller reads back to the host in one copy. Counts kernel launches in
    `top_k_cosine_kernel.launches`."""
    _check(query, feats, k)
    if feats.device.type == "cpu":
        vals, idx = top_k_cosine_ref(query, feats, k)
        return torch.stack((vals.view(torch.int32), idx)) if packed else (vals, idx)
    if feats.device.type != "cuda":
        raise ValueError(f"top_k_cosine_kernel: unsupported device {feats.device}")
    n, d = feats.shape
    feats = feats.float().contiguous()
    q = query.reshape(-1).float().contiguous()
    if feats.data_ptr() % 4:
        raise ValueError("top_k_cosine_kernel takes a 4-byte aligned store")
    dev = feats.device
    plan = _topk_plan(n, d, k, _sm_count(dev.index), feats.data_ptr() % 16 // 4)
    out = torch.empty((2, k), dtype=torch.int32, device=dev)
    scratch = _scratch_for(dev, _native.current_stream(dev), plan.scratch_entries)
    _native.launch("hmm_topk_cosine_f32", dev, q.data_ptr(), feats.data_ptr(), n, d, k, plan.blocks,
                   plan.chunk_rows, plan.stages, plan.smem_bytes, scratch.data_ptr(), out.data_ptr())
    _native.count_launch(top_k_cosine_kernel)
    return out if packed else (out[0].view(torch.float32), out[1])


top_k_cosine_kernel.launches = 0
