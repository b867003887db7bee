"""The routed experts' dispatch and combine around `torch._grouped_mm`:
hand-written CUDA kernels (csrc/moe_glue.cu) and their plain twins.

A port-only kernel set (the JAX package has no Kimi-VL), for the MoE layers
of models/kimi_vl. A layer's chain on the card is the fp32 router product,
`moe_route`, `moe_permute`, the two grouped products with `swiglu` between
them, the shared expert (a product, `swiglu`, a product) and `moe_combine`:

  * `moe_route`: σ of the fp32 router logits, the top k of σ + the
    correction bias, the chosen σ normalised to sum 1 and scaled.
  * `moe_permute`: each route's slot in the order of a stable sort of the
    chosen experts (within an expert the rows keep their order), the rows
    gathered into that order, each expert's end (`torch._grouped_mm`'s
    `offs`), and the device counters (experts hit, routes, the busiest
    expert's routes) over the rows `live` marks, added to `stats`.
  * `swiglu`: bf16(silu(fp32 g) · fp32 u) over the (M, 2F) product.
  * `moe_combine`: bf16(x + (Σ_k w_k · y[slot_k] + shared)) in fp32: the
    routed experts' weighted sum, the shared expert and the residual.

Each wrapper launches its kernel for CUDA tensors and runs its `_ref` twin
for CPU tensors; a CUDA call the kernel does not take raises. The twins are
the composition the kernels replace, op for op, so the CPU path computes
what it computed before them. On the card (tests/test_torch_cuda.py) the
route's experts, the slots, `offs`, the counters and the SwiGLU are
bit-equal to the twins. The route's weights and the combine sum k in order,
where torch's reductions take their own order: the weights agree within
3.3e-7 relative, and the combine is bit-equal to fp32 products and sums
taken in order, within one bf16 ulp of the twin. A row of equal scores gets
the lowest experts from both, the kernel's in ascending order, torch.topk's
in its own. Each wrapper counts its launches in `.launches`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from hippomm_tpu_torch.ops import _native

_MAX_EXPERTS = 64  # a row's chosen experts are one 64-bit mask in the permute
_MAX_K = 8
_TILE = 1024  # rows one permute block ranks
_SMS = 132  # the H100's SMs


def _on_cuda(name: str, *ts: torch.Tensor) -> bool:
    """True when the kernel runs (CUDA tensors), False for the twin (CPU);
    raises for mixed devices, other devices and non-contiguous operands."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: all operands must be on one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous operands")
    return True


def _check_dtypes(name: str, want: torch.dtype, *ts: torch.Tensor) -> None:
    if any(t.dtype != want for t in ts):
        raise NotImplementedError(f"the {name} kernel takes {want}, got {[t.dtype for t in ts]}")


def _check_rows(name: str, width: int, *ts: torch.Tensor) -> None:
    """The SwiGLU and the combine move 8 bf16 a load: rows of a multiple of
    8 elements, each operand 16-byte aligned."""
    if width % 8 or any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"the {name} kernel takes rows of a multiple of 8 elements, 16-byte aligned; got "
                         f"width {width}")


# ------------------------------------------------------------------ route


def moe_route_ref(logits: torch.Tensor, bias: torch.Tensor, k: int, scale: float):
    """(idx (N, k) int64, wts (N, k) fp32) from fp32 router logits (N, E)."""
    scores = torch.sigmoid(logits)
    idx = torch.topk(scores + bias, k, dim=-1).indices
    wts = scores.gather(1, idx)
    return idx, wts / wts.sum(dim=-1, keepdim=True) * scale


def moe_route(logits: torch.Tensor, bias: torch.Tensor, k: int, scale: float):
    """The router after its product: σ of the fp32 logits (N, E), the top k
    of σ + the correction bias (E,) (ties to the lower expert), their σ
    normalised to sum 1 times `scale`. (idx (N, k) int64, wts (N, k) fp32),
    idx in descending order of σ + bias. One warp a row on the card (E ≤ 64,
    k ≤ 8)."""
    if not _on_cuda("moe_route", logits, bias):
        return moe_route_ref(logits, bias, k, scale)
    _check_dtypes("moe_route", torch.float32, logits, bias)
    n, e = logits.shape
    if bias.shape != (e,) or e > _MAX_EXPERTS or not 1 <= k <= min(_MAX_K, e):
        raise ValueError(f"moe_route kernel does not take logits {tuple(logits.shape)}, bias "
                         f"{tuple(bias.shape)}, k {k}")
    idx = torch.empty((n, k), dtype=torch.int64, device=logits.device)
    wts = torch.empty((n, k), dtype=torch.float32, device=logits.device)
    _native.launch("hmm_moe_route", logits.device, logits.data_ptr(), bias.data_ptr(), n, e, k, float(scale),
                   idx.data_ptr(), wts.data_ptr())
    _native.count_launch(moe_route)
    return idx, wts


moe_route.launches = 0

# ---------------------------------------------------------------- permute


def _permute_plan(n: int) -> Tuple[int, int, int]:
    """(tiles, splits, threads) of a permute over n rows: tiles of 1024
    rows; a block ranks one tile, a thread a row (at least two warps); the
    tile's rows split over enough blocks for about two an SM, at least one
    row each. A decode step (n ≤ 256) is one tile in up to 256 blocks; a
    prefill forward of 32768 rows 32 tiles of 9 blocks, after a count
    kernel."""
    tiles = -(-n // _TILE)
    rows = min(n, _TILE)
    threads = max(64, -(-rows // 32) * 32)
    splits = max(1, min(rows, -(-2 * _SMS // tiles)))
    return tiles, splits, threads


def moe_permute_ref(idx: torch.Tensor, h: torch.Tensor, n_experts: int, live: Optional[torch.Tensor] = None,
                    stats: Optional[torch.Tensor] = None):
    """(xs (N·k, D), slots (N, k) int32, offs (E,) int32) through a stable
    argsort of the chosen experts; `stats` gains the counters in place."""
    n, k = idx.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    xs = h[order // k]
    ends = torch.searchsorted(flat[order], torch.arange(1, n_experts + 1, device=h.device))
    slots = torch.empty_like(order).scatter_(0, order, torch.arange(n * k, device=h.device))
    if stats is not None:
        ones = torch.ones_like(flat) if live is None else live[:, None].expand(n, k).reshape(-1).long()
        counts = torch.zeros((n_experts,), dtype=torch.long, device=h.device).index_add_(0, flat, ones)
        stats += torch.stack([(counts > 0).sum(), counts.sum(), counts.max()])
    return xs, slots.reshape(n, k).to(torch.int32), ends.to(torch.int32)


def moe_permute(idx: torch.Tensor, h: torch.Tensor, n_experts: int, live: Optional[torch.Tensor] = None,
                stats: Optional[torch.Tensor] = None):
    """Rows h (N, D) into expert-major order for the grouped products: xs
    (N·k, D), where route (r, j) of idx (N, k) sits at slots[r, j] (int32),
    the experts' routes in order of their rows; offs (E,) int32, each
    expert's end in xs. `stats` (3,) int64 gains the experts hit, the routes
    and the busiest expert's routes over the rows `live` (N,) bool marks
    (None: every row). On the card h is bf16 with D % 8 == 0."""
    ts = [idx, h] + [t for t in (live, stats) if t is not None]
    if not _on_cuda("moe_permute", *ts):
        return moe_permute_ref(idx, h, n_experts, live, stats)
    _check_dtypes("moe_permute", torch.bfloat16, h)
    n, k = idx.shape
    d = h.shape[1]
    if (idx.dtype != torch.int64 or h.shape[0] != n or d % 8 or n_experts > _MAX_EXPERTS or k > _MAX_K
            or (live is not None and (live.dtype != torch.bool or live.shape != (n,)))
            or (stats is not None and (stats.dtype != torch.int64 or stats.shape != (3,)))):
        raise ValueError(f"moe_permute kernel does not take idx {tuple(idx.shape)} {idx.dtype}, h "
                         f"{tuple(h.shape)}, {n_experts} experts")
    dev = h.device
    tiles, splits, threads = _permute_plan(n)
    xs = torch.empty((n * k, d), dtype=h.dtype, device=dev)
    slots = torch.empty((n, k), dtype=torch.int32, device=dev)
    offs = torch.empty((n_experts,), dtype=torch.int32, device=dev)
    counts = torch.empty((tiles, 2, n_experts), dtype=torch.int32, device=dev) if tiles > 1 else None
    _native.launch("hmm_moe_permute", dev, idx.data_ptr(), None if live is None else live.data_ptr(),
                   h.data_ptr(), n, k, n_experts, d, tiles, splits, threads,
                   None if counts is None else counts.data_ptr(), xs.data_ptr(), slots.data_ptr(), offs.data_ptr(),
                   None if stats is None else stats.data_ptr())
    _native.count_launch(moe_permute)
    return xs, slots, offs


moe_permute.launches = 0

# ----------------------------------------------------------------- swiglu


def swiglu_ref(gu: torch.Tensor) -> torch.Tensor:
    """(M, 2F) gate and up -> (M, F) silu(g) · u, in fp32, cast to gu.dtype."""
    f = gu.shape[-1] // 2
    return (F.silu(gu[..., :f].float()) * gu[..., f:].float()).to(gu.dtype)


def swiglu(gu: torch.Tensor) -> torch.Tensor:
    """SwiGLU between an MLP's two products: gu (M, 2F), the gate then the
    up projection, -> (M, F) in gu's dtype (on the card bf16, F % 8 == 0)."""
    if not _on_cuda("swiglu", gu):
        return swiglu_ref(gu)
    _check_dtypes("swiglu", torch.bfloat16, gu)
    m, f = gu.numel() // gu.shape[-1], gu.shape[-1] // 2
    _check_rows("swiglu", f, gu)
    out = torch.empty((*gu.shape[:-1], f), dtype=gu.dtype, device=gu.device)
    _native.launch("hmm_swiglu_bf16", gu.device, gu.data_ptr(), out.data_ptr(), m, f)
    _native.count_launch(swiglu)
    return out


swiglu.launches = 0

# ---------------------------------------------------------------- combine


def moe_combine_ref(y: torch.Tensor, slots: torch.Tensor, wts: torch.Tensor,
                    shared: Optional[torch.Tensor] = None, x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_k wts · y[slots] (N, D) in fp32, plus shared (fp32) where given;
    with x, (x + that) cast to x.dtype."""
    n, k = slots.shape
    acc = (y[slots.long()].reshape(n, k, -1).float() * wts[..., None]).sum(dim=1)
    if shared is not None:
        acc = acc + shared.float()
    return acc if x is None else (x.float() + acc).to(x.dtype)


def moe_combine(y: torch.Tensor, slots: torch.Tensor, wts: torch.Tensor, shared: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """The residual stream's next rows: x + (Σ_k wts[:, k] · y[slots[:, k]] +
    shared) for the expert outputs y (N·k, D) in expert-major order, slots
    and wts (N, k), the shared expert's rows and x (N, D); fp32 throughout,
    k in order, cast to x's dtype (on the card bf16, D % 8 == 0)."""
    if not _on_cuda("moe_combine", y, slots, wts, shared, x):
        return moe_combine_ref(y, slots, wts, shared, x)
    _check_dtypes("moe_combine", torch.bfloat16, y, shared, x)
    n, k = slots.shape
    d = x.shape[1]
    if (slots.dtype != torch.int32 or wts.dtype != torch.float32 or wts.shape != (n, k)
            or y.shape != (n * k, d) or shared.shape != (n, d) or x.shape != (n, d)):
        raise ValueError(f"moe_combine kernel does not take y {tuple(y.shape)}, slots {tuple(slots.shape)}, "
                         f"x {tuple(x.shape)}")
    _check_rows("moe_combine", d, y, shared, x)
    out = torch.empty_like(x)
    _native.launch("hmm_moe_combine_bf16", x.device, y.data_ptr(), slots.data_ptr(), wts.data_ptr(),
                   shared.data_ptr(), x.data_ptr(), out.data_ptr(), n, k, d)
    _native.count_launch(moe_combine)
    return out


moe_combine.launches = 0
