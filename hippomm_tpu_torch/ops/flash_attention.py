"""K1 and K4: fused mask-free multi-head attention — Hopper kernel + plain versions.

Counterpart of hippomm_tpu/ops/flash_attention.py:

  * K1 `flash_mha` (the Pallas `_mha_kernel`): q/k/v head-split, (B, H, T, hd)
  * K4 `flash_mha_bthd` (the Pallas `_mha_kernel_bthd`): q/k/v in the native
    (B, T, H, hd) layout of the QKV projection's reshape — no head-split or
    merge transposes. Routed by `models/layers.attention` when
    HIPPOMM_FLASH_BTHD=1 (`bthd_default`) and the JAX gate `bthd_supported`
    admits the shape (H = 16, the ImageBind vision tower; H = 12 and H = 20
    keep K1).

For bf16 operands both are one CUDA C++ kernel over element strides,
csrc/flash_mha.cu: TMA loads into a shared-memory ring, wgmma for q·kᵀ and
for p·v (p from registers), a producer warp and two consumer warpgroups
whose softmax runs under each other's products. `_attn_plan` chooses its
tiles from the shape. For fp32 operands (the fp32 towers and training, as
the JAX package computes them in the operand dtype) both are
csrc/flash_mha_f32.cu, the same structure with both products as 3×TF32
wgmma on the tensor cores (each operand split into TF32 hi and lo parts;
fp32 softmax; `_attn_plan_f32`). K4 reads strided views, such as the q slice of a packed
(B, T, 3D) projection, without a copy. `flash_mha_ref` / `flash_mha_bthd_ref`
are the same functions in plain PyTorch, in the JAX op order:

    softmax(q·kᵀ·scale) in fp32 → cast to q.dtype → ·v, fp32 accumulation
    → q.dtype

Each wrapper runs a kernel for a CUDA tensor (bf16 or fp32) and the plain
version for a CPU tensor — nothing else: a CUDA call that the kernels cannot
take (another dtype, a shape past the gate) raises.
Both wrappers are differentiable, as the JAX package's custom_vjp wrappers
are: when an operand requires grad they run under `_Attention`, whose
backward is the JAX `_bwd` / `_bthd_bwd` recompute in plain PyTorch (the
JAX package has no backward kernel either); the kernel runs the forward.
The TPU-only schedules of the JAX module (CLS-split, fast-exp) were written
for the v5e's vector unit and have no counterpart here.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from hippomm_tpu_torch.ops import _native
from hippomm_tpu_torch.ops.matmul import bmm_f32, needs_grad

# Per-head key length the JAX routing gate admits (its VMEM budget); the
# CUDA kernel streams K/V and has no such limit, but the gate is kept so both
# packages route the same shapes to the kernel.
_MAX_TK = 2048
_MAX_HD = 128
_LANES = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# The kernel's tiles (csrc/flash_mha.cu): a work tile is 128 query rows of
# one head (two consumer warpgroups of 64); keys come in tiles of 128, and a
# last remainder of at most 16 keys in one 16-key tile; hd is stored in
# panels of 64 columns and one of the rest (16, 32, or 48 stored 64 wide).
_Q_ROWS = 128
_KEY_TILE = 128
_KEY_TAIL = 16


class AttnPlan(NamedTuple):
    """Tiles of one kernel call: (start, length) of each query tile and key
    tile (the last may run past the end; those rows and keys are zero-filled
    and masked), and (start, columns, stored width) of each hd panel of the
    padded head dim `hd_padded`. `n_full` 128-key tiles, then a 16-key one
    if `tail` is 1 — what the C entry points take."""

    q_tiles: Tuple[Tuple[int, int], ...]
    key_tiles: Tuple[Tuple[int, int], ...]
    panels: Tuple[Tuple[int, int, int], ...]
    hd_padded: int
    n_full: int
    tail: int


def _attn_plan(tq: int, tk: int, hd: int) -> AttnPlan:
    """The kernel's tile plan for q (.., tq, hd) against k/v (.., tk, hd)."""
    if tq < 1 or tk < 1 or not 1 <= hd <= _MAX_HD:
        raise ValueError(f"no attention plan for tq={tq} tk={tk} hd={hd}")
    n_full, rem = divmod(tk, _KEY_TILE)
    tail = 1 if 0 < rem <= _KEY_TAIL else 0
    if rem > _KEY_TAIL:
        n_full += 1  # one more 128-key tile, its keys past tk masked
    keys = tuple((j * _KEY_TILE, _KEY_TILE) for j in range(n_full)) + (
        ((n_full * _KEY_TILE, _KEY_TAIL),) if tail else ())
    hdp = _round_up(hd, 16)
    panels = tuple((c, min(64, hdp - c), 64 if hdp - c >= 48 else hdp - c) for c in range(0, hdp, 64))
    q_tiles = tuple((r, _Q_ROWS) for r in range(0, tq, _Q_ROWS))
    return AttnPlan(q_tiles, keys, panels, hdp, n_full, tail)


# The fp32 kernel's tiles (csrc/flash_mha_f32.cu): a work tile is 128 query
# rows of one head (two consumer warpgroups of 64); keys come in tiles of 32,
# or of 16 past hd 80 (shared memory); hd is rounded up to 16 (the columns
# past hd are TMA's zero fill, in shared memory only).
_F32_Q_ROWS = 128


def _f32_key_tile(nc: int) -> int:
    """Keys a tile of the fp32 kernel's template instance nc (hd ≤ 16·nc)."""
    return 32 if nc <= 5 else 16


class AttnPlanF32(NamedTuple):
    """Tiles of one fp32 kernel call: (start, length) of each query tile and
    key tile (the last of each may run past the end: rows past tq are not
    written, keys past tk are masked), `nc`, the head dim rounded up to 16,
    over 16 (the kernel's template instance), and `key_tile`, its keys a
    tile."""

    q_tiles: Tuple[Tuple[int, int], ...]
    key_tiles: Tuple[Tuple[int, int], ...]
    nc: int
    key_tile: int


def _attn_plan_f32(tq: int, tk: int, hd: int) -> AttnPlanF32:
    """The fp32 kernel's tile plan for q (.., tq, hd) against k/v (.., tk, hd)."""
    if tq < 1 or tk < 1 or not 1 <= hd <= _MAX_HD:
        raise ValueError(f"no fp32 attention plan for tq={tq} tk={tk} hd={hd}")
    nc = -(-hd // 16)
    kt = _f32_key_tile(nc)
    return AttnPlanF32(tuple((r, _F32_Q_ROWS) for r in range(0, tq, _F32_Q_ROWS)),
                       tuple((j, kt) for j in range(0, tk, kt)), nc, kt)


def _tma_ready(t: torch.Tensor) -> bool:
    """The fp32 kernel's TMA takes an operand as it is: every stride a
    multiple of 4 elements (16 bytes), the hd axis contiguous, the start
    16-byte aligned."""
    return t.stride(3) == 1 and all(st % 4 == 0 for st in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _flash_f32(counter, q, k, v, scale: float, bthd: bool) -> torch.Tensor:
    """Launch csrc/flash_mha_f32.cu on fp32 CUDA q, k, v: (B, H, T, hd)
    (K1) or (B, T, H, hd) views (K4), read in place where TMA takes their
    strides (`_tma_ready`: the path's tensors and the packed projection's
    slices), else first copied with hd zero-padded to a multiple of 4 (the
    columns add 0 to q·k and give zero output columns, sliced off). A
    contiguous output in the same layout. Counts the launch on `counter`
    (its fp32 count too)."""
    if bthd:
        b, tq, h, hd = q.shape
        tk = k.shape[1]
        strides = _bht_strides
    else:
        b, h, tq, hd = q.shape
        tk = k.shape[2]
        strides = lambda t: (t.stride(0), t.stride(1), t.stride(2))  # noqa: E731
    if not all(_tma_ready(t) for t in (q, k, v)):
        hd4 = _round_up(hd, 4)
        q, k, v = (F.pad(t, (0, hd4 - hd)) for t in (q, k, v))
    width = q.shape[3]
    plan = _attn_plan_f32(tq, tk, width)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _native.launch("hmm_flash_mha_f32", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, h, tq, tk, width, *strides(q), *strides(k), *strides(v), *strides(out),
                   len(plan.q_tiles), len(plan.key_tiles), plan.nc, float(scale))
    _native.count_launch(counter, fp32=True)
    return out if width == hd else out[..., :hd]


def flash_supported(tq: int, tk: int, hd: int) -> bool:
    """Static shape gate, as hippomm_tpu.ops.flash_attention.flash_supported."""
    return hd <= _MAX_HD and tk <= _MAX_TK and tq >= 1


def flash_mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch attention in the kernel's op order. q (B, H, Tq, hd),
    k/v (B, H, Tk, hd) → (B, H, Tq, hd) in q.dtype. Products are taken in
    fp32 from operands already in the compute dtype (exact for bf16)."""
    dt = q.dtype
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w.to(dt).float(), v.float()).to(dt)


def _attention_bwd(q, k, v, g, scale: float):
    """The JAX `_bwd` recompute, op for op, on (B, H, T, hd) operands: fp32
    logits·scale and softmax, products of compute-dtype operands with fp32
    results, each gradient cast to its input's dtype."""
    dt = q.dtype
    w = torch.softmax(bmm_f32(q, k.transpose(-1, -2)) * scale, dim=-1)
    wc = w.to(dt)
    g = g.to(dt)
    dv = bmm_f32(wc.transpose(-1, -2), g)
    dw = bmm_f32(g, v.transpose(-1, -2))
    dlogits = (w * (dw - (dw * w).sum(dim=-1, keepdim=True)) * scale).to(dt)
    dq = bmm_f32(dlogits, k)
    dk = bmm_f32(dlogits.transpose(-1, -2), q)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    """K1 or K4 (`forward`) with the JAX custom_vjp's backward. Saves the
    unpadded inputs — for K4 the strided views, whose gradients autograd
    scatters into the tensor they view."""

    @staticmethod
    def forward(ctx, q, k, v, scale, forward, bthd):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.bthd = scale, bthd
        return forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if ctx.bthd:  # (B, T, H, hd) → the (B, H, T, hd) views and back
            q, k, v, g = (t.transpose(1, 2) for t in (q, k, v, g))
        grads = _attention_bwd(q, k, v, g, ctx.scale)
        if ctx.bthd:
            grads = tuple(t.transpose(1, 2) for t in grads)
        return (*grads, None, None, None)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Fused attention: a CUDA kernel for CUDA tensors (bf16, contiguous; or
    fp32, a contiguous hd axis), the plain version for CPU tensors;
    differentiable (`_Attention`). Counts kernel launches in
    `flash_mha.launches`, the fp32 kernel's also in `flash_mha.launches_f32`."""
    if needs_grad(q, k, v):
        return _Attention.apply(q, k, v, scale, _flash_mha_forward, False)
    return _flash_mha_forward(q, k, v, scale)


def _flash_mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_mha takes 4-D (B, H, T, hd) tensors, got {q.shape} {k.shape} {v.shape}")
    b, h, tq, hd = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, hd) or v.shape != k.shape:
        raise ValueError(f"flash_mha shape mismatch: q {q.shape} k {k.shape} v {v.shape}")
    if not (q.device == k.device == v.device) or not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_mha: q, k, v must share device and dtype")
    if q.device.type == "cpu":
        return flash_mha_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the flash_mha CUDA kernels take bfloat16 or float32, got {q.dtype}")
    if not flash_supported(tq, tk, hd):
        raise ValueError(f"flash_mha kernel does not take tq={tq} tk={tk} hd={hd}")
    if q.dtype == torch.float32:
        return _flash_f32(flash_mha, q, k, v, scale, bthd=False)
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_mha kernel takes contiguous, 16-byte aligned q, k, v")
    plan = _attn_plan(tq, tk, hd)
    hdp = plan.hd_padded
    if hdp != hd:
        # zero columns add 0 to q·k and give zero output columns (sliced off)
        q, k, v = (F.pad(t, (0, hdp - hd)) for t in (q, k, v))
    out = torch.empty_like(q)
    _native.launch("hmm_flash_mha_bf16", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, h, tq, tk, hdp, plan.n_full, plan.tail, float(scale))
    _native.count_launch(flash_mha)
    return out if hdp == hd else out[..., :hd]


flash_mha.launches = 0
flash_mha.launches_f32 = 0


# ---------------------------------------------------------------------------
# K4: the (B, T, H, hd) layout
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def flash_default() -> bool:
    """Route policy for K1 and K4, as the JAX package's: HIPPOMM_FLASH_ATTN=0
    (or false/off) sends mask-free attention to the plain torch ops, 1/true/on
    forces the kernels; "auto" (the default) is on — on CUDA the kernels, on
    the CPU the wrappers' plain versions."""
    return os.environ.get("HIPPOMM_FLASH_ATTN", "auto").lower() not in ("0", "false", "off")


@functools.lru_cache(maxsize=1)
def bthd_default() -> bool:
    """Route policy for the transpose-free layout, as the JAX package's:
    HIPPOMM_FLASH_BTHD=1 turns it on; default off."""
    flag = os.environ.get("HIPPOMM_FLASH_BTHD", "auto").lower()
    if flag in ("1", "true", "on"):
        return True
    return False


def _bthd_gh(h: int):
    if h % 8 == 0:
        return 8
    if h <= 8:
        return h
    return None


def bthd_supported(b: int, h: int, tq: int, tk: int, hd: int) -> bool:
    """Static gate, as hippomm_tpu.ops.flash_attention.bthd_supported (its
    head grouping and per-step VMEM budget), so both packages route the same
    shapes to the (B, T, H, hd) kernel; the CUDA kernel itself has no such
    limit."""
    gh = _bthd_gh(h)
    if gh is None or hd > _LANES:
        return False
    per_step = 2 * (2 * tq + 2 * tk) * gh * _round_up(hd, _LANES) * 2 + tq * tk * 4
    return per_step <= 10 * 1024 * 1024


def flash_mha_bthd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch attention in (B, T, H, hd): q (B, Tq, H, hd), k/v
    (B, Tk, H, hd) → (B, Tq, H, hd) in q.dtype; flash_mha_ref on the
    head-split views."""
    return flash_mha_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale).transpose(1, 2)


def _bht_strides(t: torch.Tensor):
    """(batch, head, row) element strides of a (B, T, H, hd) view — the
    order the C entry point takes."""
    return t.stride(0), t.stride(2), t.stride(1)


def flash_mha_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Fused attention in the native (B, T, H, hd) layout: a CUDA kernel for
    CUDA tensors (strided views with a contiguous hd axis; bf16 with every
    stride a multiple of 8 elements and a 16-byte aligned start, or fp32),
    the plain version for CPU tensors; differentiable (`_Attention`).
    Returns a contiguous (B, Tq, H, hd) tensor on CUDA. Counts kernel
    launches in `flash_mha_bthd.launches`, the fp32 kernel's also in
    `flash_mha_bthd.launches_f32`."""
    if needs_grad(q, k, v):
        return _Attention.apply(q, k, v, scale, _flash_mha_bthd_forward, True)
    return _flash_mha_bthd_forward(q, k, v, scale)


def _flash_mha_bthd_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_mha_bthd takes 4-D (B, T, H, hd) tensors, got {q.shape} {k.shape} {v.shape}"
        )
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, h, hd) or v.shape != k.shape:
        raise ValueError(f"flash_mha_bthd shape mismatch: q {q.shape} k {k.shape} v {v.shape}")
    if not (q.device == k.device == v.device) or not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_mha_bthd: q, k, v must share device and dtype")
    if q.device.type == "cpu":
        return flash_mha_bthd_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_bthd: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the flash_mha_bthd CUDA kernels take bfloat16 or float32, got {q.dtype}")
    if hd > _MAX_HD:
        raise ValueError(f"flash_mha_bthd kernel takes hd <= {_MAX_HD}, got {hd}")
    if q.dtype == torch.float32:
        return _flash_f32(flash_mha_bthd, q, k, v, scale, bthd=True)
    plan = _attn_plan(tq, tk, hd)
    hdp = plan.hd_padded
    if hdp != hd:
        # the padding copies, as the JAX wrapper's pad does; zero columns add
        # 0 to q·k and give zero output columns (sliced off)
        q, k, v = (F.pad(t, (0, hdp - hd)) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"flash_mha_bthd kernel takes {name} with a contiguous hd axis, strides that are "
                f"multiples of 8 and a 16-byte aligned start; got strides {t.stride()}"
            )
    out = torch.empty((b, tq, h, hdp), dtype=q.dtype, device=q.device)
    _native.launch("hmm_flash_mha_bthd_bf16", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), b, h, tq, tk, hdp, *_bht_strides(q), *_bht_strides(k), *_bht_strides(v),
                   plan.n_full, plan.tail, float(scale))
    _native.count_launch(flash_mha_bthd)
    return out if hdp == hd else out[..., :hd]


flash_mha_bthd.launches = 0
flash_mha_bthd.launches_f32 = 0
