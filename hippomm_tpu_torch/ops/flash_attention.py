"""K1: fused mask-free multi-head attention — Hopper kernel + plain version.

Counterpart of hippomm_tpu/ops/flash_attention.py (`flash_mha` over the
Pallas `_mha_kernel`). The kernel itself is CUDA C++ in
csrc/flash_mha.cu (one block per 64 query rows of one head, K/V streamed
through shared memory with an online softmax); `flash_mha_ref` is the same
function in plain PyTorch, in the JAX op order:

    softmax(q·kᵀ·scale) in fp32 → cast to q.dtype → ·v, fp32 accumulation
    → q.dtype

`flash_mha` runs the kernel for a CUDA tensor and the plain version for a
CPU tensor — nothing else: a CUDA call that the kernel cannot take raises.
The TPU-only schedules of the JAX module (CLS-split, fast-exp, the BTHD
layout) were written for the v5e's vector unit and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Per-head key length the JAX routing gate admits (its VMEM budget); the
# CUDA kernel streams K/V and has no such limit, but the gate is kept so both
# packages route the same shapes to the kernel.
_MAX_TK = 2048
_MAX_HD = 128


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


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Fused attention forward: the CUDA kernel for CUDA tensors (bf16,
    contiguous), the plain version for CPU tensors. Counts kernel launches
    in `flash_mha.launches`."""
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
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"the flash_mha CUDA kernel takes bfloat16 only, got {q.dtype}")
    if not flash_supported(tq, tk, hd):
        raise ValueError(f"flash_mha kernel does not take tq={tq} tk={tk} hd={hd}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_mha kernel takes contiguous, 16-byte aligned q, k, v")
    hdp = -(-hd // 16) * 16
    if hdp != hd:
        # zero columns add 0 to q·k and give zero output columns (sliced off)
        q, k, v = (F.pad(t, (0, hdp - hd)) for t in (q, k, v))
    out = torch.empty_like(q)
    from hippomm_tpu_torch.ops import _native

    lib = _native.kernels()
    with torch.cuda.device(q.device):
        rc = lib.hmm_flash_mha_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, tq, tk, hdp, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_mha kernel launch failed: CUDA error {rc}")
    flash_mha.launches += 1
    return out if hdp == hd else out[..., :hd]


flash_mha.launches = 0
