"""K2: fused transformer MLP (fc1 → bias → GELU → fc2) — Hopper kernel + plain version.

Counterpart of hippomm_tpu/ops/fused_mlp.py (`fused_mlp` over the Pallas
`_mlp_kernel`). The kernel is CUDA C++ in csrc/fused_mlp.cu (32-row tiles,
128-wide hidden chunks, fp32 accumulator in shared memory, weights streamed
through a cp.async ring: the (N, F) hidden never reaches device memory).
`fused_mlp_ref` is the same function in plain PyTorch, in the op order of
hippomm_tpu.ops.fused_mlp._ref_mlp:

    h = cast(x·W1ᵀ + b1) → exact-erf GELU → cast(h·W2ᵀ + b2)

The TPU kernel's Abramowitz–Stegun and polynomial erfs existed only because
Mosaic has no erf; CUDA has erff, so the kernel is exact-erf like the
reference. `fused_mlp` runs the kernel for CUDA tensors and the plain version
for CPU tensors; a CUDA call that the kernel cannot take raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_LANES = 128
_ROWS = 32  # the kernel's row tile
# The kernel's (32, D) fp32 accumulator lives in shared memory beside its
# two-stage weight ring: D ≤ 1280 keeps both inside the 227 KB a Hopper
# block may use (ViT-H and Whisper large are 1280). Wider D needs D split
# over a thread-block cluster, which is not written yet.
_MAX_D = 1280


def fused_mlp_supported(n: int, d: int, f: int) -> bool:
    """Static gate, as hippomm_tpu.ops.fused_mlp.fused_mlp_supported."""
    return n >= 8 and d % _LANES == 0 and f % _LANES == 0


def fused_mlp_ref(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch MLP in the kernel's op order. x (N, D) compute dtype;
    w1 (F, D), b1 (F,), w2 (D, F), b2 (D,) — weights cast to x.dtype, biases
    added in fp32. Returns (N, D) in x.dtype."""
    dt = x.dtype
    h = torch.matmul(x.float(), w1.to(dt).float().t())
    h = (h + b1.float()).to(dt)
    y = F.gelu(h)
    out = torch.matmul(y.float(), w2.to(dt).float().t())
    return (out + b2.float()).to(dt)


def fused_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """Fused MLP: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Counts kernel launches in `fused_mlp.launches`."""
    if x.dim() != 2:
        raise ValueError(f"fused_mlp takes x (N, D), got {tuple(x.shape)}")
    n, d = x.shape
    f = w1.shape[0]
    if w1.shape != (f, d) or w2.shape != (d, f) or b1.shape != (f,) or b2.shape != (d,):
        raise ValueError(
            f"fused_mlp shapes: x {tuple(x.shape)} w1 {tuple(w1.shape)} b1 {tuple(b1.shape)} "
            f"w2 {tuple(w2.shape)} b2 {tuple(b2.shape)}"
        )
    if any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("fused_mlp: all operands must be on one device")
    if x.device.type == "cpu":
        return fused_mlp_ref(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"the fused_mlp CUDA kernel takes bfloat16 only, got {x.dtype}")
    if not fused_mlp_supported(n, d, f):
        raise ValueError(f"fused_mlp kernel does not take n={n} d={d} f={f}")
    if d > _MAX_D:
        raise NotImplementedError(
            f"the fused_mlp CUDA kernel takes d <= {_MAX_D} (its shared-memory accumulator), got {d}"
        )
    w1, w2 = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    b1, b2 = b1.float(), b2.float()
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_mlp kernel takes contiguous, 16-byte aligned {name}")
    np_ = -(-n // _ROWS) * _ROWS
    if np_ != n:
        x = F.pad(x, (0, 0, 0, np_ - n))
    out = torch.empty((np_, d), dtype=x.dtype, device=x.device)
    from hippomm_tpu_torch.ops import _native

    lib = _native.kernels()
    with torch.cuda.device(x.device):
        rc = lib.hmm_fused_mlp_bf16(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), np_, d, f, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: CUDA error {rc}")
    fused_mlp.launches += 1
    return out if np_ == n else out[:n]


fused_mlp.launches = 0
