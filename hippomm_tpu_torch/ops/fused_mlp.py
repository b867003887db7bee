"""K2 and K3: fused transformer MLP and LN+MLP+residual half-block — Hopper
kernels + plain versions.

Counterpart of hippomm_tpu/ops/fused_mlp.py:

  * K2 `fused_mlp` (the Pallas `_mlp_kernel`):
        h = cast(x·W1ᵀ + b1) → exact-erf GELU → cast(h·W2ᵀ + b2)
  * K3 `fused_ln_mlp_residual` (the Pallas `_ln_mlp_kernel`):
        x + K2(cast(LN(x)))  — LN statistics and affine in fp32, the residual
    add in the stream dtype. Routed by `models/layers._mlp_halfblock` (every
    ImageBind encoder block) when HIPPOMM_FUSED_BLOCK=1 (`fused_block_default`).

Both are CUDA C++ in csrc/fused_mlp.cu, one kernel template (32-row tiles,
128-wide hidden chunks, fp32 accumulator in shared memory, weights streamed
through a cp.async ring: the (N, F) hidden never reaches device memory; K3
adds a row-statistics prologue, normalises each X slice in shared memory and
adds x back in the epilogue). `fused_mlp_ref` / `fused_ln_mlp_residual_ref`
are the same functions in plain PyTorch, in the op order of
hippomm_tpu.ops.fused_mlp._ref_mlp / _ref_ln_mlp_residual.

The TPU kernels' Abramowitz–Stegun and polynomial erfs existed only because
Mosaic has no erf; CUDA has erff, so the kernels are exact-erf like the
reference. Each wrapper runs the kernel for CUDA tensors and the plain
version for CPU tensors; a CUDA call that the kernel cannot take raises.
"""

from __future__ import annotations

import functools
import os

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


def _check_operands(name: str, x, w1, b1, w2, b2, *norm) -> bool:
    """Shapes and devices of a K2/K3 call; True when the kernel must run
    (CUDA), False for the plain version (CPU). Raises for what the CUDA
    kernel does not take."""
    if x.dim() != 2:
        raise ValueError(f"{name} takes x (N, D), got {tuple(x.shape)}")
    n, d = x.shape
    f = w1.shape[0]
    if (w1.shape != (f, d) or w2.shape != (d, f) or b1.shape != (f,) or b2.shape != (d,)
            or any(t.shape != (d,) for t in norm)):
        raise ValueError(
            f"{name} shapes: x {tuple(x.shape)} w1 {tuple(w1.shape)} b1 {tuple(b1.shape)} "
            f"w2 {tuple(w2.shape)} b2 {tuple(b2.shape)} norm {[tuple(t.shape) for t in norm]}"
        )
    if any(t.device != x.device for t in (w1, b1, w2, b2, *norm)):
        raise ValueError(f"{name}: all operands must be on one device")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"the {name} CUDA kernel takes bfloat16 only, got {x.dtype}")
    if not fused_mlp_supported(n, d, f):
        raise ValueError(f"{name} kernel does not take n={n} d={d} f={f}")
    if d > _MAX_D:
        raise NotImplementedError(
            f"the {name} CUDA kernel takes d <= {_MAX_D} (its shared-memory accumulator), got {d}"
        )
    return True


def _launch(entry: str, x, vectors, w1, b1, w2, b2, tail=()) -> torch.Tensor:
    """Pad N to the kernel's row tile, launch `entry` on the current stream
    and return the (N, D) bf16 output. `vectors` are the fp32 (D,) operands
    that precede W1 in the C signature (K3's gamma and beta)."""
    n, d = x.shape
    f = w1.shape[0]
    w1, w2 = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    b1, b2 = b1.float(), b2.float()
    vectors = [t.float() for t in vectors]
    for t in (x, w1, b1, w2, b2, *vectors):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{entry} takes contiguous, 16-byte aligned operands")
    np_ = -(-n // _ROWS) * _ROWS
    if np_ != n:
        x = F.pad(x, (0, 0, 0, np_ - n))
    out = torch.empty((np_, d), dtype=x.dtype, device=x.device)
    from hippomm_tpu_torch.ops import _native

    lib = _native.kernels()
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), *(t.data_ptr() for t in vectors), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), np_, d, f, *tail,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out if np_ == n else out[:n]


def fused_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """Fused MLP: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Counts kernel launches in `fused_mlp.launches`."""
    if not _check_operands("fused_mlp", x, w1, b1, w2, b2):
        return fused_mlp_ref(x, w1, b1, w2, b2)
    out = _launch("hmm_fused_mlp_bf16", x, (), w1, b1, w2, b2)
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0


# ---------------------------------------------------------------------------
# K3: LN → MLP → residual, one pass
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def fused_block_default() -> bool:
    """Route policy for the LN+MLP+residual half-block kernel, as the JAX
    package's: HIPPOMM_FUSED_BLOCK=1 turns it on; default off."""
    flag = os.environ.get("HIPPOMM_FUSED_BLOCK", "auto").lower()
    if flag in ("1", "true", "on"):
        return True
    return False


def _ref_ln(x, gamma, beta, eps: float) -> torch.Tensor:
    """models/layers.layer_norm (fp32 statistics and affine), kept here so
    ops/ imports nothing of models/."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y * gamma.float() + beta.float()


def fused_ln_mlp_residual_ref(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch half-block in the op order of the JAX
    _ref_ln_mlp_residual: t = cast(LN(x)); x + fused_mlp_ref(t) in x.dtype."""
    t = _ref_ln(x, gamma, beta, eps).to(x.dtype)
    return x + fused_mlp_ref(t, w1, b1, w2, b2)


def fused_ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-6) -> torch.Tensor:
    """x + mlp(LN(x)) for x (N, D) in the stream dtype: the CUDA kernel for
    CUDA tensors (bf16, D ≤ 1280), the plain version for CPU tensors. Counts
    kernel launches in `fused_ln_mlp_residual.launches`."""
    if not _check_operands("fused_ln_mlp_residual", x, w1, b1, w2, b2, gamma, beta):
        return fused_ln_mlp_residual_ref(x, gamma, beta, w1, b1, w2, b2, eps)
    out = _launch("hmm_fused_ln_mlp_residual_bf16", x, (gamma, beta), w1, b1, w2, b2,
                  tail=(float(eps),))
    fused_ln_mlp_residual.launches += 1
    return out


fused_ln_mlp_residual.launches = 0
