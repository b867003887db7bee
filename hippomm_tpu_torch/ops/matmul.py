"""Products of compute-dtype operands that return fp32, differentiable.

JAX's `jnp.dot(a, b, preferred_element_type=float32)` on bf16 operands. On
CUDA the tensor cores' fp32 accumulator is returned without a bf16 rounding
(the `out_dtype` overloads of torch.mm / torch.bmm); elsewhere the operands
are widened to fp32 first — exact, since a bf16·bf16 product fits fp32.

torch has no derivative for the `out_dtype` overload, so on CUDA the product
is an autograd Function. Its backward takes the same kind of products: the
fp32 cotangent rounded to the operands' dtype (what the TPU's default
precision does to an fp32 operand of JAX's transposed dot), bf16 tensor-core
products with fp32 results, each gradient cast to its operand's dtype. fp32
products instead would run outside the tensor cores (TF32 is kept off), at
about a fifteenth of the rate.
"""

from __future__ import annotations

import torch

_TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)


def _tensor_core(t: torch.Tensor) -> bool:
    return t.is_cuda and t.dtype in _TENSOR_CORE_DTYPES


def needs_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd records an op on `ts`: the kernel wrappers take
    their autograd Function only then, and keep inference on the plain
    launch path."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _MatmulF32(torch.autograd.Function):
    """a (M, K) @ w (N, K)ᵀ → (M, N) fp32 on CUDA tensor cores."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        gc = g.to(a.dtype)
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(gc, w, out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(gc.t(), a, out_dtype=torch.float32).to(w.dtype)
        return da, dw


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (N, K)ᵀ → (..., N) in fp32, from operands in their given
    (compute) dtype; differentiable on every device."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if _tensor_core(a2) and w.dtype == a2.dtype:
        if needs_grad(a2, w):
            y = _MatmulF32.apply(a2, w)
        else:
            y = torch.mm(a2, w.t(), out_dtype=torch.float32)
    else:
        y = a2.float() @ w.float().t()
    return y.reshape(*lead, w.shape[0])


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, K) @ (..., K, N) → (..., M, N) in fp32 from operands of one
    dtype, as `matmul_f32` takes them; not differentiable (attention's
    backward recompute, which runs outside autograd)."""
    m, n = a.shape[-2], b.shape[-1]
    lead = a.shape[:-2]
    if _tensor_core(a) and b.dtype == a.dtype:
        y = torch.bmm(a.reshape(-1, m, a.shape[-1]), b.reshape(-1, b.shape[-2], n), out_dtype=torch.float32)
        return y.reshape(*lead, m, n)
    return torch.matmul(a.float(), b.float())
