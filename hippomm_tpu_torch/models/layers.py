"""Shared transformer building blocks (functions on tensors + param dicts).

Counterpart of hippomm_tpu/models/layers.py, with the same conventions:
  * params are nested dicts of tensors; weights follow the torch Linear
    convention W (out, in), y = x @ W.T + b
  * matmuls take operands in `compute_dtype` and return fp32 (JAX's
    preferred_element_type=float32; ops/matmul, differentiable on CUDA
    too); the fp32 bias is added after
  * LayerNorm statistics and affine always run in fp32
  * the residual stream is kept in the compute dtype

Kernel routes, by the JAX package's flags and shape gates only, whatever
the dtype:
  * mask-free attention → K4 `flash_mha_bthd` on the native (B, T, H, hd)
    views when HIPPOMM_FLASH_BTHD=1 and `bthd_supported` admits the shape
    (ImageBind vision, H = 16), else K1 `flash_mha` on head-split copies
    (ops/flash_attention); both only under `flash_default()`
    (HIPPOMM_FLASH_ATTN=0 takes the plain torch ops);
  * the encoder block's x + mlp(ln_2(x)) → K3 `fused_ln_mlp_residual` when
    HIPPOMM_FUSED_BLOCK=1 (`_mlp_halfblock`), else `mlp(cast_out=True)` → K2
    `fused_mlp` (ops/fused_mlp) under `fused_mlp_default()`
    (HIPPOMM_FUSED_MLP=0 takes the plain torch ops).
On CPU tensors the kernel wrappers run their plain versions; on CUDA their
bf16 or fp32 kernels (the compute dtype's), and a call the kernels cannot
take raises. A flag at 0 is
the user's choice of the plain ops, not a fallback. Every route is
differentiable: the kernel wrappers carry the JAX package's custom_vjp
backward (plain PyTorch recomputes), so training runs through the kernels.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hippomm_tpu_torch.ops import flash_attention as fa
from hippomm_tpu_torch.ops import fused_mlp as fm
from hippomm_tpu_torch.ops.flash_attention import flash_mha, flash_supported
from hippomm_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_supported
from hippomm_tpu_torch.ops.matmul import matmul_f32

Params = Dict[str, Any]


def linear(p: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    y = matmul_f32(x.to(dtype), p["weight"].to(dtype))
    if p.get("bias") is not None:
        y = y + p["bias"].float()
    return y


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """Stats and affine in fp32; out_dtype casts the result."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * p["weight"].float() + p["bias"].float()
    return y if out_dtype is None else y.to(out_dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # exact (erf) GELU — torch nn.GELU default
    return F.gelu(x)


def attention(
    p: Params,
    x_q: torch.Tensor,
    x_kv: Optional[torch.Tensor] = None,
    num_heads: int = 8,
    mask: Optional[torch.Tensor] = None,
    dtype=torch.bfloat16,
    kv_rows: Optional[int] = None,
) -> torch.Tensor:
    """Multi-head attention with torch packed-in_proj convention.

    p: {"in_proj": {"weight" (3D, D), "bias" (3D,)}, "out_proj": {...}}
    or separate {"q_proj","k_proj","v_proj","out_proj"} (Whisper/HF style).
    x_q: (B, Tq, D); x_kv: (B, Tk, D) for cross-attention (defaults to x_q).
    mask: additive fp32 (Tq, Tk) or (B, 1, Tq, Tk); -inf for masked.
    kv_rows: keys and values from the first kv_rows positions only — the
    same result as a -inf mask on the others, on every route (the padded
    tokens of parallel/megatron).
    """
    self_attn = x_kv is None
    if x_kv is None:
        x_kv = x_q

    if "in_proj" in p:
        w = p["in_proj"]["weight"].to(dtype)
        b = p["in_proj"].get("bias")
        # the projection's width: x's width, or the local heads' (3·D/mp
        # rows) of a tensor-parallel shard (parallel/tensor_parallel)
        d = w.shape[0] // 3
        if self_attn:
            # one (D, 3D) product; slicing columns equals three products, and
            # casting before slicing equals casting each slice: q/k/v stay
            # views of one (B, T, 3D) tensor (row stride 3D), which K4 reads
            # without a copy
            qkv = matmul_f32(x_q.to(dtype), w)
            if b is not None:
                qkv = qkv + b.float()
            qkv = qkv.to(dtype)
            q, k, v = qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]
        else:
            q = matmul_f32(x_q.to(dtype), w[:d])
            kv = matmul_f32(x_kv.to(dtype), w[d:])
            if b is not None:
                q = q + b[:d].float()
                kv = kv + b[d:].float()
            k, v = kv[..., :d], kv[..., d:]
    else:
        q = linear(p["q_proj"], x_q, dtype)
        k = linear(p["k_proj"], x_kv, dtype)
        v = linear(p["v_proj"], x_kv, dtype)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if kv_rows is not None:
        k, v = k[:, :kv_rows], v[:, :kv_rows]
    d = q.shape[-1]
    hd = d // num_heads

    if "bias_k" in p:
        # torch MultiheadAttention add_bias_kv=True (ImageBind audio trunk):
        # one learned K/V position appended post-projection to every row
        bsz = k.shape[0]
        bk = p["bias_k"].reshape(1, 1, d).expand(bsz, 1, d).to(dtype)
        bv = p["bias_v"].reshape(1, 1, d).expand(bsz, 1, d).to(dtype)
        k = torch.cat([k, bk], dim=1)
        v = torch.cat([v, bv], dim=1)
        if mask is not None:  # appended position is always attendable
            mask = F.pad(mask, (0, 1))

    scale = 1.0 / math.sqrt(hd)
    if mask is None and fa.flash_default() and fa.bthd_default():
        # transpose-free route (JAX layers.attention): K4 reads q/k/v in the
        # (B, T, H, hd) layout their reshape gives for free, and writes the
        # output in it, which out_proj reads with a free reshape
        bq, tq_, tk_ = q.shape[0], q.shape[1], k.shape[1]
        if fa.bthd_supported(bq, num_heads, tq_, tk_, hd):
            out = fa.flash_mha_bthd(
                q.reshape(bq, tq_, num_heads, hd),
                k.reshape(bq, tk_, num_heads, hd),
                v.reshape(bq, tk_, num_heads, hd),
                scale,
            )
            return linear(p["out_proj"], out.reshape(bq, tq_, d), dtype)

    def split(t):  # (B, T, D) -> (B, H, T, hd)
        b_, t_, _ = t.shape
        return t.reshape(b_, t_, num_heads, hd).transpose(1, 2).contiguous()

    q, k, v = split(q), split(k), split(v)
    b_, _, t_, _ = q.shape
    if mask is None and fa.flash_default() and flash_supported(q.shape[2], k.shape[2], hd):
        out = flash_mha(q, k, v, scale)
    else:
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if mask is not None:
            logits = logits + mask
        weights = torch.softmax(logits, dim=-1)
        out = torch.matmul(weights.to(dtype).float(), v.float())
    out = out.transpose(1, 2).reshape(b_, t_, d)
    return linear(p["out_proj"], out, dtype)


def mlp(p: Params, x: torch.Tensor, dtype=torch.bfloat16, cast_out: bool = False) -> torch.Tensor:
    """fc1 (fp32 accumulation + fp32 bias) → cast to the compute dtype BEFORE
    the GELU → fc2. cast_out=True declares that the caller casts the result
    to `dtype` at once, which lets the fused K2 kernel emit `dtype` itself."""
    if cast_out and p["fc1"].get("bias") is not None and p["fc2"].get("bias") is not None:
        f, d = p["fc1"]["weight"].shape
        n = math.prod(x.shape[:-1])
        if fm.fused_mlp_default() and fused_mlp_supported(n, d, f):
            y = fused_mlp(
                x.reshape(n, d).to(dtype),
                p["fc1"]["weight"], p["fc1"]["bias"], p["fc2"]["weight"], p["fc2"]["bias"],
            )
            return y.reshape(*x.shape[:-1], d)
    y = linear(p["fc1"], x, dtype).to(dtype)
    return linear(p["fc2"], gelu(y), dtype)


def encoder_block(
    p: Params,
    x: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Pre-LN transformer block: x + attn(ln1(x)); x + mlp(ln2(x)), with the
    residual stream in `dtype` and LN statistics in fp32."""
    x = x.to(dtype)
    x = x + attention(
        p["attn"], layer_norm(p["norm_1"], x, eps, out_dtype=dtype),
        num_heads=num_heads, mask=mask, dtype=dtype,
    ).to(dtype)
    return _mlp_halfblock(p, x, eps, dtype)


def _mlp_halfblock(p: Params, x: torch.Tensor, eps: float, dtype) -> torch.Tensor:
    """x + mlp(ln2(x)); one K3 launch (LN prologue, fc1/GELU/fc2, residual
    epilogue) under HIPPOMM_FUSED_BLOCK=1, with the JAX package's gates:
    both biases present, x already in `dtype` (the kernel computes in and
    emits x.dtype), and the K2 shape gate."""
    pm = p["mlp"]
    if pm["fc1"].get("bias") is not None and pm["fc2"].get("bias") is not None and x.dtype == dtype:
        f, d = pm["fc1"]["weight"].shape
        n = math.prod(x.shape[:-1])
        if fm.fused_block_default() and fused_mlp_supported(n, d, f):
            y = fm.fused_ln_mlp_residual(
                x.reshape(n, d), p["norm_2"]["weight"], p["norm_2"]["bias"],
                pm["fc1"]["weight"], pm["fc1"]["bias"], pm["fc2"]["weight"], pm["fc2"]["bias"],
                eps,
            )
            return y.reshape(x.shape)
    return x + mlp(
        pm, layer_norm(p["norm_2"], x, eps, out_dtype=dtype), dtype=dtype, cast_out=True,
    ).to(dtype)


def stacked_blocks(
    p_blocks: List[Params],
    x: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    dtype=torch.bfloat16,
    remat: bool = False,
) -> torch.Tensor:
    """Run a stack of blocks over per-layer params `p_blocks`, a list (the
    JAX lax.scan over stacked leaves). With remat=True each block runs
    under torch.utils.checkpoint, as JAX's jax.checkpoint: it keeps only its
    input for the backward and runs again, through the same kernels, to
    give the rest (memory traded for recompute when training)."""
    x = x.to(dtype)
    for pb in p_blocks:
        if remat:
            x = checkpoint(encoder_block, pb, x, num_heads, mask, eps, dtype, use_reentrant=False)
        else:
            x = encoder_block(pb, x, num_heads, mask, eps, dtype)
    return x


# ---------------------------------------------------------------------------
# Initializers (random-init towers; real checkpoints are a later slice)
# ---------------------------------------------------------------------------


def _uniform(g: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    return (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * scale


def init_linear(g, d_in: int, d_out: int, device, dtype, bias: bool = True) -> Params:
    p = {"weight": _uniform(g, (d_out, d_in), 1.0 / math.sqrt(d_in), device).to(dtype)}
    if bias:
        p["bias"] = torch.zeros((d_out,), device=device)
    return p


def init_layer_norm(d: int, device) -> Params:
    return {"weight": torch.ones((d,), device=device), "bias": torch.zeros((d,), device=device)}


def init_attention(g, d: int, device, dtype, packed: bool = True, bias: bool = True,
                   bias_kv: bool = False) -> Params:
    """The packed torch MultiheadAttention layout (in_proj, optional
    bias_k/bias_v), or with packed=False the separate q/k/v_proj of the
    Whisper/HF layout (bias_kv ignored, as JAX's); bias=False leaves out
    every projection bias."""
    if not packed:
        return {name: init_linear(g, d, d, device, dtype, bias=bias)
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")}
    p = {
        "in_proj": {"weight": _uniform(g, (3 * d, d), 1.0 / math.sqrt(d), device).to(dtype)},
        "out_proj": init_linear(g, d, d, device, dtype, bias=bias),
    }
    if bias:
        p["in_proj"]["bias"] = torch.zeros((3 * d,), device=device)
    if bias_kv:
        p["bias_k"] = 0.02 * torch.randn((1, 1, d), generator=g, device=device)
        p["bias_v"] = 0.02 * torch.randn((1, 1, d), generator=g, device=device)
    return p


def init_block(g, d: int, device, dtype, mlp_ratio: float = 4.0, packed: bool = True,
               bias_kv: bool = False) -> Params:
    hidden = int(d * mlp_ratio)
    return {
        "attn": init_attention(g, d, device, dtype, packed=packed, bias_kv=bias_kv),
        "mlp": {
            "fc1": init_linear(g, d, hidden, device, dtype),
            "fc2": init_linear(g, hidden, d, device, dtype),
        },
        "norm_1": init_layer_norm(d, device),
        "norm_2": init_layer_norm(d, device),
    }
