"""Backward passes of the port's four differentiable kernel wrappers against
the JAX package's custom_vjp backward.

JAX side: `jax.vjp` of flash_mha / flash_mha_bthd / fused_mlp_vjp /
fused_ln_mlp_residual_vjp with their Pallas kernels in interpret mode, as the
JAX package's own tests run them on the CPU. Port side: the wrapper under
autograd on CPU tensors — its plain forward and the autograd Function's
backward (the JAX `_bwd` / `_bthd_bwd` recompute for K1/K4, autograd of the
plain version for K2/K3). One seeded cotangent per case.

Tolerances, as max |port − JAX| over the largest |JAX gradient| of each
input: fp32 1e-5; bf16 2⁻⁶ (two bf16 ulps at that magnitude: each side
rounds every gradient to bf16 once, after fp32 products summed in
different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.ops import flash_attention as jfa
from hippomm_tpu.ops import fused_mlp as jfm
from hippomm_tpu_torch.ops import flash_attention as tfa
from hippomm_tpu_torch.ops import fused_mlp as tfm
from torch_parity import assert_close

_DT = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -6)}


def _randn(rng, shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _compare(request, what, got, want, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert g is not None, f"{what} input {i}: no gradient"
        assert_close(request, g.float().numpy(), w, tol, f"{what}_d{i}", scale=max(np.abs(w).max(), 1e-30))


def _torch_grads(fn, args, g):
    """The gradients of `fn(*args)` against the cotangent g, for the
    arguments that require grad."""
    out = fn(*args)
    out.backward(g)
    return [a.grad for a in args if isinstance(a, torch.Tensor) and a.requires_grad]


@pytest.mark.parametrize("dtype", list(_DT))
@pytest.mark.parametrize("shape", [(2, 3, 17, 17, 80), (1, 2, 33, 40, 64)])
def test_flash_mha_backward_matches_jax(request, dtype, shape):
    """K1: hd 80 (the ImageBind vision head dim, which the JAX wrapper pads
    to its 128 lanes) and a ragged Tq != Tk."""
    jdt, tdt, tol = _DT[dtype]
    b, h, tq, tk, hd = shape
    rng = np.random.default_rng(1)
    q, k, v = _randn(rng, (b, h, tq, hd)), _randn(rng, (b, h, tk, hd)), _randn(rng, (b, h, tk, hd))
    g = _randn(rng, (b, h, tq, hd))
    scale = hd ** -0.5
    _, pull = jax.vjp(lambda q, k, v: jfa.flash_mha(q, k, v, scale, True),
                      *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = pull(jnp.asarray(g, jdt))
    args = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    got = _torch_grads(lambda *a: tfa.flash_mha(*a, scale), args, torch.from_numpy(g).to(tdt))
    assert all(x.dtype == tdt for x in got)
    _compare(request, f"flash_mha_{dtype}", got, want, tol)


@pytest.mark.parametrize("dtype", list(_DT))
def test_flash_mha_bthd_backward_on_strided_views_matches_jax(request, dtype):
    """K4 on q/k/v slices of one packed (B, T, 3D) projection, as the
    attention route hands them: the gradients come back in the views'
    shapes and autograd scatters them into the one qkv gradient."""
    jdt, tdt, tol = _DT[dtype]
    b, t, h, hd = 2, 17, 4, 80
    d = h * hd
    rng = np.random.default_rng(2)
    qkv, g = _randn(rng, (b, t, 3 * d)), _randn(rng, (b, t, h, hd))
    scale = hd ** -0.5

    def jax_fn(x):
        q, k, v = (x[..., i * d:(i + 1) * d].reshape(b, t, h, hd) for i in range(3))
        return jfa.flash_mha_bthd(q, k, v, scale, True)

    _, pull = jax.vjp(jax_fn, jnp.asarray(qkv, jdt))
    want = pull(jnp.asarray(g, jdt))

    x = torch.from_numpy(qkv).to(tdt).requires_grad_()
    q, k, v = (x[..., i * d:(i + 1) * d].reshape(b, t, h, hd) for i in range(3))
    assert q.stride() == (t * 3 * d, 3 * d, hd, 1)  # views of qkv, no copies
    tfa.flash_mha_bthd(q, k, v, scale).backward(torch.from_numpy(g).to(tdt))
    assert x.grad.dtype == tdt
    _compare(request, f"flash_mha_bthd_{dtype}", [x.grad], want, tol)


def _mlp_operands(rng, n, d, f):
    return (_randn(rng, (n, d)), 1.0 + _randn(rng, (d,), 0.1), _randn(rng, (d,), 0.1),
            _randn(rng, (f, d), d ** -0.5), _randn(rng, (f,), 0.1),
            _randn(rng, (d, f), f ** -0.5), _randn(rng, (d,), 0.1))


@pytest.mark.parametrize("dtype", list(_DT))
@pytest.mark.parametrize("ln", [False, True], ids=["fused_mlp", "fused_ln_mlp_residual"])
def test_mlp_backward_with_fp32_masters_matches_jax(request, dtype, ln):
    """K2 (ln False) and K3 with x in the compute dtype and every weight,
    bias and LN parameter an fp32 master, as training passes them: the
    masters' gradients are fp32 (their cast to x.dtype is inside the
    differentiated function, as in the JAX pullback)."""
    jdt, tdt, tol = _DT[dtype]
    n, d, f = 24, 128, 256
    rng = np.random.default_rng(3 + ln)
    x, gamma, beta, w1, b1, w2, b2 = _mlp_operands(rng, n, d, f)
    g = _randn(rng, (n, d))
    params = (gamma, beta, w1, b1, w2, b2) if ln else (w1, b1, w2, b2)
    if ln:
        jax_fn = lambda *a: jfm.fused_ln_mlp_residual_vjp(*a, 1e-6, True)  # noqa: E731
        port_fn = lambda *a: tfm.fused_ln_mlp_residual(*a, 1e-6)  # noqa: E731
    else:
        jax_fn = lambda *a: jfm.fused_mlp_vjp(*a, True)  # noqa: E731
        port_fn = tfm.fused_mlp
    _, pull = jax.vjp(jax_fn, jnp.asarray(x, jdt), *(jnp.asarray(p) for p in params))
    want = pull(jnp.asarray(g, jdt))
    args = [torch.from_numpy(x).to(tdt).requires_grad_()] + [torch.from_numpy(p).requires_grad_() for p in params]
    got = _torch_grads(port_fn, args, torch.from_numpy(g).to(tdt))
    assert got[0].dtype == tdt and all(t.dtype == torch.float32 for t in got[1:])
    assert [w.dtype for w in want[1:]] == [jnp.float32] * len(params)
    _compare(request, f"{'fused_ln_mlp_residual' if ln else 'fused_mlp'}_{dtype}", got, want, tol)


def test_wrappers_without_grad_return_no_graph():
    """Under no_grad (inference), or with no operand that requires grad, the
    wrappers take their plain forward with no autograd node."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_randn(rng, (1, 2, 9, 16))).requires_grad_()
    with torch.no_grad():
        assert tfa.flash_mha(q, q, q, 0.25).grad_fn is None
    x, gamma, beta, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _mlp_operands(rng, 8, 128, 128))
    assert tfm.fused_mlp(x, w1, b1, w2, b2).grad_fn is None
    assert tfm.fused_ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2).grad_fn is None
    assert tfm.fused_mlp(x, w1.requires_grad_(), b1, w2, b2).grad_fn is not None
