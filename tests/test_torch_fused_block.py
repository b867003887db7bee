"""Parity of the port's K3 (LN → MLP → residual half-block) and of the
fused-block route of the encoder block against the JAX package.

On the CPU the K3 wrapper takes its plain PyTorch version; that is held to
the JAX Pallas kernel run in interpret mode and to the JAX reference, and
the flagged routes of `_mlp_halfblock` / `encoder_block` to the JAX ones
with the same flag on (the JAX kernel through an interpret-mode spy, as the
JAX package's own tests run it). The CUDA kernel is held to the plain
version in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.models import layers as jl
from hippomm_tpu.ops import fused_mlp as jfm
from hippomm_tpu_torch.models import layers as tl
from hippomm_tpu_torch.ops import fused_mlp as tfm
from torch_parity import assert_close


def _to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(dtype)


def _operands(n, d, f, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, d)).astype(np.float32),
        (1.0 + 0.1 * rng.standard_normal((d,))).astype(np.float32),
        (0.1 * rng.standard_normal((d,))).astype(np.float32),
        (rng.standard_normal((f, d)) / np.sqrt(d)).astype(np.float32),
        (0.1 * rng.standard_normal((f,))).astype(np.float32),
        (rng.standard_normal((d, f)) / np.sqrt(f)).astype(np.float32),
        (0.1 * rng.standard_normal((d,))).astype(np.float32),
    )


@pytest.fixture
def jax_fused_block_on(monkeypatch):
    """The JAX half-block route with HIPPOMM_FUSED_BLOCK on, its Pallas
    kernel in interpret mode (no Mosaic on the CPU); yields the x shapes it
    was called with."""
    calls = []
    real = jfm.fused_ln_mlp_residual

    def spy(x, g, b, w1, b1, w2, b2, eps=1e-6, interpret=False):
        calls.append(tuple(x.shape))
        return real(x, g, b, w1, b1, w2, b2, eps, True)

    monkeypatch.setattr(jfm, "fused_ln_mlp_residual_vjp", spy)
    monkeypatch.setattr(jfm, "fused_block_default", lambda: True)
    return calls


@pytest.fixture
def torch_fused_block_on(monkeypatch):
    calls = []
    real = tfm.fused_ln_mlp_residual
    monkeypatch.setattr(tfm, "fused_block_default", lambda: True)
    monkeypatch.setattr(tfm, "fused_ln_mlp_residual",
                        lambda x, *a: calls.append(tuple(x.shape)) or real(x, *a))
    return calls


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_ln_mlp_residual_ref_matches_jax(request, impl, dtype, tol):
    n, d, f = 40, 128, 512
    args = _operands(n, d, f, 0)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, *jrest = (jnp.asarray(a) for a in args)
    jx = jx.astype(jdt)
    if impl == "ref":
        want = jfm._ref_ln_mlp_residual(jx, *jrest, 1e-6)
    else:
        want = jfm.fused_ln_mlp_residual(jx, *jrest, 1e-6, True)
    x, *rest = (torch.from_numpy(a) for a in args)
    got = tfm.fused_ln_mlp_residual(x.to(tdt), *rest, 1e-6)
    assert got.dtype == tdt and got.shape == (n, d)
    assert_close(request, got.float().numpy(), np.asarray(want.astype(jnp.float32)), tol)


def test_ln_mlp_residual_wrapper_cpu_is_plain_and_uncounted():
    x, *rest = (torch.from_numpy(a) for a in _operands(45, 128, 256, 1))
    before = tfm.fused_ln_mlp_residual.launches
    out = tfm.fused_ln_mlp_residual(x, *rest, 1e-5)
    assert tfm.fused_ln_mlp_residual.launches == before
    assert torch.equal(out, tfm.fused_ln_mlp_residual_ref(x, *rest, 1e-5))
    with pytest.raises(ValueError, match="shapes"):
        tfm.fused_ln_mlp_residual(x, rest[0][:64], *rest[1:], 1e-5)


def test_fused_block_default_flag(monkeypatch):
    for value, want in ((None, False), ("1", True), ("on", True), ("0", False), ("auto", False)):
        if value is None:
            monkeypatch.delenv("HIPPOMM_FUSED_BLOCK", raising=False)
        else:
            monkeypatch.setenv("HIPPOMM_FUSED_BLOCK", value)
        tfm.fused_block_default.cache_clear()
        jfm.fused_block_default.cache_clear()
        assert tfm.fused_block_default() is want is jfm.fused_block_default()
    tfm.fused_block_default.cache_clear()
    jfm.fused_block_default.cache_clear()


def test_mlp_halfblock_flag_on_matches_jax(request, jax_fused_block_on, torch_fused_block_on):
    d, f = 128, 512
    p = jl.init_block(jax.random.PRNGKey(16), d)
    rng = np.random.default_rng(17)
    p = jax.tree.map(lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape), jnp.float32), p)
    p = {"mlp": p["mlp"], "norm_2": p["norm_2"]}
    x = rng.standard_normal((2, 21, d)).astype(np.float32)
    want = np.asarray(jl._mlp_halfblock(p, jnp.asarray(x), 1e-6, jnp.float32))
    got = tl._mlp_halfblock(_to_torch(p), torch.from_numpy(x), 1e-6, torch.float32)
    assert jax_fused_block_on == torch_fused_block_on == [(42, d)]
    assert_close(request, got.numpy(), want, 1e-5)
    # the gates: x in another dtype than `dtype`, or the flag off, take the
    # unfused route in both packages
    tl._mlp_halfblock(_to_torch(p), torch.from_numpy(x).double(), 1e-6, torch.float32)
    assert torch_fused_block_on == [(42, d)]


@pytest.mark.parametrize("bias_kv", [False, True])
def test_encoder_block_flag_on_matches_jax(request, jax_fused_block_on, torch_fused_block_on, bias_kv):
    d, heads, t, bsz = 128, 4, 21, 2
    p = jl.init_block(jax.random.PRNGKey(3), d, bias_kv=bias_kv)
    rng = np.random.default_rng(4)
    p = jax.tree.map(lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape), jnp.float32), p)
    x = rng.standard_normal((bsz, t, d)).astype(np.float32)
    want = np.asarray(jl.encoder_block(p, jnp.asarray(x), heads, dtype=jnp.float32))
    got = tl.encoder_block(_to_torch(p), torch.from_numpy(x), heads, dtype=torch.float32)
    assert jax_fused_block_on == torch_fused_block_on == [(bsz * t, d)]
    assert_close(request, got.numpy(), want, 1e-5, scale=max(1.0, float(np.abs(want).max())))
