"""Parity of the port's K4 (attention in the native (B, T, H, hd) layout)
and of the transpose-free route of `attention()` against the JAX package.

On the CPU the K4 wrapper takes its plain PyTorch version; that is held to
the JAX Pallas kernel run in interpret mode, the routing gate to the JAX
gate, and the flagged `attention()` to the JAX one with the same flag on
(its kernels through interpret-mode spies). The CUDA kernel is held to the
plain version in test_torch_cuda.py."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.models import layers as jl
from hippomm_tpu.ops import flash_attention as jfa
from hippomm_tpu_torch.models import layers as tl
from hippomm_tpu_torch.ops import flash_attention as tfa
from torch_parity import assert_close


def _to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(dtype)


@pytest.fixture
def jax_bthd_on(monkeypatch):
    """The JAX attention with HIPPOMM_FLASH_BTHD on (which it reads only
    beside its flash route), both kernels in interpret mode; yields the q
    shapes the BTHD kernel was called with."""
    calls = []
    real_bthd, real_flash = jfa.flash_mha_bthd, jfa.flash_mha

    def bthd_spy(q, k, v, scale, interpret=False):
        calls.append(tuple(q.shape))
        return real_bthd(q, k, v, scale, True)

    monkeypatch.setattr(jfa, "flash_default", lambda: True)
    monkeypatch.setattr(jfa, "bthd_default", lambda: True)
    monkeypatch.setattr(jfa, "flash_mha_bthd", bthd_spy)
    monkeypatch.setattr(jfa, "flash_mha", lambda q, k, v, s, interpret=False, opt=False:
                        real_flash(q, k, v, s, True, opt))
    return calls


@pytest.fixture
def torch_bthd_on(monkeypatch):
    calls = []
    real = tfa.flash_mha_bthd
    monkeypatch.setattr(tfa, "bthd_default", lambda: True)
    monkeypatch.setattr(tfa, "flash_mha_bthd",
                        lambda q, *a: calls.append(tuple(q.shape)) or real(q, *a))
    return calls


# (B, Tq, Tk, H, hd): the ViT-H vision head layout, a bias_kv-style ragged
# pair (Tk = Tq + 1), a short one
_SHAPES = [(1, 257, 257, 16, 80), (2, 229, 230, 4, 64), (2, 33, 33, 8, 16)]


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_flash_bthd_ref_matches_jax(request, shape, dtype, tol):
    b, tq, tk, h, hd = shape
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, t, h, hd)).astype(np.float32) for t in (tq, tk, tk))
    scale = 1.0 / np.sqrt(hd)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jfa.flash_mha_bthd(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), float(scale), True)
    got = tfa.flash_mha_bthd(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), float(scale))
    assert got.dtype == tdt and got.shape == (b, tq, h, hd)
    assert_close(request, got.float().numpy(), np.asarray(want.astype(jnp.float32)), tol)


def test_flash_bthd_wrapper_cpu_is_plain_and_uncounted():
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((2, 17, 3 * 64)).astype(np.float32))
    q, k, v = (qkv[..., i * 64 : (i + 1) * 64].reshape(2, 17, 4, 16) for i in range(3))
    before = tfa.flash_mha_bthd.launches
    out = tfa.flash_mha_bthd(q, k, v, 0.25)
    assert tfa.flash_mha_bthd.launches == before
    assert torch.equal(out, tfa.flash_mha_bthd_ref(q, k, v, 0.25))
    assert torch.allclose(out, tfa.flash_mha(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), 0.25).transpose(1, 2))
    with pytest.raises(ValueError, match="mismatch"):
        tfa.flash_mha_bthd(q, k[:, :, :2], v, 0.25)


def test_bthd_supported_matches_jax():
    grid = itertools.product((1, 32), (4, 8, 12, 16, 20), (33, 257, 1500), (64, 80))
    seen = set()
    for b, h, t, hd in grid:
        got = tfa.bthd_supported(b, h, t, t + 1, hd)
        assert got == jfa.bthd_supported(b, h, t, t + 1, hd)
        seen.add(got)
    assert seen == {True, False}
    assert tfa.bthd_supported(32, 16, 257, 257, 80)  # the vision tower
    assert not tfa.bthd_supported(96, 12, 229, 230, 64)  # the audio trunk keeps K1
    assert not tfa.bthd_supported(4, 20, 1500, 1500, 64)  # Whisper keeps K1


def test_bthd_default_flag(monkeypatch):
    for value, want in ((None, False), ("1", True), ("true", True), ("0", False), ("auto", False)):
        if value is None:
            monkeypatch.delenv("HIPPOMM_FLASH_BTHD", raising=False)
        else:
            monkeypatch.setenv("HIPPOMM_FLASH_BTHD", value)
        tfa.bthd_default.cache_clear()
        jfa.bthd_default.cache_clear()
        assert tfa.bthd_default() is want is jfa.bthd_default()
    tfa.bthd_default.cache_clear()
    jfa.bthd_default.cache_clear()


@pytest.mark.parametrize("kind", ["packed", "bias_kv", "separate"])
def test_attention_bthd_flag_on_matches_jax(request, jax_bthd_on, torch_bthd_on, kind):
    d, heads, t = 64, 8, 33
    if kind == "separate":  # Whisper-style q/k/v projections
        p = jl.init_attention(jax.random.PRNGKey(5), d, packed=False)
    else:
        p = jl.init_attention(jax.random.PRNGKey(5), d, bias_kv=kind == "bias_kv")
    rng = np.random.default_rng(6)
    p = jax.tree.map(lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape), jnp.float32), p)
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    want = np.asarray(jl.attention(p, jnp.asarray(x), num_heads=heads, dtype=jnp.float32))
    got = tl.attention(_to_torch(p), torch.from_numpy(x), num_heads=heads, dtype=torch.float32)
    assert jax_bthd_on == torch_bthd_on == [(2, t, heads, d // heads)]
    assert_close(request, got.numpy(), want, 1e-5)


def test_attention_bthd_gate_keeps_k1_for_unsupported_heads(request, jax_bthd_on, torch_bthd_on):
    """H = 12 (the audio trunk's head count) fails the gate in both
    packages: the flagged attention stays on K1."""
    d, heads = 96, 12
    p = jl.init_attention(jax.random.PRNGKey(7), d)
    x = np.random.default_rng(8).standard_normal((2, 9, d)).astype(np.float32)
    want = np.asarray(jl.attention(p, jnp.asarray(x), num_heads=heads, dtype=jnp.float32))
    got = tl.attention(_to_torch(p), torch.from_numpy(x), num_heads=heads, dtype=torch.float32)
    assert jax_bthd_on == torch_bthd_on == []
    assert_close(request, got.numpy(), want, 1e-5)
