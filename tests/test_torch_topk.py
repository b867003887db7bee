"""Parity of the port's K5 (exact cosine top-k) and top-k search functions
against the JAX package, on the CPU.

K5's plain version is held to the Pallas `_topk_kernel` run in interpret
mode (no Mosaic on the CPU) and, for tie order, to `top_k_cosine`
(lax.top_k); `top_k_cosine_prenorm` to its JAX counterpart. The CUDA kernel is
held to the plain version in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.ops import similarity as jsim
from hippomm_tpu.ops.pallas_topk import pallas_top_k_cosine
from hippomm_tpu_torch.ops import similarity as tsim
from hippomm_tpu_torch.ops import topk as ttk
from torch_parity import assert_close


@pytest.mark.parametrize(
    "n,d,k,scale,self_row",
    [
        (1000, 256, 8, 1.0, None),  # the three shapes of test_pallas_topk.py
        (130, 64, 5, 0.01, None),
        (64, 128, 3, 1.0, 17),
        (300, 128, 16, 1.0, None),  # partial last tile of the TPU kernel
        (257, 64, 1, 1.0, None),
        (1000, 64, 128, 1.0, None),
    ],
)
def test_topk_ref_matches_pallas_interpret(request, n, d, k, scale, self_row):
    rng = np.random.default_rng(n + k)
    f = (rng.standard_normal((n, d)) * scale).astype(np.float32)
    q = f[self_row] if self_row is not None else rng.standard_normal(d).astype(np.float32)
    want_v, want_i = pallas_top_k_cosine(jnp.asarray(q), jnp.asarray(f), k=k, tile_n=128, interpret=True)
    got_v, got_i = ttk.top_k_cosine_kernel(torch.from_numpy(q), torch.from_numpy(f), k)
    assert got_i.dtype == torch.int32 and got_v.shape == (k,)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert_close(request, got_v.numpy(), np.asarray(want_v), 1e-6)
    if self_row is not None:
        assert int(got_i[0]) == self_row and float(got_v[0]) > 0.999


@pytest.mark.parametrize("d,offset", [(6, 0), (1026, 0), (1024, 1)])
def test_topk_ref_any_width_and_offset_matches_pallas_interpret(request, d, offset):
    """Widths that are not a multiple of 4 (6, 1026) and a store view one
    element into its buffer, which the CUDA kernel takes without a copy:
    the plain version against the Pallas kernel (any D; it pads only N),
    from one numpy seed."""
    n, k = 700, 20
    rng = np.random.default_rng(d + offset)
    flat = rng.standard_normal(n * d + offset).astype(np.float32)
    q = rng.standard_normal(d).astype(np.float32)
    f = torch.from_numpy(flat)[offset:].view(n, d)
    assert f.storage_offset() == offset
    want_v, want_i = pallas_top_k_cosine(jnp.asarray(q), jnp.asarray(f.numpy()), k=k, tile_n=128,
                                         interpret=True)
    got_v, got_i = ttk.top_k_cosine_kernel(torch.from_numpy(q), f, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert_close(request, got_v.numpy(), np.asarray(want_v), 1e-6)


def test_topk_ties_follow_lax_top_k():
    """Duplicated rows tie exactly (one-hot rows: each similarity is one
    product, so every summation order gives the same value). Equal values
    come lower row first, as lax.top_k orders them in top_k_cosine."""
    rng = np.random.default_rng(9)
    d = 32
    base = np.zeros((10, d), np.float32)
    base[np.arange(10), rng.permutation(d)[:10]] = rng.uniform(0.5, 2.0, 10)
    f = np.tile(base, (40, 1))  # 400 rows, each of 10 values 40 times
    q = rng.standard_normal(d).astype(np.float32)
    for k in (1, 37, 100, 128):
        want_v, want_i = jsim.top_k_cosine(jnp.asarray(q), jnp.asarray(f), k)
        got_v, got_i = ttk.top_k_cosine_kernel(torch.from_numpy(q), torch.from_numpy(f), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6)


def test_topk_wrapper_on_cpu_is_plain_and_uncounted():
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.standard_normal((50, 16)).astype(np.float32))
    before = ttk.top_k_cosine_kernel.launches
    got = ttk.top_k_cosine_kernel(f[3], f, 7)
    assert ttk.top_k_cosine_kernel.launches == before
    want = ttk.top_k_cosine_ref(f[3], f, 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="exceeds kernel contract"):
        ttk.top_k_cosine_kernel(f[0], f.repeat(3, 1), 129)
    with pytest.raises(ValueError, match="must be in"):
        ttk.top_k_cosine_kernel(f[0], f, 51)
    with pytest.raises(ValueError, match="query"):
        ttk.top_k_cosine_kernel(f[0, :8], f, 5)


@pytest.mark.parametrize("batched", [False, True])
def test_top_k_cosine_prenorm_matches_jax(request, batched):
    rng = np.random.default_rng(11)
    f = rng.standard_normal((500, 64)).astype(np.float32)
    q = rng.standard_normal((4, 64) if batched else (64,)).astype(np.float32)
    unit = f / np.linalg.norm(f, axis=1, keepdims=True)
    k = 20
    want_v, want_i = jsim.top_k_cosine_prenorm(jnp.asarray(q), jnp.asarray(unit), k)
    got_v, got_i = tsim.top_k_cosine_prenorm(torch.from_numpy(q), torch.from_numpy(unit), k)
    assert got_v.shape == tuple(want_v.shape)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert_close(request, got_v.numpy(), np.asarray(want_v), 1e-6)
