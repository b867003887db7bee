"""Parity of the PyTorch port's two kernels (K1 flash attention, K2 fused
MLP) and of the layers around them, against the JAX package.

On the CPU each wrapper takes its plain PyTorch version (the CUDA kernels
need the card); those plain versions are held to the JAX Pallas kernels run
in interpret mode and to the JAX einsum / unfused paths. The CUDA kernels
themselves are held to the plain versions in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.models import layers as jl
from hippomm_tpu.ops import flash_attention as jfa
from hippomm_tpu.ops import fused_mlp as jfm
from hippomm_tpu_torch.models import layers as tl
from hippomm_tpu_torch.ops import flash_attention as tfa
from hippomm_tpu_torch.ops import fused_mlp as tfm
from torch_parity import assert_close


def _to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(dtype)


def _jax_einsum_attention(q, k, v, scale, dt):
    """The mask-free einsum path of hippomm_tpu.models.layers.attention."""
    logits = jnp.einsum("bhqd,bhkd->bhqk", q.astype(dt), k.astype(dt),
                        preferred_element_type=jnp.float32) * scale
    w = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", w.astype(dt), v.astype(dt),
                      preferred_element_type=jnp.float32).astype(dt)


# (B, H, Tq, Tk, hd): ViT-H vision tokens, the audio trunk's bias_kv shape
# (229 queries, 230 keys), and a short ragged sequence
_ATTN_SHAPES = [(1, 2, 257, 257, 80), (1, 2, 229, 230, 64), (1, 1, 33, 33, 64)]


@pytest.mark.parametrize("shape", _ATTN_SHAPES)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_flash_ref_matches_jax(request, shape, dtype, tol):
    b, h, tq, tk, hd = shape
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, h, t, hd)).astype(np.float32) for t in (tq, tk, tk))
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    scale = 1.0 / np.sqrt(hd)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    kern = np.asarray(jfa.flash_mha(jq, jk, jv, float(scale), True).astype(jnp.float32))
    ein = np.asarray(_jax_einsum_attention(jq, jk, jv, scale, jdt).astype(jnp.float32))
    tq_, tk_, tv_ = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out = tfa.flash_mha(tq_, tk_, tv_, float(scale))
    assert out.dtype == tdt and out.shape == (b, h, tq, hd)
    got = out.float().numpy()
    assert_close(request, got, kern, tol, "vs_pallas_interpret")
    assert_close(request, got, ein, tol, "vs_einsum")


def test_flash_wrapper_cpu_is_plain_and_uncounted():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 17, 16)).astype(np.float32))
               for _ in range(3))
    before = tfa.flash_mha.launches
    out = tfa.flash_mha(q, k, v, 0.25)
    assert tfa.flash_mha.launches == before
    assert torch.equal(out, tfa.flash_mha_ref(q, k, v, 0.25))
    with pytest.raises(ValueError):
        tfa.flash_mha(q, k[:, :2], v, 0.25)


def test_flash_gate_matches_jax():
    for tq, tk, hd in [(257, 257, 80), (229, 230, 64), (1500, 1500, 64), (10, 2049, 64),
                       (10, 10, 129), (10, 2048, 128)]:
        assert tfa.flash_supported(tq, tk, hd) == jfa.flash_supported(tq, tk, hd)


@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_fused_mlp_ref_matches_jax(request, impl):
    n, d, f = 40, 128, 512
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w1 = (rng.standard_normal((f, d)) / np.sqrt(d)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((f,))).astype(np.float32)
    w2 = (rng.standard_normal((d, f)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((d,))).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    if impl == "ref":
        want = jfm._ref_mlp(*args)
    else:  # the Pallas kernel with its Abramowitz–Stegun erf body
        want = jfm.fused_mlp(*args, interpret=True, gelu_impl="as")
    got = tfm.fused_mlp(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)))
    assert got.dtype == torch.float32
    assert_close(request, got.numpy(), want, 1e-5)


def test_fused_mlp_gate_matches_jax_within_kernel_bound():
    """The port's gate is the JAX gate, and every shape it admits has a tile
    plan: D 1408 (wider than any tower) included, nothing bounds D."""
    for n, d, f in [(8224, 1280, 5120), (21984, 768, 3072), (7, 128, 512), (40, 96, 512),
                    (40, 128, 200), (40, 1024, 4096), (64, 1408, 5632), (8, 128, 128)]:
        assert tfm.fused_mlp_supported(n, d, f) == jfm.fused_mlp_supported(n, d, f)
        if tfm.fused_mlp_supported(n, d, f):
            plan = tfm._plan(n, d, f)
            assert f % plan.bn1 == 0 and d % plan.bn2 == 0 and (f // 64) % plan.splits == 0
    assert not hasattr(tfm, "_MAX_D")


@pytest.mark.parametrize("n,d,f", [(8, 128, 128), (77, 1024, 4096), (616, 1024, 4096),
                                   (6000, 1280, 5120), (8224, 1280, 5120), (21984, 768, 3072),
                                   (64, 1408, 5632)])
def test_plan_tiles_cover_every_output_once(n, d, f):
    """Each GEMM pass of `_plan`'s plan, walked in the kernel's tile order:
    per K slice the tiles cover every output row and column exactly once;
    the slices are whole 64-wide K steps that add up to K; the text tower's
    shapes start at least 64 blocks in each pass."""
    plan = tfm._plan(n, d, f)
    passes = ((f, d, plan.bn1, 1), (d, f, plan.bn2, plan.splits))  # (cols, K, tile width, slices)
    for cols, k, bn, splits in passes:
        tiles = tfm._pass_tiles(n, cols, k, bn, splits)
        assert len(tiles) == len(set(tiles))
        slices = sorted({(k0, k1) for _, _, k0, k1 in tiles})
        assert len(slices) == splits and slices[0][0] == 0 and slices[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        assert all((k1 - k0) % 64 == 0 and k1 > k0 for k0, k1 in slices)
        for k0, k1 in slices:
            rows = np.zeros(n, np.int32)
            cols_seen = np.zeros(cols, np.int32)
            corners = [(r0, c0) for r0, c0, a, b in tiles if (a, b) == (k0, k1)]
            for r0 in sorted({r0 for r0, _ in corners}):
                rows[r0:r0 + 128] += 1
            for c0 in sorted({c0 for _, c0 in corners}):
                assert c0 + bn <= cols
                cols_seen[c0:c0 + bn] += 1
            assert (rows == 1).all() and (cols_seen == 1).all()
            # the corners are the full grid of row bands × column tiles
            assert len(corners) == len({r0 for r0, _ in corners}) * len({c0 for _, c0 in corners})
        if (d, f) == (1024, 4096):  # the text tower
            assert min(len(tiles), 132) >= 64
    assert tfm.kernels_per_call(plan, False) == 2 + (plan.splits > 1)
    assert tfm.kernels_per_call(plan, True) == 3 + (plan.splits > 1)


@pytest.mark.parametrize("n,d,f", [(8224, 1280, 5120), (21984, 768, 3072), (6000, 1280, 5120),
                                   (77, 1024, 4096), (616, 1024, 4096), (4112, 1280, 5120),
                                   (1232, 1024, 4096), (2056, 1280, 2560), (616, 1024, 2048),
                                   (8, 128, 128), (64, 1408, 5632), (229, 768, 3072),
                                   (45, 768, 3072), (1500, 1280, 5120)])
def test_plan_f32_tiles_cover_every_output_once(n, d, f):
    """The fp32 kernels' plan (csrc/fused_mlp_f32.cu) at the path shapes (the
    ingest, Whisper, text and training shapes, phase 12's and an audio
    shard's) and the gate's edges: in each pass the tiles of each K slice
    cover every output row and column once, the slices are whole 32-wide
    K steps that add up to K, and each pass has a wave of 132 tiles where
    the plan's narrowest pass 1 tile and its slices allow it; the ingest
    and training shapes take 128 × 128 tiles and no split; kernels_per_call
    counts the A split (K2's own kernel, K3's LN) and the split-K reduce."""
    plan = tfm._plan_f32(n, d, f)
    assert plan.bn1 in (128, 32) and plan.bn2 == 128
    passes = ((f, d, plan.bn1, 1), (d, f, plan.bn2, plan.splits))  # (cols, K, tile width, slices)
    for i, (cols, k, bn, splits) in enumerate(passes):
        tiles = tfm._pass_tiles(n, cols, k, bn, splits)
        assert len(tiles) == len(set(tiles))
        slices = sorted({(k0, k1) for _, _, k0, k1 in tiles})
        assert len(slices) == splits and slices[0][0] == 0 and slices[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        assert all((k1 - k0) % 32 == 0 and k1 > k0 for k0, k1 in slices)
        for k0, k1 in slices:
            rows = np.zeros(-(-n // 128) * 128, np.int32)
            cols_seen = np.zeros(cols, np.int32)
            corners = [(r0, c0) for r0, c0, a, b in tiles if (a, b) == (k0, k1)]
            assert len(corners) == len({r0 for r0, _ in corners}) * len({c0 for _, c0 in corners})
            for r0 in sorted({r0 for r0, _ in corners}):
                rows[r0:r0 + 128] += 1
            for c0 in sorted({c0 for _, c0 in corners}):
                assert c0 + bn <= cols
                cols_seen[c0:c0 + bn] += 1
            assert (rows == 1).all() and (cols_seen == 1).all() and len(rows) - 128 < n
        # a wave of the card's 132 SMs, unless pass 1 is at its narrowest or
        # pass 2's slices cannot halve again
        narrowest = bn == 32 if i == 0 else (k // 32) % (2 * splits) != 0
        assert len(tiles) >= 132 or narrowest
    if n >= 4112:  # the ingest and training shapes: full tiles, no split
        assert plan == (128, 128, 1)
    # K3's LN row kernel, or K2's x split, then two passes and the reduce
    assert tfm.kernels_per_call(plan, False, f32=True) == 3 + (plan.splits > 1)
    assert tfm.kernels_per_call(plan, True, f32=True) == 3 + (plan.splits > 1)


@pytest.mark.parametrize("d,heads", [(128, 4), (1408, 11)])
def test_layers_route_by_the_jax_gates_only(monkeypatch, d, heads):
    """fp32 and D 1408 reach the kernel wrappers just as bf16 and D 128 do;
    only the JAX shape gates decide."""
    calls = []
    for mod, name in ((tl, "flash_mha"), (tl, "fused_mlp")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    p = tl.init_block(torch.Generator().manual_seed(0), d, "cpu", torch.float32)
    x = torch.randn((2, 5, d), generator=torch.Generator().manual_seed(1))
    out = tl.encoder_block(p, x, heads, dtype=torch.float32)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert calls == ["flash_mha", "fused_mlp"]


@pytest.mark.parametrize("bias_kv", [False, True])
def test_encoder_block_matches_jax(request, bias_kv):
    d, heads, t, bsz = 64, 4, 21, 2
    p = jl.init_block(jax.random.PRNGKey(3), d, bias_kv=bias_kv)
    # non-trivial biases and norms so every term is exercised
    rng = np.random.default_rng(4)
    p = jax.tree.map(lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape), jnp.float32), p)
    x = np.random.default_rng(5).standard_normal((bsz, t, d)).astype(np.float32)
    want = np.asarray(jl.encoder_block(p, jnp.asarray(x), heads, dtype=jnp.float32))
    got = tl.encoder_block(_to_torch(p), torch.from_numpy(x), heads, dtype=torch.float32)
    assert_close(request, got.numpy(), want, 1e-5, scale=max(1.0, float(np.abs(want).max())))


def test_attention_separate_projections_and_mask_match_jax(request):
    d, heads, t = 32, 4, 9
    p = jl.init_attention(jax.random.PRNGKey(6), d, packed=False)
    x = np.random.default_rng(7).standard_normal((2, t, d)).astype(np.float32)
    mask = np.triu(np.full((t, t), -np.inf, np.float32), k=1)
    want = np.asarray(jl.attention(p, jnp.asarray(x), num_heads=heads, mask=jnp.asarray(mask),
                                   dtype=jnp.float32))
    got = tl.attention(_to_torch(p), torch.from_numpy(x), num_heads=heads,
                       mask=torch.from_numpy(mask), dtype=torch.float32)
    assert_close(request, got.numpy(), want, 1e-5)


def test_mlp_cast_out_routes_fused_and_matches_unfused(request):
    d = 128
    p = jl.init_block(jax.random.PRNGKey(8), d)["mlp"]
    x = np.random.default_rng(9).standard_normal((3, 12, d)).astype(np.float32)
    want = np.asarray(jl.mlp(p, jnp.asarray(x), dtype=jnp.float32))
    got = tl.mlp(_to_torch(p), torch.from_numpy(x), dtype=torch.float32, cast_out=True)
    assert got.shape == (3, 12, d)
    assert_close(request, got.numpy(), want, 1e-5)


def _leaves(tree):
    return [leaf for v in tree.values() for leaf in (_leaves(v) if isinstance(v, dict) else [v])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_blocks_remat_matches_and_keeps_gradients(request, dtype):
    """stacked_blocks(remat=True): the output and every autograd gradient
    (input and parameters) equal to remat=False; in fp32 the forward within
    1e-5 of JAX's stacked_blocks(remat=True)."""
    d, heads, t, bsz, depth = 128, 4, 17, 2, 3
    rng = np.random.default_rng(14)
    blocks = [jax.tree.map(lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape), jnp.float32),
                           jl.init_block(jax.random.PRNGKey(20 + i), d)) for i in range(depth)]
    x = rng.standard_normal((bsz, t, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    runs = {}
    for remat in (False, True):
        params = [_to_torch(p) for p in blocks]
        leaves = [leaf for p in params for leaf in _leaves(p)]
        for leaf in leaves:
            leaf.requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        out = tl.stacked_blocks(params, xt, heads, dtype=tdt, remat=remat)
        out.float().square().sum().backward()
        runs[remat] = (out.detach(), [xt.grad] + [leaf.grad for leaf in leaves])
    (out0, g0), (out1, g1) = runs[False], runs[True]
    assert out0.dtype == tdt and torch.equal(out0, out1)
    assert len(g0) == len(g1) == 1 + depth * 12
    for a, b in zip(g0, g1):
        assert a is not None and torch.equal(a, b)
    if dtype == "float32":
        want = np.asarray(jl.stacked_blocks(jl.stack_block_params(blocks), jnp.asarray(x), heads,
                                            dtype=jnp.float32, remat=True))
        assert_close(request, out1.numpy(), want, 1e-5, scale=max(1.0, float(np.abs(want).max())))


def test_stacked_blocks_remat_recomputes_through_the_wrappers(monkeypatch):
    """Under remat the backward runs each block's forward again through the
    K1 and K2 wrappers (their autograd Functions), never around them."""
    calls = []
    for name in ("flash_mha", "fused_mlp"):
        real = getattr(tl, name)
        monkeypatch.setattr(tl, name, lambda *a, _r=real, _n=name: calls.append((_n, torch.is_grad_enabled()))
                            or _r(*a))
    d, heads, depth = 128, 4, 2
    g = torch.Generator().manual_seed(2)
    params = [tl.init_block(g, d, "cpu", torch.float32) for _ in range(depth)]
    for p in params:
        p["mlp"]["fc1"]["weight"].requires_grad_(True)
    x = torch.randn((2, 9, d), generator=g, requires_grad=True)
    for remat, want in ((False, 2 * depth), (True, 4 * depth)):
        calls.clear()
        tl.stacked_blocks(params, x, heads, dtype=torch.float32, remat=remat).sum().backward()
        assert len(calls) == want and all(grad for _, grad in calls), (remat, calls)
        assert [n for n, _ in calls[:2]] == ["flash_mha", "fused_mlp"]


@pytest.mark.parametrize("packed,bias", [(False, True), (False, False), (True, False)])
def test_init_block_layouts_match_jax(request, packed, bias):
    """init_attention(packed=, bias=) and init_block(packed=) build JAX's
    tree (names and shapes); the JAX block carried across runs through
    encoder_block within 1e-5 of JAX's."""
    d, heads, t = 64, 4, 13
    tg = torch.Generator().manual_seed(3)
    jp = jl.init_attention(jax.random.PRNGKey(9), d, packed=packed, bias=bias)
    tp = tl.init_attention(tg, d, "cpu", torch.float32, packed=packed, bias=bias)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(tp) == shapes(jax.tree.map(np.asarray, jp))
    jb = jl.init_block(jax.random.PRNGKey(10), d, packed=packed)
    tb = tl.init_block(tg, d, "cpu", torch.float32, packed=packed)
    assert shapes(tb) == shapes(jax.tree.map(np.asarray, jb))
    rng = np.random.default_rng(11)
    jb["attn"] = jp
    jb = jax.tree.map(lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape), jnp.float32), jb)
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    want = np.asarray(jl.encoder_block(jb, jnp.asarray(x), heads, dtype=jnp.float32))
    got = tl.encoder_block(_to_torch(jb), torch.from_numpy(x), heads, dtype=torch.float32)
    assert_close(request, got.numpy(), want, 1e-5, scale=max(1.0, float(np.abs(want).max())))
