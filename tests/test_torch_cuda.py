"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card. Every test is marked `cuda` and skips on a host without CUDA.

Imports neither jax nor the JAX package, so it runs on the card's machine:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from hippomm_tpu_torch.ops import flash_attention as tfa
from hippomm_tpu_torch.ops import fused_mlp as tfm
from hippomm_tpu_torch.ops import topk as ttk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    # the two ImageBind ingest shapes, the Whisper encoder's, a short ragged
    # one, and hd 40, which the wrapper pads to a multiple of 16; then the key
    # tiles' edges (Tk 1 and 16: one 16-key tile; 17: one masked 128-key
    # tile; 255, 256; 2048, the gate's limit), Tq 1, and hd 16 and 128
    [(32, 16, 257, 257, 80), (96, 12, 229, 230, 64), (4, 20, 1500, 1500, 64), (2, 3, 33, 40, 48),
     (2, 3, 33, 40, 40), (1, 2, 1, 1, 64), (2, 2, 1, 16, 80), (2, 2, 17, 17, 64),
     (2, 2, 255, 255, 80), (2, 2, 256, 256, 64), (1, 2, 1, 2048, 64), (1, 2, 300, 2048, 128),
     (2, 3, 70, 144, 16), (2, 2, 130, 140, 128), (1, 1, 1, 1, 16)],
)
def test_flash_kernel_matches_plain_on_cuda(cuda_device, shape):
    b, h, tq, tk, hd = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((b, h, tq, hd), generator=g, device=cuda_device).to(torch.bfloat16)
    k = torch.randn((b, h, tk, hd), generator=g, device=cuda_device).to(torch.bfloat16)
    v = torch.randn((b, h, tk, hd), generator=g, device=cuda_device).to(torch.bfloat16)
    before = tfa.flash_mha.launches
    out = tfa.flash_mha(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert tfa.flash_mha.launches == before + 1
    ref = tfa.flash_mha_ref(q, k, v, hd ** -0.5)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("tk,hd", [(1500, 64), (257, 80)])
def test_flash_kernel_sharp_softmax_on_cuda(cuda_device, tk, hd):
    """Inputs ×4 and keys sorted by their dot with the queries' common
    direction, so each key tile raises the row max and the online rescale
    carries the result. v is scaled by 1/4 so that outputs stay below 1 and
    the 2e-2 gate keeps its margin of bf16 ulps."""
    b, h, tq = 1, 2, 64
    g = torch.Generator(device=cuda_device).manual_seed(11)
    base = torch.randn((b, h, 1, hd), generator=g, device=cuda_device)
    q = 4 * (base + 0.1 * torch.randn((b, h, tq, hd), generator=g, device=cuda_device))
    k = 4 * torch.randn((b, h, tk, hd), generator=g, device=cuda_device)
    order = torch.argsort((k * base).sum(-1), dim=-1)  # ascending logits along the keys
    k = torch.gather(k, 2, order[..., None].expand(-1, -1, -1, hd))
    v = 0.25 * torch.randn((b, h, tk, hd), generator=g, device=cuda_device)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    out = tfa.flash_mha(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    ref = tfa.flash_mha_ref(q, k, v, hd ** -0.5)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def _mlp_operands(device, n, d, f, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn((d,), generator=g, device=device)
    beta = 0.1 * torch.randn((d,), generator=g, device=device)
    w1 = (torch.randn((f, d), generator=g, device=device) / d ** 0.5).to(torch.bfloat16)
    b1 = 0.1 * torch.randn((f,), generator=g, device=device)
    w2 = (torch.randn((d, f), generator=g, device=device) / f ** 0.5).to(torch.bfloat16)
    b2 = 0.1 * torch.randn((d,), generator=g, device=device)
    return x, gamma, beta, w1, b1, w2, b2


def _assert_matches(out, ref):
    """The K2/K3 gate: within 2e-2 of max |out| of the plain version."""
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,f", [(8224, 1280, 5120), (21984, 768, 3072), (6000, 1280, 5120),
                                   (40, 128, 512)])
def test_fused_mlp_kernel_matches_plain_on_cuda(cuda_device, n, d, f):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((n, d), generator=g, device=cuda_device).to(torch.bfloat16)
    w1 = (torch.randn((f, d), generator=g, device=cuda_device) / d ** 0.5).to(torch.bfloat16)
    b1 = 0.1 * torch.randn((f,), generator=g, device=cuda_device)
    w2 = (torch.randn((d, f), generator=g, device=cuda_device) / f ** 0.5).to(torch.bfloat16)
    b2 = 0.1 * torch.randn((d,), generator=g, device=cuda_device)
    before = tfm.fused_mlp.launches
    out = tfm.fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert tfm.fused_mlp.launches == before + 1
    ref = tfm.fused_mlp_ref(x, w1, b1, w2, b2)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item()


@pytest.mark.cuda
def test_kernels_raise_for_what_they_do_not_take(cuda_device):
    """fp32 operands raise instead of running plain; K2 at D 1408, wider
    than any tower, runs and matches its plain version."""
    q = torch.zeros((1, 2, 17, 64), device=cuda_device)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tfa.flash_mha(q, q, q, 0.125)
    x, _, _, w1, b1, w2, b2 = _mlp_operands(cuda_device, 64, 128, 512, 7)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tfm.fused_mlp(x.float(), w1.float(), b1, w2.float(), b2)
    x, _, _, w1, b1, w2, b2 = _mlp_operands(cuda_device, 64, 1408, 5632, 7)
    _assert_matches(tfm.fused_mlp(x, w1, b1, w2, b2), tfm.fused_mlp_ref(x, w1, b1, w2, b2))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d,f",
    # the vision and audio ingest shapes, N not a multiple of 32 at D 768, a small one
    [(8224, 1280, 5120), (21984, 768, 3072), (45, 768, 3072), (40, 128, 512)],
)
def test_fused_ln_mlp_residual_kernel_matches_plain_on_cuda(cuda_device, n, d, f):
    x, gamma, beta, w1, b1, w2, b2 = _mlp_operands(cuda_device, n, d, f, 2)
    before = tfm.fused_ln_mlp_residual.launches
    out = tfm.fused_ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2, 1e-6)
    torch.cuda.synchronize()
    assert tfm.fused_ln_mlp_residual.launches == before + 1
    assert out.shape == (n, d) and out.dtype == torch.bfloat16
    ref = tfm.fused_ln_mlp_residual_ref(x, gamma, beta, w1, b1, w2, b2, 1e-6)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,t,h,hd,packed",
    # the vision tower's shape as (B, T, D) reshapes and as slices of a packed
    # (B, T, 3D) projection (row stride 3D); a ragged one; hd 40 (padded);
    # a packed one at Whisper's long Tk
    [(32, 257, 16, 80, False), (32, 257, 16, 80, True), (2, 33, 8, 64, True),
     (2, 33, 4, 40, False), (2, 1500, 8, 64, True)],
)
def test_flash_bthd_kernel_matches_plain_on_cuda(cuda_device, b, t, h, hd, packed):
    d = h * hd
    g = torch.Generator(device=cuda_device).manual_seed(3)
    if packed:
        qkv = torch.randn((b, t, 3 * d), generator=g, device=cuda_device).to(torch.bfloat16)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        q, k, v = (torch.randn((b, t, d), generator=g, device=cuda_device).to(torch.bfloat16)
                   for _ in range(3))
    q4, k4, v4 = (x.reshape(b, t, h, hd) for x in (q, k, v))
    assert q4.stride(2) == hd and q4.stride(1) == (3 * d if packed else d)
    before = tfa.flash_mha_bthd.launches
    out = tfa.flash_mha_bthd(q4, k4, v4, hd ** -0.5)
    torch.cuda.synchronize()
    assert tfa.flash_mha_bthd.launches == before + 1
    assert out.shape == (b, t, h, hd)
    ref = tfa.flash_mha_bthd_ref(q4, k4, v4, hd ** -0.5)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_k3_k4_raise_for_what_they_do_not_take(cuda_device):
    """K3 and K4 with fp32 operands raise instead of running plain; K3 at
    D 1408 runs and matches its plain version."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_operands(cuda_device, 64, 128, 512, 8)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tfm.fused_ln_mlp_residual(x.float(), gamma, beta, w1.float(), b1, w2.float(), b2, 1e-6)
    args = (*_mlp_operands(cuda_device, 64, 1408, 5632, 8), 1e-6)
    _assert_matches(tfm.fused_ln_mlp_residual(*args), tfm.fused_ln_mlp_residual_ref(*args))
    q = torch.zeros((1, 17, 2, 64), device=cuda_device)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tfa.flash_mha_bthd(q, q, q, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,f", [(77, 1024, 4096), (616, 1024, 4096)])
def test_mlp_kernels_at_the_text_tower_shape(cuda_device, n, d, f):
    """K2 and K3 at D 1024 and the text tower's row counts (77 per question:
    one 128-row band, zero-filled past row 77; both take split-K pass 2)."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_operands(cuda_device, n, d, f, 4)
    before = (tfm.fused_mlp.launches, tfm.fused_ln_mlp_residual.launches)
    out2 = tfm.fused_mlp(x, w1, b1, w2, b2)
    out3 = tfm.fused_ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2, 1e-6)
    torch.cuda.synchronize()
    assert (tfm.fused_mlp.launches, tfm.fused_ln_mlp_residual.launches) == (before[0] + 1, before[1] + 1)
    for out, ref in ((out2, tfm.fused_mlp_ref(x, w1, b1, w2, b2)),
                     (out3, tfm.fused_ln_mlp_residual_ref(x, gamma, beta, w1, b1, w2, b2, 1e-6))):
        assert out.shape == (n, d)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d,f",
    # ragged row counts through both plans (split-K pass 2 at 8, 77 and 129
    # rows; one pass each at 8223), and D 1408 through both
    [(8, 1024, 4096), (77, 1024, 4096), (129, 1024, 4096), (8223, 1024, 4096), (200, 1408, 5632),
     (4100, 1408, 5632)],
)
def test_mlp_kernels_ragged_rows_both_plans(cuda_device, n, d, f):
    x, gamma, beta, w1, b1, w2, b2 = _mlp_operands(cuda_device, n, d, f, 9)
    assert (tfm._plan(n, d, f).splits > 1) == (n < 1000)
    _assert_matches(tfm.fused_mlp(x, w1, b1, w2, b2), tfm.fused_mlp_ref(x, w1, b1, w2, b2))
    args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
    _assert_matches(tfm.fused_ln_mlp_residual(*args), tfm.fused_ln_mlp_residual_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [77, 8224])
def test_mlp_kernels_gelu_negative_side(cuda_device, n):
    """b1 shifted by -2 puts most pre-activations on GELU's negative side,
    where erf's tail and the bf16 cast before GELU carry the result."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_operands(cuda_device, n, 1280, 5120, 10)
    b1 = b1 - 2.0
    _assert_matches(tfm.fused_mlp(x, w1, b1, w2, b2), tfm.fused_mlp_ref(x, w1, b1, w2, b2))
    args = (x, gamma, beta, w1, b1, w2, b2, 1e-6)
    _assert_matches(tfm.fused_ln_mlp_residual(*args), tfm.fused_ln_mlp_residual_ref(*args))


def _topk_agree(vals, idx, rvals, ridx, tol=1e-5):
    """Values within tol; indices equal except where the plain version's
    neighbouring values are closer than tol (an order the two roundings may
    flip)."""
    vals, rvals = vals.cpu().double(), rvals.cpu().double()
    idx, ridx = idx.cpu().long(), ridx.cpu().long()
    assert (vals - rvals).abs().max().item() <= tol
    gaps = (rvals[1:] - rvals[:-1]).abs()
    for j in torch.nonzero(idx != ridx).flatten().tolist():
        near = [gaps[j - 1].item()] if j > 0 else []
        near += [gaps[j].item()] if j < len(gaps) else []
        assert min(near, default=float("inf")) < tol, f"index {j}: {idx[j]} != {ridx[j]}"


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(5000, 1), (5000, 40), (5000, 128), (100_003, 128), (700, 128),
                                 (1074, 128), (130, 128), (1, 1)])
def test_topk_kernel_matches_plain_on_cuda(cuda_device, n, k):
    """K5 against its plain version: N not a multiple of a chunk, k at its
    ends, blocks with fewer rows than k, and stores smaller than the grid
    (130 rows in 17 blocks of 7-8 at k 128; one row)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    feats = torch.randn((n, 1024), generator=g, device=cuda_device)
    q = torch.randn((1024,), generator=g, device=cuda_device)
    before = ttk.top_k_cosine_kernel.launches
    vals, idx = ttk.top_k_cosine_kernel(q, feats, k)
    torch.cuda.synchronize()
    assert ttk.top_k_cosine_kernel.launches == before + 1
    assert vals.shape == idx.shape == (k,) and idx.dtype == torch.int32
    _topk_agree(vals, idx, *ttk.top_k_cosine_ref(q, feats, k))


@pytest.mark.cuda
def test_topk_kernel_tie_order_on_cuda(cuda_device):
    """Equal values: the lower row first, lax.top_k's order. Every row equal
    makes every candidate a survivor, so the merge's buffer fills and is
    sorted down more than once; ten distinct rows repeated give ties inside
    and across tiles."""
    row = torch.randn((1, 256), device=cuda_device)
    vals, idx = ttk.top_k_cosine_kernel(row[0], row.expand(20_000, 256).contiguous(), 128)
    assert torch.equal(idx.cpu(), torch.arange(128, dtype=torch.int32))
    assert (vals == vals[0]).all()
    g = torch.Generator(device=cuda_device).manual_seed(6)
    base = torch.randn((10, 256), generator=g, device=cuda_device)
    feats = base.repeat(300, 1)
    q = torch.randn((256,), generator=g, device=cuda_device)
    vals, idx = ttk.top_k_cosine_kernel(q, feats, 100)
    rvals, ridx = ttk.top_k_cosine_ref(q, feats, 100)
    assert torch.equal(idx.cpu(), ridx.cpu())
    assert (vals - rvals).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_topk_kernel_contract_on_cuda(cuda_device):
    feats = torch.zeros((300, 64), device=cuda_device)
    with pytest.raises(ValueError, match="exceeds kernel contract"):
        ttk.top_k_cosine_kernel(feats[0], feats, 129)
    with pytest.raises(ValueError, match="must be in"):
        ttk.top_k_cosine_kernel(feats[0], feats[:10], 11)
    with pytest.raises(NotImplementedError, match="D % 4"):
        odd = torch.zeros((300, 66), device=cuda_device)
        ttk.top_k_cosine_kernel(odd[0], odd, 5)


def _topk_on_cuda(q, feats, k):
    """K5 on the card, one launch, against its plain version."""
    before = ttk.top_k_cosine_kernel.launches
    vals, idx = ttk.top_k_cosine_kernel(q, feats, k)
    torch.cuda.synchronize()
    assert ttk.top_k_cosine_kernel.launches == before + 1
    assert vals.shape == idx.shape == (k,) and idx.dtype == torch.int32
    rvals, ridx = ttk.top_k_cosine_ref(q, feats, k)
    _topk_agree(vals, idx, rvals, ridx)
    return vals, idx, rvals, ridx


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 128])
def test_topk_kernel_ascending_store_on_cuda(cuda_device, k):
    """Rows sorted by ascending similarity to the query: every row beats
    each block's running threshold, the filter's worst case, so every
    candidate buffer fills and is sorted down at every flush."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    feats = torch.randn((200_000, 1024), generator=g, device=cuda_device)
    q = torch.randn((1024,), generator=g, device=cuda_device)
    sims = (feats * torch.rsqrt((feats * feats).sum(dim=1, keepdim=True))) @ (q / q.norm())
    feats = feats[torch.argsort(sims)].contiguous()
    _topk_on_cuda(q, feats, k)


@pytest.mark.cuda
def test_topk_kernel_equal_rows_across_blocks_on_cuda(cuda_device):
    """Every row equal at k 128 over 264 blocks: all ties, lower row first;
    each block's list holds only ties, and the merge's prefixes overflow
    one group of its shared memory (its slow, grouped path)."""
    row = torch.randn((1, 1024), generator=torch.Generator(device=cuda_device).manual_seed(13),
                      device=cuda_device)
    feats = row.expand(200_000, 1024).contiguous()
    vals, idx = ttk.top_k_cosine_kernel(row[0], feats, 128)
    torch.cuda.synchronize()
    assert torch.equal(idx.cpu(), torch.arange(128, dtype=torch.int32))
    assert (vals == vals[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(5000, 4, 40), (300, 4, 128), (20_000, 2048, 128), (7, 2048, 7)])
def test_topk_kernel_narrow_and_wide_rows_on_cuda(cuda_device, n, d, k):
    """D 4 (a float4 a row: 896-row chunks) and D 2048 (4-row chunks, one
    block an SM)."""
    g = torch.Generator(device=cuda_device).manual_seed(14)
    _topk_on_cuda(torch.randn((d,), generator=g, device=cuda_device),
                  torch.randn((n, d), generator=g, device=cuda_device), k)


@pytest.mark.cuda
def test_topk_kernel_store_past_2_31_elements_on_cuda(cuda_device):
    """2 200 000 × 1024 (2.25e9 elements, 9 GB): row offsets past 2³¹
    elements; the best rows are planted past that point and at the start."""
    n, d = 2_200_000, 1024
    g = torch.Generator(device=cuda_device).manual_seed(15)
    feats = torch.empty((n, d), device=cuda_device)
    for lo in range(0, n, 200_000):
        feats[lo:lo + 200_000].normal_(generator=g)
    q = torch.randn((d,), generator=g, device=cuda_device)
    for r in (3, n - 1, n - 7, 2_097_153, 2_150_000):
        feats[r] = q + 0.1 * torch.randn((d,), generator=g, device=cuda_device)
    vals, idx = ttk.top_k_cosine_kernel(q, feats, 128)
    torch.cuda.synchronize()
    assert set(idx[:5].tolist()) == {3, n - 1, n - 7, 2_097_153, 2_150_000}
    qn = q / q.norm()
    for j in range(0, 128, 9):  # each value is its row's cosine
        f = feats[int(idx[j])].double()
        assert abs(float(f @ qn.double()) / float(f.norm()) - float(vals[j])) <= 1e-5
    # the plain version in slices of the store: the same top 128
    best_v, best_i = [], []
    for lo in range(0, n, 400_000):
        v, i = ttk.top_k_cosine_ref(q, feats[lo:lo + 400_000], 128)
        best_v.append(v)
        best_i.append(i.long() + lo)
    v, i = torch.cat(best_v), torch.cat(best_i)
    order = torch.sort(v, descending=True, stable=True).indices[:128]
    _topk_agree(vals, idx, v[order], i[order].int())


@pytest.mark.cuda
def test_topk_kernel_is_one_cuda_kernel_per_call(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda_device).manual_seed(16)
    feats = torch.randn((200_000, 1024), generator=g, device=cuda_device)
    q = torch.randn((1024,), generator=g, device=cuda_device)
    ttk.top_k_cosine_kernel(q, feats, 40)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ttk.top_k_cosine_kernel(q, feats, 40)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and "topk" in e.name]
    others = [e.name for e in prof.events()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and "topk" not in e.name
              and "emcpy" not in e.name and "emset" not in e.name]
    assert len(kernels) == 3, [e.name for e in kernels]
    assert not others, others


@pytest.mark.cuda
def test_topk_kernel_calls_in_a_row_on_cuda(cuda_device):
    """Calls back to back on one stream, without a wait between them: each
    leaves the scratch's ticket at 0 for the next (k and N differ)."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    feats = torch.randn((100_000, 1024), generator=g, device=cuda_device)
    qs = torch.randn((4, 1024), generator=g, device=cuda_device)
    outs = [ttk.top_k_cosine_kernel(qs[0], feats, 128), ttk.top_k_cosine_kernel(qs[1], feats, 5),
            ttk.top_k_cosine_kernel(qs[2], feats[:3000], 40), ttk.top_k_cosine_kernel(qs[3], feats, 1)]
    torch.cuda.synchronize()
    for (vals, idx), q, f, k in zip(outs, qs, (feats, feats, feats[:3000], feats), (128, 5, 40, 1)):
        _topk_agree(vals, idx, *ttk.top_k_cosine_ref(q, f, k))


def _tiny_vision_tower(cuda_device):
    """The tiny ImageBind vision tower 128 wide (the K2 gate: D % 128 == 0),
    4 heads of 32, random bf16 weights."""
    import dataclasses

    from hippomm_tpu_torch.models.imagebind import model as ib_model

    c = ib_model.tiny_config()
    cfg = dataclasses.replace(c, vision=dataclasses.replace(c.vision, width=128))
    params = ib_model.init_imagebind(cfg, cuda_device, torch.bfloat16, seed=3)
    x = torch.randn((4, 3, cfg.image_size, cfg.image_size),
                    generator=torch.Generator(device=cuda_device).manual_seed(18), device=cuda_device)
    return lambda: ib_model.vision_forward(params, x, cfg, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("flag", ["HIPPOMM_FLASH_ATTN", "HIPPOMM_FUSED_MLP"])
def test_kill_switch_routes_the_kernels_out_on_cuda(cuda_device, monkeypatch, flag):
    """With the flag at 0 the vision tower launches none of its kernels
    (K1 and K4 even with HIPPOMM_FLASH_BTHD=1; K2) and equals the plain
    route (the shape gates shut, as chip_smoke.py's phase 3 does); at 1 it
    launches them."""
    from hippomm_tpu_torch.models import layers

    policies = (tfa.flash_default, tfa.bthd_default, tfm.fused_mlp_default, tfm.fused_block_default)
    forward = _tiny_vision_tower(cuda_device)
    counters = {"HIPPOMM_FLASH_ATTN": (tfa.flash_mha, tfa.flash_mha_bthd),
                "HIPPOMM_FUSED_MLP": (tfm.fused_mlp,)}[flag]
    gate = {"HIPPOMM_FLASH_ATTN": "flash_supported", "HIPPOMM_FUSED_MLP": "fused_mlp_supported"}[flag]
    try:
        for value in ("0", "1"):
            monkeypatch.setenv(flag, value)
            monkeypatch.setenv("HIPPOMM_FLASH_BTHD", "1")
            for p in policies:
                p.cache_clear()
            before = [c.launches for c in counters]
            with torch.no_grad():
                got = forward()
            torch.cuda.synchronize()
            launched = sum(c.launches for c in counters) - sum(before)
            if value == "0":
                assert launched == 0
                with monkeypatch.context() as m:
                    m.setattr(layers, gate, lambda *a: False)
                    if flag == "HIPPOMM_FLASH_ATTN":
                        m.setattr(tfa, "bthd_supported", lambda *a: False)
                    with torch.no_grad():
                        want = forward()
                assert torch.equal(got, want)
            else:
                assert launched > 0
    finally:
        monkeypatch.delenv(flag)
        monkeypatch.delenv("HIPPOMM_FLASH_BTHD")
        for p in policies:
            p.cache_clear()


def _scan_luma(n: int, seed: int):
    """(n, 90, 160) uint8 candidate luma with scene cuts and drift, and
    candidate times 0.5 s apart."""
    import numpy as np

    rng = np.random.default_rng(seed)
    scenes = rng.integers(20, 235, size=(1 + n // 4, 90, 160)).astype(np.float32)
    which = np.cumsum(rng.random(n) < 0.15)
    i = np.arange(n, dtype=np.float32)[:, None, None]
    g = scenes[which % len(scenes)] * (1.0 - 0.002 * i) + rng.normal(0, 4, (n, 90, 160))
    return np.clip(g, 0, 255).astype(np.uint8), [0.5 * j for j in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 256])
def test_keyframe_scan_on_cuda_matches_cpu(cuda_device, block):
    """The greedy scan on the card, carry across blocks included, selects the
    CPU scan's key frames from the same luma."""
    from hippomm_tpu_torch.ops.keyframe import select_keyframes_device

    grays, times = _scan_luma(300, seed=1)
    got = select_keyframes_device(grays, times, 0.3, 1.0, block=block, device=cuda_device)
    want = select_keyframes_device(grays, times, 0.3, 1.0, block=block, device="cpu")
    assert got == want and len(want) > 5


@pytest.mark.cuda
def test_keyframe_mask_read_does_not_wait_on_the_default_stream(cuda_device):
    """The scan runs on its own stream: while the default stream is busy with
    a long chain of matmuls, a block's mask becomes ready (is_ready goes
    false → true) and reads back, and the default stream is still busy. A
    first block, fed before the matmuls, warms the scan stream's cached host
    and device memory; both blocks' masks equal the CPU scan's."""
    import time

    import numpy as np

    from hippomm_tpu_torch.ops.keyframe import KeyframeScanner, select_keyframes_device

    grays, times = _scan_luma(128, seed=2)
    sc = KeyframeScanner(90, 160, block=64, device=cuda_device)
    first = sc.feed(grays[:64], times[:64]).get()
    a = torch.randn((8192, 8192), device=cuda_device)
    torch.cuda.synchronize()
    for _ in range(100):  # about two seconds of work on the default stream
        a = a @ a
        a = a / a.norm()
    busy = torch.cuda.Event()
    busy.record()
    h = sc.feed(grays[64:], times[64:])
    seen_not_ready = not h.is_ready()
    t0 = time.perf_counter()
    while not h.is_ready():
        assert time.perf_counter() - t0 < 60, "the scan did not finish"
        time.sleep(0.001)
    second = h.get()
    assert not busy.query(), "the default stream finished first: the read may have waited on it"
    assert seen_not_ready
    torch.cuda.synchronize()
    want = select_keyframes_device(grays, times, 0.3, 1.0, block=64, device="cpu")
    assert np.nonzero(np.concatenate([first, second]))[0].tolist() == want


@pytest.mark.cuda
def test_launch_counts_are_exact_from_two_threads(cuda_device):
    """Two threads launching K2 at once: the counter holds every launch."""
    import threading

    g = torch.Generator(device=cuda_device).manual_seed(5)
    n, d, f = 256, 256, 1024

    def operands():
        return (torch.randn((n, d), generator=g, device=cuda_device).to(torch.bfloat16),
                (torch.randn((f, d), generator=g, device=cuda_device) / 16).to(torch.bfloat16),
                torch.zeros((f,), device=cuda_device),
                (torch.randn((d, f), generator=g, device=cuda_device) / 32).to(torch.bfloat16),
                torch.zeros((d,), device=cuda_device))

    sets = [operands(), operands()]
    calls = 2000
    before = tfm.fused_mlp.launches
    errors = []

    def run(ops):
        try:
            for _ in range(calls):
                tfm.fused_mlp(*ops)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,)) for s in sets]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    assert tfm.fused_mlp.launches - before == 2 * calls


def _tiny_width_128():
    """The tiny ImageBind config with all three towers 128 wide: the
    narrowest width the K2/K3 gate (D % 128 == 0) admits."""
    import dataclasses

    from hippomm_tpu_torch.models.imagebind import model as ib_model

    c = ib_model.tiny_config()
    return dataclasses.replace(c, vision=dataclasses.replace(c.vision, width=128),
                               audio=dataclasses.replace(c.audio, width=128),
                               text=dataclasses.replace(c.text, width=128))


@pytest.mark.cuda
def test_qa_service_answers_from_two_handler_threads_on_cuda(cuda_device, tmp_path, monkeypatch):
    """core/serve on the card, its engine built from a 128-wide tiny
    ImageBind checkpoint file: after an ingest, two /ask requests at once,
    each on a new handler thread whose first CUDA work is a kernel launch
    (K2 in the text tower, K5 in the search), answer with the hits of the
    host route."""
    import json
    import threading
    import urllib.request

    from hippomm_tpu_torch.config import Config
    from hippomm_tpu_torch.core import batch_process, serve
    from hippomm_tpu_torch.media.synth import SynthSpec, write_synthetic_video
    from hippomm_tpu_torch.models.imagebind import model as ib_model
    from hippomm_tpu_torch.models.imagebind.manifest import random_state_dict
    from hippomm_tpu_torch.retrieval.search import FeatureSearchIndex

    wide = _tiny_width_128()
    monkeypatch.setattr(ib_model, "get_config", lambda variant: wide)
    ckpt = str(tmp_path / "imagebind_tiny128.pth")
    torch.save({k: torch.from_numpy(v) for k, v in random_state_dict(wide, seed=2).items()}, ckpt)
    videos = tmp_path / "videos"
    videos.mkdir()
    write_synthetic_video(str(videos / "v.y4m"), SynthSpec(duration=20.0, fps=2.0, width=160, height=120,
                                                           scene_changes=(9.0,), seed=5),
                          audio_path=str(videos / "v.wav"))
    cfg = Config()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = "tiny"
    cfg.models.imagebind_path = ckpt
    cfg.models.whisper_variant = "stub"
    cfg.processing.fast_path_confidence = 2.0
    cfg.storage.base_dir = str(tmp_path / "store")
    stats = batch_process.process_video_folder(str(videos), cfg.storage.base_dir, config=cfg)
    assert (stats["processed"], stats["failed"]) == (1, 0)

    service = serve.QAService(cfg)  # on the card; the warmup question runs here
    assert service.memory.imagebind.cfg.text.width == 128
    searches = []
    real_search = FeatureSearchIndex.search

    def search(index, query, *a, **k):
        hits = real_search(index, query, *a, **k)
        searches.append((index, query, a, k, hits))
        return hits

    monkeypatch.setattr(FeatureSearchIndex, "search", search)
    monkeypatch.delenv("HIPPOMM_TOPK_ROUTE", raising=False)
    server = serve.make_server(service, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    k2, k5 = tfm.fused_mlp.launches, ttk.top_k_cosine_kernel.launches
    answers, errors = [], []

    def ask(q):
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/ask", data=json.dumps({"question": q}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                answers.append((r.status, json.loads(r.read())))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=ask, args=(q,)) for q in
                   ("What color is the moving square?", "What objects appear on screen?")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.shutdown()
        server.server_close()
    assert not errors, errors
    assert [s for s, _ in answers] == [200, 200] and all(a["answer"] for _, a in answers)
    assert tfm.fused_mlp.launches - k2 >= 2 * wide.text.depth
    assert ttk.top_k_cosine_kernel.launches - k5 >= 2
    assert len(searches) >= 2
    monkeypatch.setenv("HIPPOMM_TOPK_ROUTE", "host")
    for index, query, a, k, hits in searches:
        want = real_search(index, query, *a, **k)
        assert [(h.event_id, h.time) for h in hits] == [(h.event_id, h.time) for h in want]
        assert max(abs(h.similarity - w.similarity) for h, w in zip(hits, want)) <= 1e-5


def _write_safetensors(path, tensors):
    """A safetensors file written by hand (a machine may lack the
    package): u64 header length, JSON header, raw little-endian bytes."""
    import json
    import struct

    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16", torch.int64: "I64",
             torch.int32: "I32"}
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


@pytest.mark.cuda
def test_whisper_safetensors_checkpoint_loads_on_cuda(cuda_device, tmp_path, monkeypatch):
    """model.safetensors of a Whisper checkpoint loads onto the card through
    the port's own reader (the `safetensors` package made unimportable), to
    the parameters the same weights give from pytorch_model.bin."""
    import sys

    transformers = pytest.importorskip("transformers")
    from hippomm_tpu_torch.models.foundation import Whisper
    from hippomm_tpu_torch.models.whisper import model as wh_model

    cfg = wh_model.tiny_config()
    hf_cfg = transformers.WhisperConfig(
        vocab_size=cfg.vocab_size, num_mel_bins=cfg.n_mels, d_model=cfg.d_model,
        encoder_layers=cfg.encoder_layers, decoder_layers=cfg.decoder_layers,
        encoder_attention_heads=cfg.heads, decoder_attention_heads=cfg.heads,
        encoder_ffn_dim=cfg.ffn, decoder_ffn_dim=cfg.ffn, max_source_positions=cfg.max_source_positions,
        max_target_positions=cfg.max_target_positions, pad_token_id=0, bos_token_id=cfg.bos_token,
        eos_token_id=cfg.eot_token, decoder_start_token_id=cfg.bos_token)
    torch.manual_seed(0)
    sd = {f"model.{k}": v.contiguous() for k, v in transformers.WhisperModel(hf_cfg).state_dict().items()}
    (tmp_path / "st").mkdir()
    (tmp_path / "bin").mkdir()
    _write_safetensors(str(tmp_path / "st" / "model.safetensors"), sd)
    torch.save(sd, tmp_path / "bin" / "pytorch_model.bin")
    monkeypatch.setitem(sys.modules, "safetensors", None)
    a = Whisper(model_path=str(tmp_path / "st"), variant="tiny", device=cuda_device)._impl.params
    b = Whisper(model_path=str(tmp_path / "bin"), variant="tiny", device=cuda_device)._impl.params

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb) > 0
    assert all(x.device.type == "cuda" and torch.equal(x, y) for x, y in zip(la, lb))
