"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card. Every test is marked `cuda` and skips on a host without CUDA.

Imports neither jax nor the JAX package, so it runs on the card's machine:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from hippomm_tpu_torch.ops import flash_attention as tfa
from hippomm_tpu_torch.ops import fused_mlp as tfm
from hippomm_tpu_torch.ops import topk as ttk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    # the fp32 plain versions in full fp32 (TF32 keeps about 3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def _assert_f32_matches(out, ref, rel: bool):
    """The fp32 gates: 5e-5 abs (K1/K4) or 5e-5 of max |out| (K2/K3) of the
    plain version in full fp32."""
    assert out.shape == ref.shape and out.dtype == torch.float32
    err = (out - ref).abs().max().item()
    assert err <= 5e-5 * (ref.abs().max().item() if rel else 1.0), err


@pytest.mark.cuda
def test_kernels_raise_for_what_they_do_not_take(cuda_device):
    """fp32 operands run the fp32 kernels (one launch, counted as fp32)
    and match their plain versions; fp16 raises instead of running plain;
    K2 at D 1408, wider than any tower, runs and matches its plain
    version."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn((1, 2, 17, 64), generator=g, device=cuda_device)
    before = (tfa.flash_mha.launches, tfa.flash_mha.launches_f32)
    _assert_f32_matches(tfa.flash_mha(q, q, q, 0.125), tfa.flash_mha_ref(q, q, q, 0.125), False)
    assert (tfa.flash_mha.launches, tfa.flash_mha.launches_f32) == (before[0] + 1, before[1] + 1)
    with pytest.raises(NotImplementedError, match="float32"):
        tfa.flash_mha(q.half(), q.half(), q.half(), 0.125)
    x, _, _, w1, b1, w2, b2 = _mlp_operands(cuda_device, 64, 128, 512, 7)
    args = (x.float(), w1.float(), b1, w2.float(), b2)
    before = tfm.fused_mlp.launches_f32
    _assert_f32_matches(tfm.fused_mlp(*args), tfm.fused_mlp_ref(*args), True)
    assert tfm.fused_mlp.launches_f32 == before + 1
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
    """K3 and K4 with fp32 operands run the fp32 kernels and match their
    plain versions (K3 with and without its residual); K3 at D 1408 runs
    and matches its plain version."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_operands(cuda_device, 64, 128, 512, 8)
    args = (x.float(), gamma, beta, w1.float(), b1, w2.float(), b2, 1e-6)
    before = tfm.fused_ln_mlp_residual.launches_f32
    for residual in (True, False):
        _assert_f32_matches(tfm.fused_ln_mlp_residual(*args, residual=residual),
                            tfm.fused_ln_mlp_residual_ref(*args, residual=residual), True)
    assert tfm.fused_ln_mlp_residual.launches_f32 == before + 2
    args = (*_mlp_operands(cuda_device, 64, 1408, 5632, 8), 1e-6)
    _assert_matches(tfm.fused_ln_mlp_residual(*args), tfm.fused_ln_mlp_residual_ref(*args))
    q = torch.randn((1, 17, 2, 64), generator=torch.Generator(device=cuda_device).manual_seed(8),
                    device=cuda_device)
    before = tfa.flash_mha_bthd.launches_f32
    _assert_f32_matches(tfa.flash_mha_bthd(q, q, q, 0.125), tfa.flash_mha_bthd_ref(q, q, q, 0.125), False)
    assert tfa.flash_mha_bthd.launches_f32 == before + 1


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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,bthd",
    # K1 at the ingest, Whisper, training and text shapes, hd 40 and 16;
    # the key tiles' edges (Tk 1, 8, 9, 63, 64, 65, 129: tiles of 32 keys, of
    # 16 past hd 80, as at Tk 24 and hd 112) and the query tiles' (Tq 1, 129:
    # a second 128-row work tile with one row); hd 8, 72 (an hd that is no
    # multiple of 16) and 128; hd 30, whose strides TMA does not take (the
    # wrapper's padded copy). K4 (B, T, H, hd) on slices of a packed (B, T,
    # 3D) projection (q, k and v at d·4-byte offsets, row stride 3D), at a
    # ragged Tq against Tk, at hd 72 and at hd 30 (padded)
    [((32, 16, 257, 257, 80), False), ((96, 12, 229, 230, 64), False),
     ((4, 20, 1500, 1500, 64), False), ((16, 16, 257, 257, 80), False),
     ((8, 16, 77, 77, 64), False), ((2, 3, 33, 40, 40), False), ((2, 4, 50, 50, 16), False),
     ((1, 2, 1, 1, 64), False), ((2, 2, 70, 64, 128), False), ((2, 2, 63, 65, 80), False),
     ((2, 2, 5, 1, 80), False), ((2, 2, 40, 8, 80), False), ((2, 2, 40, 9, 64), False),
     ((2, 2, 130, 63, 80), False), ((2, 2, 129, 129, 64), False), ((2, 2, 40, 129, 128), False),
     ((2, 3, 33, 65, 8), False), ((2, 3, 129, 9, 72), False), ((2, 2, 20, 24, 112), False),
     ((2, 2, 9, 9, 30), False),
     ((32, 16, 257, 257, 80), True), ((16, 16, 257, 257, 80), True), ((2, 4, 33, 33, 40), True),
     ((8, 8, 258, 257, 80), True), ((2, 4, 64, 64, 72), True), ((2, 3, 20, 20, 30), True)],
)
def test_flash_f32_kernels_match_plain_on_cuda(cuda_device, shape, bthd):
    """The fp32 K1/K4 kernel (csrc/flash_mha_f32.cu: 3×TF32 wgmma) against
    the plain version in full fp32: within 5e-5 abs; one launch, counted as
    fp32."""
    b, h, tq, tk, hd = shape
    g = torch.Generator(device=cuda_device).manual_seed(21)
    if bthd:
        d = h * hd
        qkv = torch.randn((b, max(tq, tk), 3 * d), generator=g, device=cuda_device)
        q = qkv[:, :tq, :d].reshape(b, tq, h, hd)
        k = qkv[:, :tk, d:2 * d].reshape(b, tk, h, hd)
        v = qkv[:, :tk, 2 * d:].reshape(b, tk, h, hd)
        wrapper, plain = tfa.flash_mha_bthd, tfa.flash_mha_bthd_ref
    else:
        q, k, v = (torch.randn((b, h, t, hd), generator=g, device=cuda_device) for t in (tq, tk, tk))
        wrapper, plain = tfa.flash_mha, tfa.flash_mha_ref
    before = (wrapper.launches, wrapper.launches_f32)
    out = wrapper(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_f32) == (before[0] + 1, before[1] + 1)
    _assert_f32_matches(out, plain(q, k, v, hd ** -0.5), False)


@pytest.mark.cuda
@pytest.mark.parametrize("tk,hd", [(1500, 64), (257, 80)])
def test_flash_f32_kernel_sharp_softmax_on_cuda(cuda_device, tk, hd):
    """The fp32 kernel at sharp logits: inputs ×3 and keys sorted by their
    dot with the queries' common direction, so each key tile raises the row
    max and the rescale of O carries the result, with |q·k| in the hundreds
    (where q_hi·k_hi and the cross products need accumulators of their
    own). Within 5e-5 abs of the plain version in full fp32."""
    b, h, tq = 1, 2, 64
    g = torch.Generator(device=cuda_device).manual_seed(12)
    base = torch.randn((b, h, 1, hd), generator=g, device=cuda_device)
    q = 3 * (base + 0.1 * torch.randn((b, h, tq, hd), generator=g, device=cuda_device))
    k = 3 * torch.randn((b, h, tk, hd), generator=g, device=cuda_device)
    order = torch.argsort((k * base).sum(-1), dim=-1)  # ascending logits along the keys
    k = torch.gather(k, 2, order[..., None].expand(-1, -1, -1, hd))
    v = torch.randn((b, h, tk, hd), generator=g, device=cuda_device)
    out = tfa.flash_mha(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    _assert_f32_matches(out, tfa.flash_mha_ref(q, k, v, hd ** -0.5), False)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d,f",
    # vision, audio, the Whisper encoder, the text tower (one question: pass
    # 1 32 wide, 32 K slices in pass 2; eight: 4 slices), the training
    # step's vision and text rows, an audio shard's 229 rows (16 slices of
    # 6 k-steps), ragged rows
    [(8224, 1280, 5120), (21984, 768, 3072), (6000, 1280, 5120), (77, 1024, 4096),
     (616, 1024, 4096), (4112, 1280, 5120), (1232, 1024, 4096), (229, 768, 3072), (45, 768, 3072),
     (8, 128, 128)],
)
def test_mlp_f32_kernels_match_plain_on_cuda(cuda_device, n, d, f):
    """The fp32 K2 and K3 kernels (csrc/fused_mlp_f32.cu: 3×TF32 on the
    tensor cores) against their plain versions in full fp32: within 5e-5 of
    max |out|, K3 with and without its residual; one launch each, counted as
    fp32; b1 shifted by -1 puts GELU's negative side in play. Then K2 under
    autograd (`_Recompute`): the kernel's forward within the same gate and
    the plain recompute's gradients."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_operands(cuda_device, n, d, f, 22)
    x, w1, w2, b1 = x.float(), w1.float(), w2.float(), b1 - 1.0
    before = (tfm.fused_mlp.launches_f32, tfm.fused_ln_mlp_residual.launches_f32)
    out2 = tfm.fused_mlp(x, w1, b1, w2, b2)
    out3 = tfm.fused_ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2, 1e-6)
    out3r = tfm.fused_ln_mlp_residual(x, gamma, beta, w1, b1, w2, b2, 1e-6, residual=False)
    torch.cuda.synchronize()
    assert (tfm.fused_mlp.launches_f32, tfm.fused_ln_mlp_residual.launches_f32) == (before[0] + 1,
                                                                                     before[1] + 2)
    _assert_f32_matches(out2, tfm.fused_mlp_ref(x, w1, b1, w2, b2), True)
    _assert_f32_matches(out3, tfm.fused_ln_mlp_residual_ref(x, gamma, beta, w1, b1, w2, b2, 1e-6), True)
    _assert_f32_matches(out3r, tfm.fused_ln_mlp_residual_ref(x, gamma, beta, w1, b1, w2, b2, 1e-6,
                                                             residual=False), True)
    g = torch.randn((n, d), generator=torch.Generator(device=cuda_device).manual_seed(23), device=cuda_device)
    args = (x, w1, b1, w2, b2)
    before = tfm.fused_mlp.launches_f32
    out, grads = _grads_of(tfm.fused_mlp, args, g)
    assert tfm.fused_mlp.launches_f32 == before + 1
    ref, want = _grads_of(tfm.fused_mlp_ref, args, g)
    _assert_f32_matches(out, ref, True)
    for got, w in zip(grads, want):
        assert torch.equal(got, w)


@pytest.mark.cuda
def test_fp32_entry_points_run_on_cuda(cuda_device):
    """ImageBind and Whisper built in fp32 on the card run through the fp32
    kernels: the tiny ImageBind's vision tower (K1 a block; its 64-wide MLP
    is past the K2 gate) and the tiny Whisper's transcription (K1 an encoder
    block), each against the same forward with the kernels routed out."""
    from hippomm_tpu_torch.models import layers
    from hippomm_tpu_torch.models.foundation import ImageBind, Whisper

    ib = ImageBind(variant="tiny", dtype=torch.float32)
    frames = np.random.default_rng(3).integers(0, 256, (4, 56, 56, 3)).astype(np.uint8)
    before = tfa.flash_mha.launches_f32
    emb = ib.encode_vision(frames)
    assert tfa.flash_mha.launches_f32 - before == ib.cfg.vision.depth
    with pytest.MonkeyPatch.context() as m:
        m.setattr(layers, "flash_supported", lambda *a: False)
        plain = ib.encode_vision(frames)
    assert np.abs(emb - plain).max() <= 1e-4
    wh = Whisper(variant="tiny", dtype=torch.float32)
    before = tfa.flash_mha.launches_f32
    segs = wh.transcribe(np.random.default_rng(4).standard_normal(2 * 16000).astype(np.float32) * 0.1)
    assert tfa.flash_mha.launches_f32 - before >= wh.cfg.encoder_layers
    assert isinstance(segs, list)


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
    g = torch.Generator(device=cuda_device).manual_seed(14)
    for d in (6, 1026, 66):  # D % 4 != 0: the element-wise instance, one launch
        odd = torch.randn((300, d), generator=g, device=cuda_device)
        _topk_on_cuda(odd[0], odd, 5)


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
@pytest.mark.parametrize("d,offset", [(6, 0), (1026, 0), (1024, 1), (1026, 3), (6, 1), (1024, 2)])
def test_topk_kernel_any_width_and_offset_on_cuda(cuda_device, d, offset):
    """2e5 rows of D 6 and 1026 (not a multiple of 4) and stores that start
    1-3 elements into their buffer (a view, not 16-byte aligned): one
    launch a call against the plain version, and no copy of the store (the
    call's peak memory stays far below the store's bytes)."""
    n, k = 200_000, 20
    g = torch.Generator(device=cuda_device).manual_seed(15 + d + offset)
    flat = torch.randn((n * d + offset,), generator=g, device=cuda_device)
    feats = flat[offset:].view(n, d)
    q = torch.randn((d,), generator=g, device=cuda_device)
    assert (feats.data_ptr() % 16 == 0) == (offset == 0)
    _topk_on_cuda(q, feats, k)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ttk.top_k_cosine_kernel(q, feats, k)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < n * d


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


def _grads_of(fn, args, g):
    """Gradients of fn(*args) against the cotangent g, for every argument
    (fresh leaves, so the calls share nothing)."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*leaves)
    out.backward(g)
    return out.detach(), [a.grad for a in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("bthd", [False, True], ids=["flash_mha", "flash_mha_bthd"])
def test_attention_gradients_through_the_kernel_on_cuda(cuda_device, bthd, dtype):
    """K1 and K4 under autograd: the output has a grad_fn and the kernel ran
    the forward (one launch); the gradients equal those of the same Function
    with the plain forward (the backward recomputes from the saved inputs)
    and agree with autograd of the plain version within 2⁻⁶ of each input's
    largest gradient in bf16 (roundings in other places), 1e-4 in fp32."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    b, h, t, hd = 2, 4, 77, 80
    shape = (b, t, h, hd) if bthd else (b, h, t, hd)
    q, k, v, g = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype) for _ in range(4))
    scale = hd ** -0.5
    wrapper, counter = (tfa.flash_mha_bthd, tfa.flash_mha_bthd) if bthd else (tfa.flash_mha, tfa.flash_mha)
    plain = tfa.flash_mha_bthd_ref if bthd else tfa.flash_mha_ref
    before = counter.launches
    out, grads = _grads_of(lambda *a: wrapper(*a, scale), (q, k, v), g)
    assert counter.launches == before + 1
    _, same = _grads_of(lambda *a: tfa._Attention.apply(*a, scale, plain, bthd), (q, k, v), g)
    _, auto = _grads_of(lambda *a: plain(*a, scale), (q, k, v), g)
    for got, s, a in zip(grads, same, auto):
        assert got is not None and got.dtype == dtype and torch.equal(got, s)
        err = (got.float() - a.float()).abs().max().item() / a.float().abs().max().item()
        assert err <= (2.0 ** -6 if dtype == torch.bfloat16 else 1e-4), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("ln", [False, True], ids=["fused_mlp", "fused_ln_mlp_residual"])
@pytest.mark.parametrize("n,d,f", [(200, 256, 1024), (77, 1024, 4096)])
def test_mlp_gradients_through_the_kernel_on_cuda(cuda_device, ln, n, d, f, dtype):
    """K2 and K3 under autograd with fp32 master weights (x in bf16 or in
    fp32, the fp32 kernels'): one launch, an output with its own allocation
    (not a view of the kernel's workspace), fp32 gradients for the masters,
    and gradients equal to autograd of the plain version (the backward
    recomputes it on the saved inputs)."""
    x, gamma, beta, w1, b1, w2, b2 = _mlp_operands(cuda_device, n, d, f, 9)
    x, w1, w2 = x.to(dtype), w1.float(), w2.float()
    args = (x, gamma, beta, w1, b1, w2, b2) if ln else (x, w1, b1, w2, b2)
    wrapper = tfm.fused_ln_mlp_residual if ln else tfm.fused_mlp
    plain = tfm.fused_ln_mlp_residual_ref if ln else tfm.fused_mlp_ref
    g = torch.randn((n, d), generator=torch.Generator(device=cuda_device).manual_seed(10),
                    device=cuda_device).to(dtype)
    before = wrapper.launches
    out, grads = _grads_of(wrapper, args, g)
    assert wrapper.launches == before + 1
    _, want = _grads_of(plain, args, g)
    assert [t.dtype for t in grads] == [a.dtype for a in args]
    for got, w in zip(grads, want):
        assert torch.equal(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
def test_train_step_gives_every_block_parameter_a_gradient_on_cuda(cuda_device, monkeypatch, fused, dtype):
    """A bf16 or fp32 training step of the 128-wide tiny config through the
    kernels (K1/K2, or K3/K4 under the fused flags; the fp32 kernels at
    fp32): every vision and text block parameter gets a finite, nonzero
    fp32 gradient — the regression of kernel outputs without a grad_fn,
    which dropped the gradients of in_proj, fc1 and norm_1 — within 0.1
    relative L2 (bf16) or 1e-3 (fp32) of the same step with the kernels
    routed out; the step's launches are exact."""
    from hippomm_tpu_torch.models import layers
    from hippomm_tpu_torch.train import contrastive as tc

    cfg = _tiny_width_128()
    monkeypatch.setattr(tfa, "bthd_default", lambda: fused)
    monkeypatch.setattr(tfm, "fused_block_default", lambda: fused)
    params, _ = tc.init_train_state(cfg, device=cuda_device, seed=4)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    images = torch.randn((4, 3, cfg.image_size, cfg.image_size), generator=gen, device=cuda_device)
    tokens = torch.randint(1, cfg.vocab_size - 1, (4, cfg.context_length), generator=gen, device=cuda_device)
    tokens[:, -1] = cfg.vocab_size - 1
    counters = (tfa.flash_mha, tfm.fused_mlp, tfm.fused_ln_mlp_residual, tfa.flash_mha_bthd)
    before = [(c.launches, c.launches_f32) for c in counters]
    _, grads = tc.loss_and_grads(params, images, tokens, cfg, dtype)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, (b, _) in zip(counters, before)]
    launched_f32 = [c.launches_f32 - b for c, (_, b) in zip(counters, before)]
    depth = cfg.vision.depth
    assert launched == ([0, 0, 2 * depth, depth] if fused else [depth, 2 * depth, 0, 0])
    assert launched_f32 == (launched if dtype == torch.float32 else [0, 0, 0, 0])
    with monkeypatch.context() as m:
        m.setattr(layers, "flash_supported", lambda *a: False)
        m.setattr(layers, "fused_mlp_supported", lambda *a: False)
        m.setattr(tfa, "bthd_supported", lambda *a: False)
        _, plain = tc.loss_and_grads(params, images, tokens, cfg, dtype)
    for key, gr in grads.items():
        if ".blocks." not in key or key.startswith("audio"):
            continue
        assert gr is not None and gr.dtype == torch.float32 and torch.isfinite(gr).all() and gr.any(), key
        err = ((gr - plain[key]).norm() / plain[key].norm()).item()
        assert err <= (0.1 if dtype == torch.bfloat16 else 1e-3), (key, err)


def _cuda_mesh(cuda_device, shards: int = 4):
    """A mesh whose `shards` data shards all sit on the one card."""
    from hippomm_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shards, devices=[cuda_device] * shards)


@pytest.mark.cuda
def test_sharded_k5_search_matches_the_one_device_index_on_cuda(cuda_device):
    """A 4-shard index of 50 003 rows (the last shard short, a fifth of the
    rows scoring negative) against the one-device index: equal hits, K5
    once per shard a round, and the batched route's hits too."""
    import numpy as np

    from hippomm_tpu_torch.memory.schema import ThetaEvent
    from hippomm_tpu_torch.parallel.sharded_store import ShardedFeatureIndex
    from hippomm_tpu_torch.retrieval.search import FeatureSearchIndex

    rng = np.random.default_rng(21)
    n, d = 50_003, 1024
    feats = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(8, d)).astype(np.float32)
    feats[-10_000:] -= 0.2 * q[0]
    events = [ThetaEvent(video_id=f"v{e}", features={"vision": feats[lo:lo + 5000]},
                         feature_times={"vision": [float(t) for t in range(len(feats[lo:lo + 5000]))]},
                         start_time=0.0, end_time=5000.0) for e, lo in enumerate(range(0, n, 5000))]
    one = FeatureSearchIndex.build(events, "vision", device=cuda_device)
    sharded = ShardedFeatureIndex.build(events, "vision", _cuda_mesh(cuda_device))
    assert [f.shape[0] for _, f in sharded._shards.parts] == [12_501, 12_501, 12_501, 12_500]
    keys = lambda hits: [(h.event_id, h.index_in_event) for h in hits]  # noqa: E731
    for i in range(len(q)):
        want = one.search(q[i], top_k_per_event=5, global_top_k=5)
        before = ttk.top_k_cosine_kernel.launches
        got = sharded.search(torch.from_numpy(q[i]).to(cuda_device), top_k_per_event=5, global_top_k=5)
        assert ttk.top_k_cosine_kernel.launches - before == 4  # one round, four shards
        assert keys(got) == keys(want)
        assert max(abs(a.similarity - b.similarity) for a, b in zip(got, want)) <= 1e-5
    for got, want in zip(sharded.search_batch(q), one.search_batch(q)):
        assert keys(got) == keys(want)


@pytest.mark.cuda
def test_sharded_encode_equals_the_one_device_encode_of_each_slab_on_cuda(cuda_device, monkeypatch):
    """A 32-frame chunk over 4 shards on one card: every shard's features
    equal, bit for bit, the one-device forward of its 8-frame slab; the
    gathered features meet the tower gate against the 32-frame forward; K1
    and K2 run once per block per shard."""
    from hippomm_tpu_torch.models.foundation import ImageBind
    from hippomm_tpu_torch.models.imagebind import model as ib_model

    import numpy as np

    cfg = _tiny_width_128()
    params = ib_model.init_imagebind(cfg, cuda_device, torch.bfloat16, seed=5)
    monkeypatch.setattr(ib_model, "get_config", lambda variant: cfg)
    ib = ImageBind(variant="tiny", params=params, mesh=_cuda_mesh(cuda_device))
    calls = []
    real = ib_model.vision_forward
    monkeypatch.setattr(ib_model, "vision_forward",
                        lambda p, x, *a: calls.append((x.clone(), real(p, x, *a).clone())) or calls[-1][1])
    frames = np.random.default_rng(3).integers(0, 256, size=(20, 48, 64, 3)).astype(np.uint8)
    before = (tfa.flash_mha.launches, tfm.fused_mlp.launches)
    got = ib.encode_vision(frames)
    launches = (tfa.flash_mha.launches - before[0], tfm.fused_mlp.launches - before[1])
    assert launches == (4 * cfg.vision.depth, 4 * cfg.vision.depth)
    assert [x.shape[0] for x, _ in calls] == [8] * 4
    with torch.no_grad():
        for x, out in calls:
            assert torch.equal(real(params, x, cfg, torch.bfloat16), out)
        whole = real(params, torch.cat([x for x, _ in calls]), cfg, torch.bfloat16)[:20].float().cpu().numpy()
    assert np.abs(got - whole).max() <= 2e-2
    cos = (got * whole).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(whole, axis=1))
    assert cos.min() >= 0.999


@pytest.mark.cuda
def test_lockstep_greedy_decode_equals_each_shards_decode_on_cuda(cuda_device):
    """Whisper's greedy decode of 4 shards in lockstep on the card: each
    shard's tokens up to its rows' <|endoftext|> and its lengths equal the
    shard decoded alone."""
    from hippomm_tpu_torch.models.whisper import model as twm

    cfg = twm.tiny_config()
    params = twm.init_whisper(cfg, cuda_device, torch.bfloat16, seed=2)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    mel = torch.randn((8, cfg.n_mels, 2 * cfg.max_source_positions), generator=g, device=cuda_device)
    enc = twm.encoder_forward(params, mel, cfg, torch.bfloat16)
    prompt = torch.tensor([[cfg.bos_token, cfg.lang_en_token, cfg.task_transcribe_token]] * 2,
                          device=cuda_device)
    shards = [(params, enc[i:i + 2], prompt) for i in range(0, 8, 2)]
    ml = cfg.max_target_positions
    both = twm.greedy_decode_shards(shards, cfg, max_len=ml)
    for (tok, ln), shard in zip(both, shards):
        tok1, ln1 = twm.greedy_decode(*shard, cfg, max_len=ml)
        assert torch.equal(ln, ln1)
        for j in range(tok.shape[0]):
            end = min(int(ln[j]) + 1, ml)
            assert torch.equal(tok[j, :end], tok1[j, :end])


def _whisper_decode_case(device, rows, seed=0, forced_at=60):
    """distil-large-v3's decoder at its widths with random weights, `rows`
    chunks of random encoder output and the transcriber's prompt; the
    position embedding at `forced_at` pushed along <|endoftext|>'s
    embedding, so every row ends there and the loop exits early (random
    weights never end a transcript)."""
    from hippomm_tpu_torch.models.whisper import model as twm

    cfg = twm.distil_large_v3_config()
    params = twm.init_whisper(cfg, device, torch.bfloat16, seed=seed)
    dec = params["decoder"]
    dec["pos_embed"][forced_at] += 50.0 * dec["token_embedding"][cfg.eot_token]
    g = torch.Generator(device=device).manual_seed(seed + 1)
    enc = torch.randn((rows, cfg.max_source_positions, cfg.d_model), generator=g, device=device)
    prompt = torch.tensor([[cfg.bos_token, cfg.lang_en_token, cfg.task_transcribe_token]] * rows,
                          dtype=torch.int32, device=device)
    return cfg, params, enc, prompt


def _eager_greedy(params, cfg, enc, prompt, max_len):
    """The greedy loop stepped eagerly on the card (`_lockstep`'s exit
    rule): (tokens, lengths, the last step's logits)."""
    from hippomm_tpu_torch.models.whisper import model as twm

    with torch.no_grad():
        st = twm._GreedyShard(params, cfg, enc.shape, max_len, torch.bfloat16, enc.device)
        st.start(enc, prompt)
        for _ in range(prompt.shape[1], max_len):
            logits = st.step()
            if bool(st.finished.all()):
                break
    return st.tokens, st.lengths, logits


def _graph_counts():
    from hippomm_tpu_torch.utils import timers

    out = {}
    for r in list(timers.RING):
        if r.name in ("asr.graph_captures", "asr.graph_steps"):
            out[r.name] = out.get(r.name, 0) + r.n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 16])
def test_whisper_graph_decode_equals_the_eager_loop_on_cuda(cuda_device, rows):
    """The greedy decode replaying one CUDA graph a position gives the eager
    loop's tokens and lengths, the early exit included, and its last
    step's logits to 1e-5 of their largest; a second decode of the same
    bucket replays the same graph without a capture; each loop counts its
    positions once as graph steps."""
    from hippomm_tpu_torch.models.whisper import model as twm

    cfg, params, enc, prompt = _whisper_decode_case(cuda_device, rows, seed=rows)
    tok_e, len_e, logits_e = _eager_greedy(params, cfg, enc, prompt, 224)
    assert (len_e == 61).all()  # the forced exit, well before 224
    graphs = twm.DecodeGraphs()
    before = _graph_counts()
    for k in range(2):
        tok, ln = graphs.decode([(params, enc, prompt)], cfg, 224)[0]
        assert torch.equal(tok, tok_e) and torch.equal(ln, len_e)
        assert (tok[:, 62:] == 0).all()
    after = _graph_counts()
    assert after.get("asr.graph_captures", 0) - before.get("asr.graph_captures", 0) == 1
    assert after["asr.graph_steps"] - before.get("asr.graph_steps", 0) == 2 * (61 - 2)
    logits = graphs.get(0, params, cfg, enc, 224, torch.bfloat16).logits
    assert (logits - logits_e).abs().max().item() <= 1e-5 * logits_e.abs().max().item()


@pytest.mark.cuda
def test_whisper_graph_decode_from_two_threads_on_cuda(cuda_device):
    """Two threads decoding buckets of one shape on one transcriber share
    its graph under its lock, and each gets what it gets alone."""
    import threading

    from hippomm_tpu_torch.models.whisper.transcribe import WhisperTranscriber

    cfg, params, enc, prompt = _whisper_decode_case(cuda_device, 8, seed=3)
    tr = WhisperTranscriber(params, cfg, None, torch.bfloat16, beam_size=1)
    halves = [[(params, enc[:4], prompt[:4])], [(params, enc[4:], prompt[4:])]]
    with torch.no_grad():
        alone = [tr._decode(h, 224)[0] for h in halves]
    got = [[], []]
    errors = []

    def run(i):
        try:
            with torch.no_grad():
                for _ in range(3):
                    got[i].append(tr._decode(halves[i], 224)[0])
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    for i in range(2):
        assert len(got[i]) == 3
        for tok, ln in got[i]:
            assert torch.equal(tok, alone[i][0]) and torch.equal(ln, alone[i][1])
    assert len(tr._graphs._graphs) == 1


@pytest.mark.cuda
def test_whisper_graph_capture_while_another_thread_launches_on_cuda(cuda_device):
    """A capture taken while another thread launches products, allocates
    new memory and reads results back through its stream succeeds
    (thread-local capture), and the decode equals the eager loop. (No
    thread may synchronise the whole device while one of its streams
    captures; the port's threads wait on their own streams.)"""
    import threading

    from hippomm_tpu_torch.models.whisper import model as twm

    cfg, params, enc, prompt = _whisper_decode_case(cuda_device, 4, seed=7)
    tok_e, len_e, _ = _eager_greedy(params, cfg, enc, prompt, 224)
    stop = threading.Event()
    launched = [0]

    def busy():
        x = torch.randn((1024, 1024), device=cuda_device)
        n = 1 << 20
        while not stop.is_set():
            y = x @ x
            z = torch.empty((n,), device=cuda_device)  # a new size: the allocator grows
            n += 4096
            y[0, 0].item()
            del y, z
            launched[0] += 1

    t = threading.Thread(target=busy)
    t.start()
    try:
        before = _graph_counts().get("asr.graph_captures", 0)
        tok, ln = twm.greedy_decode_shards([(params, enc, prompt)], cfg, 224)[0]
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and launched[0] > 0
    assert _graph_counts().get("asr.graph_captures", 0) == before + 1
    assert torch.equal(tok, tok_e) and torch.equal(ln, len_e)


@pytest.mark.cuda
def test_whisper_graph_rebuilt_after_a_parameter_swap_on_cuda(cuda_device):
    """New decoder weights (a transcriber's params replaced) rebuild the
    bucket's graph: a second capture, and the tokens of the new weights."""
    from hippomm_tpu_torch.models.whisper import model as twm

    cfg, params, enc, prompt = _whisper_decode_case(cuda_device, 4, seed=9, forced_at=60)
    _, swapped, _, _ = _whisper_decode_case(cuda_device, 4, seed=9, forced_at=30)
    graphs = twm.DecodeGraphs()
    before = _graph_counts().get("asr.graph_captures", 0)
    first = graphs.decode([(params, enc, prompt)], cfg, 224)[0]
    second = graphs.decode([(swapped, enc, prompt)], cfg, 224)[0]
    assert _graph_counts().get("asr.graph_captures", 0) == before + 2
    assert (first[1] == 61).all() and (second[1] == 31).all()
    tok_e, len_e, _ = _eager_greedy(swapped, cfg, enc, prompt, 224)
    assert torch.equal(second[0], tok_e) and torch.equal(second[1], len_e)


@pytest.mark.cuda
def test_whisper_beam_decode_stays_eager_on_cuda(cuda_device):
    """Beam search on the card steps eagerly (its caches are gathered anew
    each position): no graph is captured or replayed, and the forced exit
    holds for every hypothesis."""
    from hippomm_tpu_torch.models.whisper import model as twm

    cfg, params, enc, prompt = _whisper_decode_case(cuda_device, 4, seed=11, forced_at=20)
    before = _graph_counts()
    _, lengths, _ = twm.beam_decode_batch(params, enc, prompt, cfg, 224, beam=2)
    assert _graph_counts() == before
    assert (lengths == 21).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,f", [(2392, 1152, 4352), (64, 256, 384)])
def test_fused_mlp_tanh_instance_matches_plain_on_cuda(cuda_device, n, d, f):
    """K2's tanh-GELU instance (MoonViT's MLP: two 1196-patch key frames,
    the width padded to 4352) against its plain version, under K2's gate;
    the same operands through the erf instance give another result."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((n, d), generator=g, device=cuda_device).to(torch.bfloat16)
    w1 = (torch.randn((f, d), generator=g, device=cuda_device) / d ** 0.5).to(torch.bfloat16)
    b1 = 0.1 * torch.randn((f,), generator=g, device=cuda_device)
    w2 = (torch.randn((d, f), generator=g, device=cuda_device) / f ** 0.5).to(torch.bfloat16)
    b2 = 0.1 * torch.randn((d,), generator=g, device=cuda_device)
    before = tfm.fused_mlp.launches
    out = tfm.fused_mlp(x, w1, b1, w2, b2, approximate="tanh")
    torch.cuda.synchronize()
    assert tfm.fused_mlp.launches == before + 1
    ref = tfm.fused_mlp_ref(x, w1, b1, w2, b2, approximate="tanh")
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2 * ref.float().abs().max().item()
    erf = tfm.fused_mlp(x, w1, b1, w2, b2)
    assert (erf.float() - out.float()).abs().max().item() > 0


@pytest.mark.cuda
def test_kimi_vl_graph_decode_equals_the_eager_steps_on_cuda(cuda_device):
    """The tiny Kimi-VL in bf16: a bucket's decode as CUDA graph replays
    (grouped expert products, the absorbed MLA over the shared cache pool)
    gives the tokens of the same steps run eagerly, rows of two lengths
    in one bucket; the ViT's MLP launched K2."""
    from hippomm_tpu_torch.models.kimi_vl import model as km

    vlm = km.KimiVL("tiny", dtype=torch.bfloat16, device=cuda_device, seed=5)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (56, 84, 3), dtype=np.uint8) for _ in range(3)]
    before = tfm.fused_mlp.launches
    rows = vlm.encode_images(imgs)
    assert tfm.fused_mlp.launches == before + vlm.cfg.vision.depth
    prompts = [vlm.tok.chat_ids(p, [r.shape[0]]) for p, r in zip(("a", "a b c", "a b"), rows)]
    got = vlm.generate_ids(prompts, [[r] for r in rows], 12)
    g = vlm._graphs[4, 512]
    assert g.graph is not None
    st = g.state
    st.start(sorted(prompts, key=len), [[rows[i]] for i in sorted(range(3), key=lambda i: len(prompts[i]))])
    for _ in range(11):
        st.step()
    eager = st.out[:3, :12].tolist()
    order = sorted(range(3), key=lambda i: len(prompts[i]))
    for j, i in enumerate(order):
        row = eager[j]
        assert got[i] == (row[: row.index(vlm.tok.im_end)] if vlm.tok.im_end in row else row)
