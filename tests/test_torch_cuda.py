"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card. Every test is marked `cuda` and skips on a host without CUDA.

Imports neither jax nor the JAX package, so it runs on the card's machine:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from hippomm_tpu_torch.ops import flash_attention as tfa
from hippomm_tpu_torch.ops import fused_mlp as tfm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    # the two ingest shapes, a short ragged one, and hd 40, which the wrapper
    # pads to a multiple of 16
    [(32, 16, 257, 257, 80), (96, 12, 229, 230, 64), (2, 3, 33, 40, 48), (2, 3, 33, 40, 40)],
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
@pytest.mark.parametrize("n,d,f", [(8224, 1280, 5120), (21984, 768, 3072), (40, 128, 512)])
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
    """fp32 operands and K2 with D > 1280 raise instead of running plain."""
    q = torch.zeros((1, 2, 17, 64), device=cuda_device)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tfa.flash_mha(q, q, q, 0.125)
    for dt, d, f, match in ((torch.float32, 128, 512, "bfloat16"), (torch.bfloat16, 1408, 5632, "1280")):
        x = torch.zeros((64, d), device=cuda_device, dtype=dt)
        w1 = torch.zeros((f, d), device=cuda_device, dtype=dt)
        w2 = torch.zeros((d, f), device=cuda_device, dtype=dt)
        b1 = torch.zeros((f,), device=cuda_device)
        b2 = torch.zeros((d,), device=cuda_device)
        with pytest.raises(NotImplementedError, match=match):
            tfm.fused_mlp(x, w1, b1, w2, b2)
