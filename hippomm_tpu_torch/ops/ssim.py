"""Batched SSIM (structural similarity) on the device.

Counterpart of hippomm_tpu/ops/ssim.py: skimage defaults for 2-D uint8
grayscale — 7×7 uniform window, sample covariance (N/(N-1)), C1=(0.01·L)²,
C2=(0.03·L)², mean over the valid (crop=3) region. Window means are two
separable fp32 convolutions; the device set-up (utils/device.resolve_device)
turns cuDNN's TF32 off, because x² window sums reach ~3e6 where reduced
precision cancels the variance and fakes scene cuts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from hippomm_tpu_torch.utils.device import as_tensors, fetch, resolve_device

WIN = 7


def _window_mean(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) fp32 -> (B, H-6, W-6) mean over 7x7 VALID windows (rows
    then cols, as the JAX program)."""
    ones_h = torch.ones((1, 1, WIN, 1), dtype=torch.float32, device=x.device)
    ones_w = torch.ones((1, 1, 1, WIN), dtype=torch.float32, device=x.device)
    y = F.conv2d(x[:, None], ones_h)
    y = F.conv2d(y, ones_w)
    return y[:, 0] / (WIN * WIN)


def ssim_pairs_host(
    a: np.ndarray, b: np.ndarray, data_range: float = 255.0, dtype=np.float64
) -> np.ndarray:
    """numpy mirror of ssim_pairs for small batches already on the host
    (cumsum-based valid 7x7 window means); float64 matches skimage."""

    def wmean(x):
        c = np.cumsum(np.cumsum(x, axis=1), axis=2)
        c = np.pad(c, ((0, 0), (1, 0), (1, 0)))
        s = (
            c[:, WIN:, WIN:]
            - c[:, :-WIN, WIN:]
            - c[:, WIN:, :-WIN]
            + c[:, :-WIN, :-WIN]
        )
        return s / (WIN * WIN)

    x = np.asarray(a, dtype)
    y = np.asarray(b, dtype)
    np_ = WIN * WIN
    cov_norm = np_ / (np_ - 1.0)
    ux, uy = wmean(x), wmean(y)
    uxx, uyy, uxy = wmean(x * x), wmean(y * y), wmean(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2)
    )
    return s.mean(axis=(1, 2)).astype(np.float32)


def ssim_pairs(a, b, data_range: float = 255.0, device=None) -> torch.Tensor:
    """SSIM for B image pairs. a, b: (B, H, W) uint8/float. Returns (B,) fp32.
    Tensors stay on their device; arrays go to `device` (None: CUDA)."""
    x, y = (t.float() for t in as_tensors(a, b, device=device))
    np_ = WIN * WIN
    cov_norm = np_ / (np_ - 1.0)  # sample covariance, skimage default
    n = x.shape[0]
    # one convolution pipeline over the five stacked planes
    m = _window_mean(torch.cat([x, y, x * x, y * y, x * y], dim=0))
    ux, uy, uxx, uyy, uxy = (m[i * n : (i + 1) * n] for i in range(5))
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2)
    )
    return s.mean(dim=(1, 2))


def batched_ssim(frames_a: np.ndarray, frames_b: np.ndarray, data_range: float = 255.0,
                 device=None) -> np.ndarray:
    """Host wrapper over (B, H, W) (or one (H, W)) grayscale frame stacks ->
    np.ndarray (B,) fp32, as hippomm_tpu.ops.ssim.batched_ssim; the SSIM runs
    on `device` (None: resolve_device, CUDA)."""
    device = resolve_device(device)
    a, b = np.asarray(frames_a), np.asarray(frames_b)
    if a.ndim == 2:
        a, b = a[None], b[None]
    return fetch(ssim_pairs(torch.from_numpy(a).to(device), torch.from_numpy(b).to(device),
                            data_range=float(data_range)))


def adjacent_ssim(frames, data_range: float = 255.0, device=None) -> torch.Tensor:
    """SSIM between consecutive frames of a (T, H, W) stack -> (T-1,)."""
    return ssim_pairs(frames[:-1], frames[1:], data_range=data_range, device=device)


def rgb_to_gray(frames, device=None) -> torch.Tensor:
    """ITU-R 601 luma, matching cv2.cvtColor(BGR2GRAY) coefficients on RGB
    input. A tensor stays on its device; an array goes to `device` (None:
    CUDA)."""
    (f,) = as_tensors(frames, device=device)
    f = f.float()
    return f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114


def frame_difference(a, b, data_range: float = 255.0, device=None) -> torch.Tensor:
    """1 - SSIM dissimilarity used for key-frame selection
    (reference: batch_process.py:32-71)."""
    return 1.0 - ssim_pairs(a, b, data_range=data_range, device=device)
