"""Colour conversion between planar YUV420 and RGB (BT.601 full range).

Counterpart of hippomm_tpu/ops/color.py as torch ops on the tensors' own
device. No path of the port calls them yet: the Y4M reader converts on the
host (media/io.py), as the JAX package's does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Planar YUV420 (full-range BT.601) -> (N, H, W, 3) uint8 RGB.

    y: (N, H, W) uint8; u, v: (N, H/2, W/2) uint8, upsampled by nearest
    neighbour (the inverse of rgb_to_yuv420's 2×2 mean)."""
    yf = y.float()
    uf = u.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    vf = v.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return _to_u8(torch.stack([r, g, b], dim=-1))


def rgb_to_yuv420(rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, H, W, 3) uint8 RGB -> planar YUV420 (full-range BT.601), chroma
    2×2 box-downsampled. Returns (y, u, v) uint8."""
    f = rgb.float()
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def down2(x: torch.Tensor) -> torch.Tensor:
        n, h, w = x.shape
        return x.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    return _to_u8(y), _to_u8(down2(u)), _to_u8(down2(v))
