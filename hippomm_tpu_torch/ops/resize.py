"""Frame resize + normalize: uint8 decoded frames -> ViT inputs and SSIM thumbnails.

Counterpart of hippomm_tpu/ops/resize.py:
  * `resize_crop_u8` — host Pillow-exact bicubic resize + center crop
    (csrc/media_resize.cpp, PIL when no C++ compiler is found)
  * `normalize_nchw` — uint8 crops -> CLIP-normalized (B, 3, S, S) fp32
  * `resize_frames` — the antialiased bilinear downscale of
    jax.image.resize, rebuilt as two separable resampling matrices (JAX's
    triangle-kernel weights, computed on the host in fp32) applied with
    fp32 matmuls; F.interpolate(antialias=True) does not promise the same
    weights.
  * `resize_normalize` — the one-call (B, H, W, 3) → normalized (B, 3, S, S)
    preprocess: jax.image.resize's antialiased bicubic (Keys cubic, a = -0.5)
    short-side resize by the same separable matrices, center crop, CLIP
    normalization.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

# CLIP / ImageBind vision normalization constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_nchw(crops_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, S, S, 3) pre-resized crops -> CLIP-normalized (B, 3, S, S) fp32."""
    x = crops_u8.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def _resize_dims(h: int, w: int, size: int):
    """torchvision Resize(short=size) dims — the long side TRUNCATES
    (int(size * long / short)); round() diverges by 1px on 4:3-ish inputs."""
    if h <= w:
        nh, nw = size, max(size, int(w * size / h))
    else:
        nh, nw = max(size, int(h * size / w)), size
    return nh, nw


def resize_crop_u8(frames, size: int = 224) -> np.ndarray:
    """HOST preprocess: uint8 (B, H, W, 3) RGB -> uint8 (B, size, size, 3),
    short side resized to `size` (bicubic, Pillow's fixed-point algorithm)
    then center-cropped — the reference's PIL Resize -> CenterCrop chain."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.clip(frames, 0, 255).astype(np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3) uint8, got {frames.shape}")
    n, h, w = frames.shape[:3]
    if n == 0:
        return np.empty((0, size, size, 3), np.uint8)
    nh, nw = _resize_dims(h, w, size)
    top, left = (nh - size) // 2, (nw - size) // 2

    from hippomm_tpu_torch.ops import _native

    lib = _native.resize_lib()
    if lib is not None:
        frames = np.ascontiguousarray(frames)
        out = np.empty((n, size, size, 3), np.uint8)
        rc = lib.hmm_resize_bicubic_crop_batch(
            frames.ctypes.data_as(ctypes.c_void_p), n, h, w, nh, nw, top, left,
            size, size, out.ctypes.data_as(ctypes.c_void_p), min(4, os.cpu_count() or 1, n),
        )
        if rc != 0:
            raise RuntimeError(f"media_resize failed with code {rc}")
        return out

    from PIL import Image

    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        im = Image.fromarray(frames[i])
        if (nw, nh) != (w, h):
            im = im.resize((nw, nh), Image.BICUBIC)
        out[i] = np.asarray(im)[top : top + size, left : left + size]
    return out


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """jax._src.image.scale._fill_keys_cubic_kernel on |x|, in fp32."""
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= f32(1.0), ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    return np.where(x >= f32(2.0), f32(0.0), out).astype(f32)


@functools.lru_cache(maxsize=32)
def _resample_weights(in_size: int, out_size: int, kernel: str = "triangle") -> np.ndarray:
    """(in_size, out_size) fp32 resampling matrix of jax.image.resize
    ('bilinear' for the triangle kernel, 'bicubic' for Keys cubic) with
    antialias=True (jax._src.image.scale.compute_weight_mat, translation 0),
    evaluated in fp32 as JAX does."""
    f32 = np.float32
    # JAX takes the scale as a Python (double) ratio and inverts it in double
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = {"triangle": _triangle, "cubic": _keys_cubic}[kernel](x.astype(f32)).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > f32(1000.0) * np.finfo(np.float32).eps,
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    ).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize_normalize(frames, size: int = 224) -> torch.Tensor:
    """uint8/float (B, H, W, 3) RGB (a tensor, on its device, or an array)
    -> CLIP-normalized (B, 3, size, size) fp32, as
    hippomm_tpu.ops.resize.resize_normalize: the short side resized to
    `size` (the long side by int() truncation, torchvision's rule) with the
    antialiased bicubic weights, center crop, [0, 1] scaling and the CLIP
    mean/std."""
    x = torch.as_tensor(frames)
    _, h, w, _ = x.shape
    if h <= w:
        nh, nw = size, max(size, int(w * size / h))
    else:
        nh, nw = max(size, int(h * size / w)), size
    top, left = (nh - size) // 2, (nw - size) // 2
    # the crop's rows and columns of the weight matrices only
    wh = torch.from_numpy(_resample_weights(h, nh, "cubic")[:, top:top + size]).to(x.device)
    ww = torch.from_numpy(_resample_weights(w, nw, "cubic")[:, left:left + size]).to(x.device)
    x = x.float() / 255.0
    x = torch.einsum("bhwc,ho->bowc", x, wh)
    x = torch.einsum("bowc,wp->bopc", x, ww)
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def resize_frames(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Antialiased bilinear uint8 frame resize (B, H, W, C) -> (B, height,
    width, C), as hippomm_tpu.ops.resize.resize_frames: separable fp32
    resampling, round, clip to uint8."""
    _, h, w, _ = frames.shape
    wh = torch.from_numpy(_resample_weights(h, height)).to(frames.device)
    ww = torch.from_numpy(_resample_weights(w, width)).to(frames.device)
    x = frames.float()
    x = torch.einsum("bhwc,ho->bowc", x, wh)
    x = torch.einsum("bowc,wp->bopc", x, ww)
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
