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
    preprocess: a short-side resize by any method of jax.image.resize
    (antialiased bicubic, Keys cubic a = -0.5, by default) through the same
    separable matrices (nearest as a row and column gather), center crop,
    CLIP normalization.
The tensor ops take numpy arrays too: an array goes to the caller's
`device` (None: CUDA, utils/device.resolve_device), a tensor stays where it
is.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from hippomm_tpu_torch.utils.device import as_tensors

# CLIP / ImageBind vision normalization constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_nchw(crops_u8, device=None) -> torch.Tensor:
    """uint8 (B, S, S, 3) pre-resized crops -> CLIP-normalized (B, 3, S, S)
    fp32. A tensor stays on its device; an array goes to `device` (None:
    CUDA)."""
    (x,) = as_tensors(crops_u8, device=device)
    x = x.float() / 255.0
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


def _lanczos(radius: float):
    """jax._src.image.scale._fill_lanczos_kernel(radius, .) on |x|, in fp32."""
    f32 = np.float32
    r, pi = f32(radius), f32(np.pi)

    def kernel(x: np.ndarray) -> np.ndarray:
        y = r * np.sin(pi * x) * np.sin(pi * x / r)
        out = np.where(x > f32(1e-3), y / np.where(x != 0, f32(np.pi ** 2) * (x * x), f32(1.0)), f32(1.0))
        return np.where(x > r, f32(0.0), out).astype(f32)

    return kernel


#: jax.image.ResizeMethod.from_string's names -> the kernel of each weighted
#: method; "nearest" is a gather (_nearest_indices), not a weight matrix
_KERNELS = {
    **dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"), _triangle),
    **dict.fromkeys(("cubic", "bicubic", "tricubic"), _keys_cubic),
    "lanczos3": _lanczos(3.0),
    "lanczos5": _lanczos(5.0),
}


def _check_method(method: str) -> None:
    if method != "nearest" and method not in _KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')


@functools.lru_cache(maxsize=64)
def _resample_weights(in_size: int, out_size: int, method: str = "bilinear",
                      antialias: bool = True) -> np.ndarray:
    """(in_size, out_size) fp32 resampling matrix of jax.image.resize's
    `method` (jax._src.image.scale.compute_weight_mat, translation 0),
    evaluated in fp32 as JAX does; antialias widens the kernel by the
    downscale factor."""
    f32 = np.float32
    # JAX takes the scale as a Python (double) ratio and inverts it in double
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = _KERNELS[method](x.astype(f32)).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > f32(1000.0) * np.finfo(np.float32).eps,
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    ).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """jax._src.image.scale._resize_nearest's source index of each output
    position: floor((i + 0.5) · in / out), in fp32."""
    f32 = np.float32
    offsets = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(in_size) / f32(out_size)
    return np.floor(offsets.astype(f32)).astype(np.int64)


def _resize_axis(x: torch.Tensor, axis: int, in_size: int, out_size: int, method: str,
                 antialias: bool, keep=slice(None)) -> torch.Tensor:
    """Resample `axis` (1: rows, 2: columns) of a (B, H, W, C) fp32 tensor
    from in_size to out_size and keep the output positions `keep`. An axis
    whose size does not change is left as it is (jax.image.resize skips it:
    every method interpolates)."""
    if in_size == out_size:
        return x[:, keep] if axis == 1 else x[:, :, keep]
    if method == "nearest":
        idx = torch.from_numpy(_nearest_indices(in_size, out_size)[keep]).to(x.device)
        return x.index_select(axis, idx)
    w = torch.from_numpy(_resample_weights(in_size, out_size, method, antialias)[:, keep]).to(x.device)
    return torch.einsum("bhwc,ho->bowc" if axis == 1 else "bhwc,wo->bhoc", x, w)


def resize_normalize(frames, size: int = 224, method: str = "bicubic", antialias: bool = True,
                     device=None) -> torch.Tensor:
    """uint8/float (B, H, W, 3) RGB -> CLIP-normalized (B, 3, size, size)
    fp32, as hippomm_tpu.ops.resize.resize_normalize: the short side resized
    to `size` (the long side by int() truncation, torchvision's rule) by
    jax.image.resize's `method` (nearest, linear / bilinear / triangle,
    cubic / bicubic, lanczos3, lanczos5) with or without `antialias`, center
    crop, [0, 1] scaling and the CLIP mean/std. A tensor stays on its
    device; an array goes to `device` (None: CUDA)."""
    _check_method(method)
    (x,) = as_tensors(frames, device=device)
    _, h, w, _ = x.shape
    nh, nw = _resize_dims(h, w, size)
    top, left = (nh - size) // 2, (nw - size) // 2
    # the crop's output rows and columns only
    x = x.float() / 255.0
    x = _resize_axis(x, 1, h, nh, method, antialias, slice(top, top + size))
    x = _resize_axis(x, 2, w, nw, method, antialias, slice(left, left + size))
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def resize_frames(frames, height: int, width: int, device=None) -> torch.Tensor:
    """Antialiased bilinear uint8 frame resize (B, H, W, C) -> (B, height,
    width, C), as hippomm_tpu.ops.resize.resize_frames: separable fp32
    resampling, round, clip to uint8. A tensor stays on its device; an array
    goes to `device` (None: CUDA)."""
    (x,) = as_tensors(frames, device=device)
    _, h, w, _ = x.shape
    x = _resize_axis(x.float(), 1, h, height, "bilinear", True)
    x = _resize_axis(x, 2, w, width, "bilinear", True)
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
