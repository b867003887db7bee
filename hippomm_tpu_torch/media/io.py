"""Host media helpers of the query path (counterpart of the JPEG and
thumbnail parts of hippomm_tpu/media/io.py).

Detailed recall reads the stored key-frame JPEGs of a hit's window,
downscales them to 320×180 thumbnails, drops near-duplicates by SSIM on
their luma and re-encodes the kept ones for the captioning client. The JPEG
codec is PIL's, as the JAX package uses without its native shim, imported
inside the functions. Decoding video files (`probe_video` / `open_video`)
comes with the port's media shim: until then they raise OSError for a path
that names no file, as the JAX readers do, and NotImplementedError for a
real one.
"""

from __future__ import annotations

import io
import os

import numpy as np


def jpeg_encode(rgb: np.ndarray, quality: int = 90) -> bytes:
    """RGB (H, W, 3) uint8 -> JPEG bytes."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb, dtype=np.uint8)).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def jpeg_decode(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGB (H, W, 3) uint8."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return jpeg_decode(f.read())


def _luma_u8(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> uint8 luma (BT.601, 16-bit fixed point)."""
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).astype(np.uint8)


def downscale_rgb(frames: np.ndarray, gh: int, gw: int) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, gh, gw, 3) on the host: box average for
    integer ratios, nearest otherwise."""
    return np.stack(
        [_box_downscale(frames[..., c], gh, gw) for c in range(frames.shape[-1])], axis=-1
    )


def _box_downscale(x: np.ndarray, gh: int, gw: int) -> np.ndarray:
    """(N, H, W) uint8 -> (N, gh, gw) uint8 box average (nearest if non-integral)."""
    n, h, w = x.shape
    if h == gh and w == gw:
        return x
    if h == 2 * gh and w == 2 * gw:
        # the common recall shape (360x640 -> 180x320): strided uint16 adds
        s = x[:, 0::2, 0::2].astype(np.uint16)
        s += x[:, 0::2, 1::2]
        s += x[:, 1::2, 0::2]
        s += x[:, 1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    if h % gh == 0 and w % gw == 0:
        fh, fw = h // gh, w // gw
        s = x.reshape(n, gh, fh, gw, fw).astype(np.uint32).sum(axis=(2, 4))
        return ((s + fh * fw // 2) // (fh * fw)).astype(np.uint8)
    yi = np.minimum((np.arange(gh) * h) // gh, h - 1)
    xi = np.minimum((np.arange(gw) * w) // gw, w - 1)
    return x[:, yi][:, :, xi]


def open_video(path: str):
    """Video reader — the port's media shim is not written yet."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    raise NotImplementedError(
        f"decoding {path} needs the port's media shim (libav/libjpeg), not written yet"
    )


def probe_video(path: str):
    r = open_video(path)
    try:
        return r.info
    finally:
        r.close()
