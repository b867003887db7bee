"""Host media I/O (counterpart of hippomm_tpu/media/io.py).

  * JPEG through the port's media shim (csrc/media_jpeg.cpp, libjpeg), or
    PIL where the shim did not build, as the JAX package does without its
    shim
  * MJPEG-AVI through the same shim (threaded batch decode); without the
    shim `AviReader` and `write_avi` raise
  * Y4M (uncompressed YUV4MPEG2 420): frames are fixed-size, so seeking is
    pointer arithmetic, and the scoring luma is the Y plane itself. YUV→RGB
    runs on the host in one native call per read (csrc/media_resize.cpp,
    the interpreter lock released), bit-equal to `_yuv420_to_rgb_np`, which
    converts where that library did not build
  * WAV (PCM16/24/32, float32, WAVE_FORMAT_EXTENSIBLE) in numpy, with channel
    downmix and low-passed linear resampling to 16 kHz mono

  * libav containers (.mp4/.mov/.mkv/.webm/.m4v, and AVI codecs other than
    MJPEG) through the port's libav shim (csrc/media_libav.cpp): decode by
    frame index, the scoring luma scaled in C++, held blocks with RGB taken
    per selected frame, container audio demuxed and resampled to 16 kHz
    mono, and an H.264/MPEG-4 + AAC writer. Without the shim they raise
    RuntimeError naming it, as the JAX package's readers do without theirs.

Both shims and the conversion library are built on first use
(ops/_native.media_lib, media_libav_lib and resize_lib), each on its own.
"""

from __future__ import annotations

import ctypes
import io
import logging
import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

LIBAV_EXTENSIONS = (".mp4", ".mov", ".mkv", ".webm", ".m4v")


def _lib():
    from hippomm_tpu_torch.ops._native import media_lib

    return media_lib()


def native_available() -> bool:
    return _lib() is not None


def _libav():
    from hippomm_tpu_torch.ops._native import media_libav_lib

    return media_libav_lib()


def libav_available() -> bool:
    return _libav() is not None


def _need_libav(what: str):
    lib = _libav()
    if lib is None:
        raise RuntimeError(
            f"{what} needs the libav shim (csrc/media_libav.cpp against libavformat, libavcodec, "
            "libavutil, libswscale and libswresample), which did not build or load on this host"
        )
    return lib


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


def jpeg_encode(rgb: np.ndarray, quality: int = 90) -> bytes:
    """RGB (H, W, 3) uint8 -> JPEG bytes."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    lib = _lib()
    if lib is not None:
        cap = w * h * 3 + 65536
        out = np.empty(cap, dtype=np.uint8)
        out_len = ctypes.c_size_t(cap)
        rc = lib.hmm_jpeg_encode(
            rgb.ctypes.data_as(ctypes.c_void_p), w, h, quality,
            out.ctypes.data_as(ctypes.c_void_p), ctypes.byref(out_len),
        )
        if rc == 0:
            return bytes(out[: out_len.value])
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def jpeg_decode(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGB (H, W, 3) uint8."""
    lib = _lib()
    if lib is not None:
        arr = np.frombuffer(data, dtype=np.uint8)
        w, h = ctypes.c_int(), ctypes.c_int()
        ptr = arr.ctypes.data_as(ctypes.c_void_p)
        if lib.hmm_jpeg_decode(ptr, len(data), None, ctypes.byref(w), ctypes.byref(h)) == 0:
            out = np.empty((h.value, w.value, 3), dtype=np.uint8)
            rc = lib.hmm_jpeg_decode(ptr, len(data), out.ctypes.data_as(ctypes.c_void_p),
                                     ctypes.byref(w), ctypes.byref(h))
            if rc == 0:
                return out
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 90) -> None:
    with open(path, "wb") as f:
        f.write(jpeg_encode(rgb, quality))


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return jpeg_decode(f.read())


# ---------------------------------------------------------------------------
# WAV (PCM) — numpy, no soundfile dependency
# ---------------------------------------------------------------------------


def write_wav(path: str, pcm: np.ndarray, sample_rate: int = 16000) -> None:
    """float32 [-1,1] (N,) or (N, C) -> 16-bit PCM WAV."""
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    data = np.clip(np.round(pcm * 32767.0), -32768, 32767).astype("<i2")
    n, c = data.shape
    byte_rate = sample_rate * c * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + n * c * 2))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, c, sample_rate, byte_rate, c * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", n * c * 2))
        f.write(data.tobytes())


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """WAV -> (float32 (N, C), sample_rate). Supports PCM16/24/32 + float32."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a WAV file: {path}")
        fmt = None
        fmt_payload = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            payload = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
                fmt_payload = payload
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"malformed WAV: {path}")
        audio_fmt, channels, rate, _, _, bits = fmt
        if audio_fmt == 0xFFFE and fmt_payload is not None and len(fmt_payload) >= 26:
            # WAVE_FORMAT_EXTENSIBLE: the real format is the first two bytes
            # of the SubFormat GUID (payload offset 24)
            audio_fmt = struct.unpack("<H", fmt_payload[24:26])[0]
        if audio_fmt == 3 and bits == 32:
            arr = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif bits == 16:
            arr = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            arr = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            arr = ints.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported WAV format {audio_fmt}/{bits}bit")
        return arr.reshape(-1, channels), rate


def load_audio_mono16k(path: str) -> np.ndarray:
    """WAV -> 16 kHz mono float32, the framework's canonical audio form."""
    audio, rate = read_wav(path)
    mono = audio.mean(axis=1)
    if rate != 16000:
        if rate > 16000:
            # low-pass below the new Nyquist before resampling: bare np.interp
            # would alias everything above 8 kHz back into the band
            cutoff = 0.45 * 16000 / rate  # normalized to the input rate
            taps = 101
            n = np.arange(taps) - (taps - 1) / 2
            h = 2 * cutoff * np.sinc(2 * cutoff * n) * np.kaiser(taps, 8.6)
            h /= h.sum()
            mono = np.convolve(mono, h.astype(np.float32), mode="same")
        n_out = int(round(len(mono) * 16000 / rate))
        x_old = np.arange(len(mono)) / rate
        x_new = np.arange(n_out) / 16000.0
        mono = np.interp(x_new, x_old, mono).astype(np.float32)
    return mono.astype(np.float32)


def demux_audio(path: str, t0: float = 0.0, t1: float = -1.0) -> Optional[np.ndarray]:
    """Container audio track -> 16 kHz mono float32 over [t0, t1) (t1 < 0:
    to the end), in process through the libav shim. None when the container
    has no (decodable) audio."""
    lib = _need_libav(f"audio demux of {path}")
    n = ctypes.c_int64()
    h = lib.hmm_av_audio_decode(path.encode(), float(t0), float(t1), ctypes.byref(n))
    if not h:
        return None
    if n.value <= 0:
        lib.hmm_av_audio_free(h)
        return None
    out = np.empty(n.value, dtype=np.float32)
    lib.hmm_av_audio_take(h, out.ctypes.data_as(ctypes.c_void_p))
    return out


# ---------------------------------------------------------------------------
# Y4M (YUV4MPEG2, 420 planar)
# ---------------------------------------------------------------------------


@dataclass
class VideoInfo:
    width: int
    height: int
    fps: float
    num_frames: int
    duration: float
    has_audio: bool = False


def _luma_u8(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> uint8 luma (BT.601, 16-bit fixed point)."""
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).astype(np.uint8)


def _yuv420_to_rgb_np(
    y: np.ndarray, u: np.ndarray, v: np.ndarray, limited: bool = False
) -> np.ndarray:
    """Host BT.601 full-range YUV420 -> RGB (inverse of _rgb_to_yuv420_np).
    The reference of the Y4M read path: `Y4MReader.read_rgb` converts with
    the native `hmm_yuv420_to_rgb_batch` (csrc/media_resize.cpp), which is
    bit-equal to this, and with this only where that library did not build.
    float32 throughout: each Python-float constant is rounded to float32
    first, products are not fused into sums, rounding is half to even."""
    yf = y.astype(np.float32)
    uf = np.repeat(np.repeat(u.astype(np.float32), 2, axis=1), 2, axis=2) - 128.0
    vf = np.repeat(np.repeat(v.astype(np.float32), 2, axis=1), 2, axis=2) - 128.0
    if limited:  # studio swing (16-235 / 16-240) -> full before the matrix
        yf = (yf - 16.0) * (255.0 / 219.0)
        uf = uf * (255.0 / 224.0)
        vf = vf * (255.0 / 224.0)
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


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


class ArrayFrameBlock:
    """read_block facade over eagerly decoded RGB (the AVI reader)."""

    def __init__(self, gray: np.ndarray, rgb: np.ndarray):
        self.gray = gray
        self._rgb = rgb

    def take_rgb(self, js) -> np.ndarray:
        return self._rgb[np.asarray(js, dtype=np.int64)]

    def close(self) -> None:
        self._rgb = None


class _LazyFrameBlock:
    """read_block facade for random-access readers (Y4M): RGB fetched per
    selected frame only."""

    def __init__(self, gray: np.ndarray, fetch):
        self.gray = gray
        self._fetch = fetch

    def take_rgb(self, js) -> np.ndarray:
        return self._fetch(list(np.asarray(js, dtype=np.int64)))

    def close(self) -> None:
        self._fetch = None


class Y4MReader:
    """Uncompressed YUV420 container: frame-exact random access by pointer
    arithmetic."""

    def __init__(self, path: str):
        self.path = path
        self.limited_range = False  # the writer emits full range
        with open(path, "rb") as f:
            header = f.readline()
        if not header.startswith(b"YUV4MPEG2"):
            raise ValueError(f"not a y4m file: {path}")
        self._data_start = len(header)
        self.width = self.height = 0
        num, den = 30, 1
        for tok in header.split()[1:]:
            t = tok.decode()
            if t[0] == "W":
                self.width = int(t[1:])
            elif t[0] == "H":
                self.height = int(t[1:])
            elif t[0] == "F":
                num, den = map(int, t[1:].split(":"))
            elif t[0] == "C" and not t[1:].startswith("420"):
                raise ValueError(f"only 420 chroma supported, got {t}")
            elif t.startswith("XCOLORRANGE="):
                self.limited_range = t.split("=", 1)[1].upper() == "LIMITED"
        self.fps = num / den
        self._ysize = self.width * self.height
        self._csize = (self.width // 2) * (self.height // 2)
        self._frame_bytes = len(b"FRAME\n") + self._ysize + 2 * self._csize
        total = os.path.getsize(path) - self._data_start
        self.num_frames = total // self._frame_bytes
        # pointer arithmetic assumes every frame header is exactly "FRAME\n";
        # per-frame parameters ("FRAME <params>\n") would shift every plane
        with open(path, "rb") as f:
            f.seek(self._data_start)
            first = f.read(6)
            if self.num_frames and first != b"FRAME\n":
                raise ValueError(
                    f"y4m with per-frame parameters unsupported: {path!r} "
                    f"(frame header {first!r})"
                )

    @property
    def info(self) -> VideoInfo:
        return VideoInfo(
            self.width, self.height, self.fps, self.num_frames, self.num_frames / self.fps
        )

    def _read_payloads(self, indices: Sequence[int]) -> np.ndarray:
        """(N, Y + U + V bytes) uint8: each frame's planes as the file holds them."""
        n = len(indices)
        size = self._ysize + 2 * self._csize
        buf = np.empty((n, size), dtype=np.uint8)
        with open(self.path, "rb") as f:
            for i, idx in enumerate(indices):
                if not 0 <= idx < self.num_frames:
                    raise IndexError(idx)
                f.seek(self._data_start + idx * self._frame_bytes + len(b"FRAME\n"))
                if f.readinto(memoryview(buf[i])) != size:
                    raise ValueError(f"y4m frame {idx} truncated: {self.path!r}")
        return buf

    def read_yuv(self, indices: Sequence[int]):
        """Returns (Y (N,H,W), U (N,H/2,W/2), V (N,H/2,W/2)) uint8."""
        buf = self._read_payloads(indices)
        n, hw, ch = len(buf), (self.height, self.width), (self.height // 2, self.width // 2)
        y = buf[:, : self._ysize].reshape(n, *hw).copy()
        u = buf[:, self._ysize : self._ysize + self._csize].reshape(n, *ch).copy()
        v = buf[:, self._ysize + self._csize :].reshape(n, *ch).copy()
        return y, u, v

    def read_rgb(self, indices: Sequence[int]) -> np.ndarray:
        """(N, H, W, 3) uint8. One native call converts the frames' planes
        where the host conversion library built, with the interpreter lock
        released; `_yuv420_to_rgb_np` otherwise. Both give the same bytes.
        Spanned as `media.y4m_rgb` and counted in `media.y4m_rgb_frames`
        and `media.y4m_rgb_native_frames`."""
        from hippomm_tpu_torch.ops._native import resize_lib
        from hippomm_tpu_torch.utils import timers

        n, h, w = len(indices), self.height, self.width
        with timers.span("media.y4m_rgb"):
            lib = resize_lib()
            if lib is None:
                y, u, v = self.read_yuv(indices)
                rgb = _yuv420_to_rgb_np(y, u, v, limited=self.limited_range)
            else:
                buf = self._read_payloads(indices)
                rgb = np.empty((n, h, w, 3), dtype=np.uint8)
                base, stride = buf.ctypes.data, buf.shape[1]
                rc = lib.hmm_yuv420_to_rgb_batch(
                    base, base + self._ysize, base + self._ysize + self._csize, n, h, w,
                    stride, stride, int(self.limited_range), rgb.ctypes.data,
                )
                if rc != 0:
                    raise RuntimeError(f"hmm_yuv420_to_rgb_batch failed with code {rc}")
        timers.count("media.y4m_rgb_frames", n)
        timers.count("media.y4m_rgb_native_frames", 0 if lib is None else n)
        return rgb

    def read_gray_small(self, indices: Sequence[int], gh: int, gw: int) -> np.ndarray:
        """Scoring-resolution luma: reads only the Y plane (the luma is the
        gray channel in y4m), skipping chroma IO entirely."""
        n = len(indices)
        y = np.empty((n, self.height, self.width), dtype=np.uint8)
        with open(self.path, "rb") as f:
            for i, idx in enumerate(indices):
                if not 0 <= idx < self.num_frames:
                    raise IndexError(idx)
                f.seek(self._data_start + idx * self._frame_bytes + len(b"FRAME\n"))
                y[i] = np.frombuffer(f.read(self._ysize), np.uint8).reshape(
                    self.height, self.width
                )
        return _box_downscale(y, gh, gw)

    def read_block(self, indices: Sequence[int], gh: int, gw: int, skip_nonref: bool = False):
        """Y-plane luma eagerly; RGB per selected frame (random access is free)."""
        idx = list(indices)
        gray = self.read_gray_small(idx, gh, gw)
        return _LazyFrameBlock(gray, lambda js: self.read_rgb([idx[j] for j in js]))

    def close(self):
        pass


def _rgb_to_yuv420_np(rgb: np.ndarray):
    """Host BT.601 full-range RGB→YUV420 in 16-bit fixed point (the write
    path: fixtures and tooling)."""
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    u = (-11058 * r.astype(np.int32) - 21710 * g.astype(np.int32) + 32768 * b.astype(np.int32) + (128 << 16) + 32768) >> 16
    v = (32768 * r.astype(np.int32) - 27440 * g.astype(np.int32) - 5328 * b.astype(np.int32) + (128 << 16) + 32768) >> 16

    def down2(x):
        n, h, w = x.shape
        x = x.reshape(n, h // 2, 2, w // 2, 2).astype(np.uint32)
        return (x.sum(axis=(2, 4)) + 2) >> 2

    to_u8 = lambda x: np.clip(x, 0, 255).astype(np.uint8)  # noqa: E731
    return to_u8(y), to_u8(down2(np.clip(u, 0, 255))), to_u8(down2(np.clip(v, 0, 255)))


class Y4MWriter:
    """Streaming y4m 420 writer (BT.601 full-range): the header once, then
    frames appended chunk by chunk, so a long clip is never held whole. The
    bytes equal `write_y4m` of all the frames at once."""

    def __init__(self, path: str, width: int, height: int, fps: float):
        from fractions import Fraction

        fr = Fraction(fps).limit_denominator(1000)
        self._f = open(path, "wb")
        self._f.write(f"YUV4MPEG2 W{width} H{height} F{fr.numerator}:{fr.denominator} Ip A1:1 C420\n".encode())

    def write_video(self, frames_rgb: np.ndarray) -> None:
        y, u, v = _rgb_to_yuv420_np(np.asarray(frames_rgb))
        for i in range(len(y)):
            self._f.write(b"FRAME\n")
            self._f.write(y[i].tobytes())
            self._f.write(u[i].tobytes())
            self._f.write(v[i].tobytes())

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_y4m(path: str, frames_rgb: np.ndarray, fps: float = 30.0) -> None:
    """(N, H, W, 3) uint8 RGB -> y4m 420 file (BT.601 full-range)."""
    n, h, w, _ = frames_rgb.shape
    with Y4MWriter(path, w, h, fps) as wr:
        wr.write_video(frames_rgb)


# ---------------------------------------------------------------------------
# MJPEG-AVI via the media shim
# ---------------------------------------------------------------------------


class AviReader:
    def __init__(self, path: str):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native media shim required for AVI decode")
        self._lib = lib
        self._h = lib.hmm_avi_open(path.encode())
        if not self._h:
            raise ValueError(f"cannot open AVI: {path}")
        w, hh = ctypes.c_int(), ctypes.c_int()
        fps, nf = ctypes.c_double(), ctypes.c_int64()
        lib.hmm_avi_info(self._h, ctypes.byref(w), ctypes.byref(hh), ctypes.byref(fps), ctypes.byref(nf))
        self.width, self.height, self.fps = w.value, hh.value, fps.value
        self.num_frames = nf.value

    @property
    def info(self) -> VideoInfo:
        return VideoInfo(
            self.width, self.height, self.fps, self.num_frames, self.num_frames / self.fps
        )

    def read_rgb(self, indices: Sequence[int]) -> np.ndarray:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx), self.height, self.width, 3), dtype=np.uint8)
        rc = self._lib.hmm_avi_read_indices(
            self._h, idx.ctypes.data_as(ctypes.c_void_p), len(idx),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise RuntimeError(f"AVI decode failed rc={rc}")
        return out

    def read_gray_small(self, indices: Sequence[int], gh: int, gw: int) -> np.ndarray:
        return _box_downscale(_luma_u8(self.read_rgb(indices)), gh, gw)

    def read_gray_rgb(self, indices: Sequence[int], gh: int, gw: int):
        rgb = self.read_rgb(indices)
        return _box_downscale(_luma_u8(rgb), gh, gw), rgb

    def read_block(self, indices: Sequence[int], gh: int, gw: int, skip_nonref: bool = False):
        gray, rgb = self.read_gray_rgb(indices, gh, gw)
        return ArrayFrameBlock(gray, rgb)

    def close(self):
        if self._h:
            self._lib.hmm_avi_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def write_avi(path: str, frames_rgb: np.ndarray, fps: float = 30.0, quality: int = 90) -> None:
    lib = _lib()
    if lib is None:
        raise RuntimeError("native media shim required for AVI encode")
    n, h, w, _ = frames_rgb.shape
    wh = lib.hmm_avi_writer_open(path.encode(), w, h, float(fps), quality)
    if not wh:
        raise RuntimeError(f"cannot open AVI writer: {path}")
    frames_rgb = np.ascontiguousarray(frames_rgb, dtype=np.uint8)
    try:
        for i in range(n):
            rc = lib.hmm_avi_writer_write(wh, frames_rgb[i].ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise RuntimeError(f"AVI encode failed rc={rc}")
    finally:
        rc = lib.hmm_avi_writer_close(wh)
        if rc != 0:
            raise RuntimeError(f"AVI finalize failed rc={rc}")


# ---------------------------------------------------------------------------
# Libav containers (.mp4/.mov/.mkv/.webm, non-MJPEG .avi) via the libav shim
# ---------------------------------------------------------------------------


class _NativeFrameBlock:
    """read_block facade over refcounted AVFrames the libav shim holds: RGB
    converted only for the frames taken."""

    def __init__(self, lib, handle, gray: np.ndarray, height: int, width: int, reader):
        self._lib = lib
        self._handle = handle
        self.gray = gray
        self._hw = (height, width)
        # the C block holds a bare pointer to the reader's decoder state: keep
        # the reader alive for the block's lifetime
        self._reader = reader

    def take_rgb(self, js) -> np.ndarray:
        js = np.ascontiguousarray(js, dtype=np.int64)
        out = np.empty((len(js), self._hw[0], self._hw[1], 3), dtype=np.uint8)
        rc = self._lib.hmm_av_block_take_rgb(
            self._handle, js.ctypes.data_as(ctypes.c_void_p), len(js),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise RuntimeError(f"block rgb take failed rc={rc}")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.hmm_av_block_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class LibavReader:
    """Demux and decode any container libav reads (H.264/HEVC/VP9/MPEG-4 ...).

    Frames are addressed by index through presentation timestamps (near
    constant frame rate assumed, as the reference's CAP_PROP_POS_MSEC
    arithmetic does). The shim reads ascending indices in one forward pass;
    any order, and duplicates, are handled here by sort + inverse
    permutation."""

    def __init__(self, path: str):
        lib = _need_libav(f"libav decode of {path}")
        self._lib = lib
        self.path = path
        self._h = lib.hmm_av_open(path.encode())
        if not self._h:
            raise ValueError(f"cannot open video: {path}")
        w, hh, ha = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        fps, dur, nf = ctypes.c_double(), ctypes.c_double(), ctypes.c_int64()
        lib.hmm_av_info(self._h, ctypes.byref(w), ctypes.byref(hh), ctypes.byref(fps),
                        ctypes.byref(dur), ctypes.byref(nf), ctypes.byref(ha))
        self.width, self.height, self.fps = w.value, hh.value, fps.value
        self.num_frames = max(1, nf.value)
        self.duration = dur.value if dur.value > 0 else self.num_frames / max(self.fps, 1e-9)
        self.has_audio = bool(ha.value)

    @property
    def info(self) -> VideoInfo:
        return VideoInfo(
            self.width, self.height, self.fps, self.num_frames, self.duration, self.has_audio
        )

    def _sorted_unique(self, indices):
        idx = np.clip(np.asarray(indices, dtype=np.int64), 0, self.num_frames - 1)
        return np.unique(idx, return_inverse=True)

    def read_rgb(self, indices: Sequence[int], _parallel: bool = True) -> np.ndarray:
        uniq, inverse = self._sorted_unique(indices)
        out = np.empty((len(uniq), self.height, self.width, 3), dtype=np.uint8)
        # a sparse set spread over a long stream (the key-frame fetch) pays a
        # seek and a decode forward per index: split it across readers on
        # threads (the shim's calls release the GIL under ctypes)
        spread = (
            _parallel
            and (os.cpu_count() or 1) > 1
            and len(uniq) >= 8
            and (uniq[-1] - uniq[0]) > 16 * max(1, len(uniq))
        )
        if spread:
            import concurrent.futures

            nw = min(4, len(uniq) // 4)
            bounds = np.linspace(0, len(uniq), nw + 1).astype(int)

            def work(w):
                lo, hi = bounds[w], bounds[w + 1]
                if hi <= lo:
                    return
                r = LibavReader(self.path)
                try:
                    out[lo:hi] = r.read_rgb(uniq[lo:hi], _parallel=False)
                finally:
                    r.close()

            with concurrent.futures.ThreadPoolExecutor(max_workers=nw) as ex:
                list(ex.map(work, range(nw)))
            return out[inverse]
        rc = self._lib.hmm_av_read_rgb_indices(
            self._h, uniq.ctypes.data_as(ctypes.c_void_p), len(uniq),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise RuntimeError(f"libav decode failed rc={rc}")
        return out[inverse]

    def read_gray_small(self, indices: Sequence[int], gh: int, gw: int) -> np.ndarray:
        """Decode and scale to the scoring resolution in C++ (SWS_AREA)."""
        uniq, inverse = self._sorted_unique(indices)
        out = np.empty((len(uniq), gh, gw), dtype=np.uint8)
        rc = self._lib.hmm_av_read_gray_indices(
            self._h, uniq.ctypes.data_as(ctypes.c_void_p), len(uniq), gw, gh,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise RuntimeError(f"libav gray decode failed rc={rc}")
        return out[inverse]

    def read_block(self, indices: Sequence[int], gh: int, gw: int, skip_nonref: bool = False):
        """Decode a sorted candidate block once: the scoring luma eagerly, RGB
        per taken frame from AVFrames the shim holds. `skip_nonref` skips
        frames nothing references (B-frames); a wanted index on a skipped
        frame clamps to the nearest decoded reference frame."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        gray = np.empty((len(idx), gh, gw), dtype=np.uint8)
        handle = ctypes.c_void_p()
        rc = self._lib.hmm_av_read_block_hold(
            self._h, idx.ctypes.data_as(ctypes.c_void_p), len(idx), gw, gh,
            1 if skip_nonref else 0, gray.ctypes.data_as(ctypes.c_void_p), ctypes.byref(handle),
        )
        if rc != 0:
            raise RuntimeError(f"libav block decode failed rc={rc}")
        return _NativeFrameBlock(self._lib, handle, gray, self.height, self.width, reader=self)

    def close(self):
        if self._h:
            self._lib.hmm_av_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class LibavWriter:
    """Streaming encoder: RGB frames + mono PCM -> mp4/mov/mkv/avi (H.264
    through libx264 where the host's libavcodec has it, else MPEG-4; AAC
    audio); `codec` names another video encoder."""

    def __init__(self, path: str, width: int, height: int, fps: float, sample_rate: int = 0,
                 codec: str = ""):
        lib = _need_libav(f"libav encode of {path}")
        self._lib = lib
        self._h = lib.hmm_av_writer_open(path.encode(), width, height, float(fps),
                                         int(sample_rate), codec.encode())
        if not self._h:
            raise RuntimeError(f"cannot open encoder for {path}")

    def write_video(self, frames_rgb: np.ndarray) -> None:
        frames_rgb = np.ascontiguousarray(frames_rgb, dtype=np.uint8)
        if frames_rgb.ndim == 3:
            frames_rgb = frames_rgb[None]
        for fr in frames_rgb:
            rc = self._lib.hmm_av_writer_video(self._h, fr.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise RuntimeError(f"video encode failed rc={rc}")

    def write_audio(self, pcm: np.ndarray) -> None:
        pcm = np.ascontiguousarray(pcm, dtype=np.float32)
        rc = self._lib.hmm_av_writer_audio(self._h, pcm.ctypes.data_as(ctypes.c_void_p), len(pcm))
        if rc != 0:
            raise RuntimeError(f"audio buffer failed rc={rc}")

    def close(self) -> None:
        if self._h:
            rc = self._lib.hmm_av_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise RuntimeError(f"encoder finalize failed rc={rc}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_video_av(path: str, frames_rgb: np.ndarray, fps: float = 30.0,
                   audio: Optional[np.ndarray] = None, sample_rate: int = 16000,
                   codec: str = "") -> None:
    """One-shot encode of (N, H, W, 3) uint8 RGB (+ optional mono float PCM)."""
    n, h, w, _ = frames_rgb.shape
    wr = LibavWriter(path, w, h, fps, sample_rate if audio is not None else 0, codec)
    try:
        if audio is not None:
            wr.write_audio(audio)
        wr.write_video(frames_rgb)
    finally:
        wr.close()


# ---------------------------------------------------------------------------
# Unified video interface
# ---------------------------------------------------------------------------


def open_video(path: str):
    """A reader with .info, .read_rgb(indices), .read_gray_small(...) and
    .read_block(...). OSError for a path that names no file."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        return Y4MReader(path)
    if ext == ".avi":
        try:
            return AviReader(path)  # the MJPEG writer's own files
        except ValueError:
            return LibavReader(path)  # any other AVI codec
    if ext in LIBAV_EXTENSIONS:
        return LibavReader(path)
    raise ValueError(
        f"unsupported video container: {ext} "
        f"(supported: .y4m, .avi, {', '.join(LIBAV_EXTENSIONS)})"
    )


def probe_video(path: str) -> VideoInfo:
    r = open_video(path)
    try:
        return r.info
    finally:
        r.close()


def sample_indices_at_fps(info: VideoInfo, target_fps: float) -> List[int]:
    """Frame indices approximating uniform target_fps sampling."""
    if target_fps <= 0 or target_fps >= info.fps:
        return list(range(info.num_frames))
    step = info.fps / target_fps
    idx = np.round(np.arange(0, info.num_frames, step)).astype(int)
    return sorted(set(int(i) for i in idx if i < info.num_frames))


def read_frames_at_times(path: str, times: Sequence[float]) -> np.ndarray:
    """Decode the frames nearest the given timestamps."""
    r = open_video(path)
    try:
        idx = [min(r.info.num_frames - 1, max(0, int(round(t * r.info.fps)))) for t in times]
        return r.read_rgb(idx)
    finally:
        r.close()
