"""Plain statements of the ingest path's media stages, for the reference.

Readers of the Y4M and WAV bytes both sides read; BT.601 full-range YUV
4:2:0 to RGB; the key-frame walk (SSIM of each ~1 Hz candidate's luma,
90×160 box-averaged, against the last kept frame; a frame is kept when
that dissimilarity, or its running sum since the last keep, passes 0.3,
at most once per second) and the segmentation (30 s windows cut at the
latest dissimilar key-frame pair or silent 500 ms window after the first
10 s); ImageBind's image transform (bicubic short-side resize, centre crop,
CLIP normalisation) and audio transform (three 2 s clips per segment,
Kaldi fbank, AST normalisation); Whisper's log-mel. SSIM is skimage's
(7×7 uniform window, sample covariance) in float64.

The walks are checked, not re-run: the program's decisions are followed,
and a decision counts as a fault only where the reference's score lies on
the other side of the threshold by more than `MARGIN`, so that float32
rounding of a score that sits on a threshold is not called a fault.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

MARGIN = 1e-3
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073])
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711])


# --------------------------------------------------------------- readers


class Y4M:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            header = f.readline()
        tok = {t[:1]: t[1:] for t in header.decode().split()[1:]}
        self.width, self.height = int(tok["W"]), int(tok["H"])
        num, den = map(int, tok["F"].split(":"))
        self.fps = num / den
        self._start = len(header)
        self._plane = self.width * self.height
        self._frame = 6 + self._plane * 3 // 2
        import os

        self.num_frames = (os.path.getsize(path) - self._start) // self._frame

    @property
    def duration(self) -> float:
        return self.num_frames / self.fps

    def _read(self, i: int, nbytes: int) -> np.ndarray:
        with open(self.path, "rb") as f:
            f.seek(self._start + i * self._frame + 6)
            return np.frombuffer(f.read(nbytes), np.uint8)

    def luma(self, i: int) -> np.ndarray:
        return self._read(i, self._plane).reshape(self.height, self.width)

    def rgb(self, i: int) -> np.ndarray:
        buf = self._read(i, self._plane * 3 // 2)
        h, w = self.height, self.width
        y = buf[: h * w].reshape(h, w).astype(np.float64)
        u = buf[h * w: h * w * 5 // 4].reshape(h // 2, w // 2).astype(np.float64) - 128.0
        v = buf[h * w * 5 // 4:].reshape(h // 2, w // 2).astype(np.float64) - 128.0
        u = u.repeat(2, 0).repeat(2, 1)
        v = v.repeat(2, 0).repeat(2, 1)
        rgb = np.stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v, y + 1.772 * u], -1)
        return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def read_wav(path: str) -> np.ndarray:
    """16-bit PCM mono WAV -> float32 in [-1, 1)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, pcm = 12, None
    while pos + 8 <= len(data):
        cid, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if cid == b"data":
            pcm = np.frombuffer(data[pos + 8: pos + 8 + size], "<i2")
        pos += 8 + size + (size & 1)
    return pcm.astype(np.float32) / 32768.0


def box_luma(y: np.ndarray, gh: int, gw: int) -> np.ndarray:
    """Area average to (gh, gw), rounded to the nearest level."""
    h, w = y.shape
    fh, fw = h // gh, w // gw
    s = y.reshape(gh, fh, gw, fw).astype(np.int64).sum(axis=(1, 3))
    return ((s + fh * fw // 2) // (fh * fw)).astype(np.uint8)


# ------------------------------------------------------------------ SSIM


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """skimage.metrics.structural_similarity(a, b, data_range=255) for 2-D
    uint8 images: 7×7 uniform window, sample covariance, mean over the
    valid region."""
    x, y = a.astype(np.float64), b.astype(np.float64)
    win = 7

    def mean(z):
        c = np.pad(z.cumsum(0).cumsum(1), ((1, 0), (1, 0)))
        return (c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win]) / win ** 2

    n = win * win
    ux, uy = mean(x), mean(y)
    vx = n / (n - 1) * (mean(x * x) - ux * ux)
    vy = n / (n - 1) * (mean(y * y) - uy * uy)
    vxy = n / (n - 1) * (mean(x * y) - ux * uy)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return float(s.mean())


def keyframe_faults(lumas: Sequence[np.ndarray], times: Sequence[float], kept: Sequence[int],
                    thr: float = 0.3, gap: float = 1.0) -> int:
    """Decisions of the program's key-frame walk over the candidates that
    the reference scores on the wrong side of the threshold by more than
    MARGIN (the walk follows the program's decisions)."""
    kept = set(int(i) for i in kept)
    faults = 0
    ref, cum, tlast = None, 0.0, -1e9
    for i, (g, t) in enumerate(zip(lumas, times)):
        save = i in kept
        if ref is None:
            faults += 0 if save else 1
        elif t - tlast < gap:
            faults += 1 if save else 0
        else:
            diff = 1.0 - ssim(ref, g)
            score = max(diff, cum + diff)
            if save and score < thr - MARGIN:
                faults += 1
            if not save and score > thr + MARGIN:
                faults += 1
            cum = cum + diff
        if save or ref is None:
            ref, cum, tlast = g, 0.0, t
    return faults


def window_db(pcm: np.ndarray, win: int, hop: int) -> np.ndarray:
    """RMS level in dBFS of each win-sample window at hop, floored at -100."""
    sq = np.square(pcm.astype(np.float64))
    c = np.concatenate([[0.0], np.cumsum(sq)])
    starts = np.arange(1 + (len(pcm) - win) // hop) * hop
    rms = np.sqrt(np.maximum(c[starts + win] - c[starts], 0.0) / win)
    return np.maximum(20 * np.log10(np.maximum(rms, 1e-10)), -100.0)


def cut_faults(cuts: Sequence[float], frame_times: Sequence[float], frame_ssim: Sequence[float],
               db: np.ndarray, duration: float, max_seg: float = 30.0, min_seg: float = 10.0,
               ssim_thr: float = 0.95, silence_db: float = -40.0, hop_s: float = 0.1,
               win_s: float = 0.5) -> int:
    """Cuts of the program's segmentation that the reference would not
    make: each window (start+min, start+max] cuts at its latest dissimilar
    key-frame pair or silent window, else at its end. A pair whose SSIM
    lies within MARGIN of the threshold may count either way. The walk
    follows the program's cuts; a missing or extra cut is one fault."""
    ft = np.asarray(frame_times, np.float64)
    fs = np.asarray(frame_ssim, np.float64)
    wt = np.arange(len(db)) * hop_s + win_s / 2
    faults, start, k = 0, 0.0, 0
    cuts = list(cuts)
    while duration - start > max_seg:
        lo, hi = start + min_seg, start + max_seg
        sure, maybe = [], []
        if len(fs):
            pt = ft[1:]
            inwin = (pt > lo) & (pt <= hi)
            sure += list(pt[inwin & (fs < ssim_thr - MARGIN)])
            maybe += list(pt[inwin & (np.abs(fs - ssim_thr) <= MARGIN)])
        sil = wt[(wt > lo) & (wt <= hi) & (db < silence_db)]
        sure += list(sil)
        best = max(sure) if sure else None
        allowed = {hi if best is None else best} | {m for m in maybe if best is None or m > best}
        if k >= len(cuts):
            return faults + 1
        got = cuts[k]
        if not any(abs(got - a) < 1e-6 for a in allowed):
            faults += 1
        start, k = got, k + 1
    return faults + (len(cuts) - k)


# ------------------------------------------------------------- ImageBind in


def image_tensor(rgb: np.ndarray, size: int = 224) -> torch.Tensor:
    """(H, W, 3) uint8 -> (3, size, size) float32: short side to `size`
    (bicubic, long side truncated), centre crop, CLIP normalisation."""
    from PIL import Image

    h, w = rgb.shape[:2]
    if h <= w:
        nh, nw = size, max(size, int(w * size / h))
    else:
        nh, nw = max(size, int(h * size / w)), size
    im = Image.fromarray(rgb)
    if (nw, nh) != (w, h):
        im = im.resize((nw, nh), Image.BICUBIC)
    top, left = (nh - size) // 2, (nw - size) // 2
    crop = np.asarray(im)[top:top + size, left:left + size].astype(np.float64) / 255.0
    return torch.from_numpy(((crop - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1).astype(np.float32))


def _hz_to_mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def kaldi_melbank(bins: int, nfft: int = 512, sr: int = 16000, low: float = 20.0) -> np.ndarray:
    """Kaldi's triangular mel bins (HTK mel, not area-normalised), (bins, nfft/2+1)."""
    lo, hi = _hz_to_mel_htk(low), _hz_to_mel_htk(sr / 2)
    delta = (hi - lo) / (bins + 1)
    mel = _hz_to_mel_htk(np.arange(nfft // 2) * sr / nfft)
    out = np.zeros((bins, nfft // 2 + 1))
    for b in range(bins):
        left, center, right = lo + b * delta, lo + (b + 1) * delta, lo + (b + 2) * delta
        up = (mel - left) / (center - left)
        down = (right - mel) / (right - center)
        out[b, : nfft // 2] = np.maximum(0.0, np.minimum(up, down))
    return out


def fbank(clips: torch.Tensor, bins: int = 128) -> torch.Tensor:
    """Kaldi fbank of (N, S) clips: 25 ms frames at 10 ms (snip edges), DC
    removed, pre-emphasis 0.97, symmetric Hann, 512-point power spectrum,
    log mel energies -> (N, frames, bins)."""
    frame, hop = 400, 160
    t = 1 + (clips.shape[1] - frame) // hop
    fr = clips.double().unfold(1, frame, hop)[:, :t]
    fr = fr - fr.mean(dim=-1, keepdim=True)
    prev = torch.cat([fr[..., :1], fr[..., :-1]], dim=-1)
    fr = fr - 0.97 * prev
    n = torch.arange(frame, dtype=torch.float64, device=clips.device)
    fr = fr * (0.5 - 0.5 * torch.cos(2 * math.pi * n / (frame - 1)))
    power = torch.fft.rfft(fr, n=512).abs() ** 2
    mb = torch.from_numpy(kaldi_melbank(bins)).to(clips.device)
    mel = power @ mb.t()
    return torch.log(torch.clamp(mel, min=float(np.finfo(np.float32).eps))).float()


def audio_clips(seg: np.ndarray, clips: int = 3, clip_s: float = 2.0, sr: int = 16000) -> np.ndarray:
    """A segment's audio, peak-normalised, as pytorchvideo's constant clip
    sampler takes it: starts span·i/clips."""
    n = int(clip_s * sr)
    pcm = seg.astype(np.float32) / (float(np.max(np.abs(seg))) or 1.0)
    if len(pcm) < n:
        pcm = np.pad(pcm, (0, n - len(pcm)))
    span = max(0, len(pcm) - n)
    starts = (span * np.arange(clips) / clips).astype(int)
    return np.stack([pcm[s:s + n] for s in starts])


def audio_tensor(seg: np.ndarray, cfg: Dict, device) -> torch.Tensor:
    """One segment -> (clips, mel, T) normalized fbank."""
    ib = cfg["imagebind"]
    c = torch.from_numpy(audio_clips(seg, ib["audio_clips"], ib["audio_clip_s"])).to(device)
    f = fbank(c, ib["audio_mel_bins"]).transpose(1, 2)  # (clips, mel, frames)
    t = ib["audio_target_len"]
    f = torch.nn.functional.pad(f, (0, max(0, t - f.shape[2])))[:, :, :t]
    return (f - (-4.268)) / (9.138 * 2)


def slaney_melbank(n_mels: int, nfft: int = 400, sr: int = 16000) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels) (Slaney scale and norm)."""
    def hz2mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), lin)

    def mel2hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), m * 200.0 / 3)

    freqs = np.linspace(0, sr / 2, nfft // 2 + 1)
    pts = mel2hz(np.linspace(hz2mel(0.0), hz2mel(sr / 2), n_mels + 2))
    out = np.zeros((n_mels, len(freqs)))
    for i in range(n_mels):
        up = (freqs - pts[i]) / (pts[i + 1] - pts[i])
        down = (pts[i + 2] - freqs) / (pts[i + 2] - pts[i + 1])
        out[i] = np.maximum(0, np.minimum(up, down)) * 2.0 / (pts[i + 2] - pts[i])
    return out


def whisper_mel(chunks: torch.Tensor, n_mels: int) -> torch.Tensor:
    """whisper.log_mel_spectrogram of (B, 480000) chunks -> (B, n_mels, 3000):
    reflect-padded STFT (400, hop 160, periodic Hann), the last frame
    dropped, log10 clamped at 1e-10, floored 8 below each chunk's max,
    (x + 4) / 4."""
    win = torch.hann_window(400, periodic=True, dtype=torch.float64, device=chunks.device)
    spec = torch.stft(chunks.double(), 400, 160, window=win, center=True, pad_mode="reflect",
                      return_complex=True)
    power = spec.abs()[..., :-1] ** 2
    mb = torch.from_numpy(slaney_melbank(n_mels)).to(chunks.device)
    logs = torch.log10(torch.clamp(mb @ power, min=1e-10))
    logs = torch.maximum(logs, logs.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((logs + 4.0) / 4.0).float()


def asr_chunks(pcm: np.ndarray, chunk_s: float = 30.0, sr: int = 16000) -> np.ndarray:
    """The track in 30 s windows, the last zero-padded."""
    n = int(chunk_s * sr)
    out = []
    for s in range(0, max(1, len(pcm)), n):
        c = pcm[s:s + n]
        out.append(np.pad(c, (0, n - len(c))))
    return np.stack(out).astype(np.float32)


def candidates(num_frames: int, fps: float, interval: float = 1.0) -> Tuple[List[int], List[float]]:
    """The key-frame scan's candidates: every round(fps·interval)-th frame."""
    stride = max(1, int(round(fps * interval)))
    idx = list(range(0, num_frames, stride))
    return idx, [i / fps for i in idx]
