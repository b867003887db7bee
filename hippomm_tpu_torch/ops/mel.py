"""Log-mel frontends as fp32 device matmuls.

Counterpart of hippomm_tpu/ops/mel.py. Each frontend folds its per-frame
linear preprocessing with the real-DFT basis into two precomputed
(frame_len, n_bins) matrices, so it is

    frames (T, L) @ A_cos, A_sin → re² + im² → @ melbankᵀ → log

  * WhisperMel — periodic Hann(400), hop 160, reflect-pad centre, n_fft 400,
    Slaney mel (80 or 128 bins), log10 + dynamic-range compression
    (openai-whisper's log_mel_spectrogram).
  * KaldiFbank — 25 ms / 10 ms snip-edges framing, DC removal, preemphasis
    0.97, symmetric Hann window, pad-to-512 DFT, HTK mel, ln. Matches
    torchaudio.compliance.kaldi.fbank (dither=0) on unscaled [-1, 1] input
    (ImageBind's audio frontend).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hippomm_tpu_torch.ops.melbank import mel_filterbank_kaldi, mel_filterbank_slaney
from hippomm_tpu_torch.utils.device import as_tensors, resolve_device


def _rdft_matrices(frame_len: int, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis: (frame_len, n_fft//2+1) cos and -sin matrices."""
    n = np.arange(frame_len)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang), -np.sin(ang)


class WhisperMel:
    """Whisper log-mel frontend. n_mels=128 for the large-v3 family, 80
    otherwise. Its matrices live on `device` (None: CUDA)."""

    N_FFT = 400
    HOP = 160
    SAMPLE_RATE = 16000

    def __init__(self, n_mels: int = 128, device=None):
        self.n_mels = n_mels
        window = np.hanning(self.N_FFT + 1)[:-1]  # periodic hann
        cos, sin = _rdft_matrices(self.N_FFT, self.N_FFT)
        dev = resolve_device(device)
        self.a_cos = torch.from_numpy((window[:, None] * cos).astype(np.float32)).to(dev)
        self.a_sin = torch.from_numpy((window[:, None] * sin).astype(np.float32)).to(dev)
        self.melbank = torch.from_numpy(
            mel_filterbank_slaney(n_mels, self.N_FFT, self.SAMPLE_RATE).astype(np.float32)
        ).to(dev)

    def __call__(self, pcm) -> torch.Tensor:
        """pcm (..., N) fp32 in [-1, 1] -> (..., n_mels, N // HOP) log-mel.
        Leading dims batch (the JAX vmap): the max − 8 floor is taken per clip.
        An array goes to the frontend's device, a tensor stays on its own.

        whisper.log_mel_spectrogram: reflect-pad N_FFT//2 both sides, frame,
        DFT, drop the last frame, power, mel, log10 clamp, max − 8 floor,
        (x + 4) / 4."""
        (x,) = as_tensors(pcm, device=self.a_cos.device)
        x = x.float()
        lead = x.shape[:-1]
        x = x.reshape(-1, 1, x.shape[-1])
        pad = self.N_FFT // 2
        x = torch.nn.functional.pad(x, (pad, pad), mode="reflect")[:, 0]
        frames = x.unfold(-1, self.N_FFT, self.HOP)  # (B, T + 1, N_FFT)
        re = frames @ self.a_cos
        im = frames @ self.a_sin
        power = (re * re + im * im)[:, :-1]  # whisper drops the final frame
        mel = power @ self.melbank.t()
        log_spec = torch.log10(torch.clamp(mel, min=1e-10))
        floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
        log_spec = (torch.maximum(log_spec, floor) + 4.0) / 4.0
        return log_spec.transpose(-1, -2).reshape(*lead, self.n_mels, -1)


class KaldiFbank:
    """torchaudio.compliance.kaldi.fbank-compatible filterbank features. Its
    matrices live on `device` (None: CUDA)."""

    SAMPLE_RATE = 16000
    FRAME_LEN = 400  # 25 ms
    HOP = 160  # 10 ms
    PADDED = 512  # next pow2
    PREEMPH = 0.97
    LOW_FREQ = 20.0

    def __init__(self, num_mel_bins: int = 128, device=None):
        self.num_mel_bins = num_mel_bins
        L = self.FRAME_LEN
        D = np.eye(L) - np.full((L, L), 1.0 / L)
        P = np.eye(L)
        P[1:, : L - 1] -= self.PREEMPH * np.eye(L - 1)
        P[0, 0] -= self.PREEMPH  # kaldi: first sample preemphasized against itself
        window = np.hanning(L)  # symmetric — kaldi "hanning"
        WPD = window[:, None] * (P @ D)
        cos, sin = _rdft_matrices(L, self.PADDED)
        dev = resolve_device(device)
        self.a_cos = torch.from_numpy((WPD.T @ cos).astype(np.float32)).to(dev)
        self.a_sin = torch.from_numpy((WPD.T @ sin).astype(np.float32)).to(dev)
        self.melbank = torch.from_numpy(
            mel_filterbank_kaldi(num_mel_bins, self.PADDED, self.SAMPLE_RATE, self.LOW_FREQ)
            .astype(np.float32)
        ).to(dev)

    def num_frames(self, n_samples: int) -> int:
        if n_samples < self.FRAME_LEN:
            return 0
        return 1 + (n_samples - self.FRAME_LEN) // self.HOP

    def __call__(self, pcm) -> torch.Tensor:
        """pcm (..., N) fp32 in [-1, 1] -> (..., T, num_mel_bins) natural-log
        mel energies. Leading dims batch (the JAX vmap). No ×32768 rescale.
        An array goes to the frontend's device, a tensor stays on its own."""
        (x,) = as_tensors(pcm, device=self.a_cos.device)
        x = x.float()
        t = self.num_frames(x.shape[-1])
        frames = x.unfold(-1, self.FRAME_LEN, self.HOP)[..., :t, :]
        re = frames @ self.a_cos
        im = frames @ self.a_sin
        power = re * re + im * im
        mel = power @ self.melbank.t()
        eps = float(np.finfo(np.float32).eps)
        return torch.log(torch.clamp(mel, min=eps))
