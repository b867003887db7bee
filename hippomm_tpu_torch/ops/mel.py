"""Kaldi log-mel filterbank as fp32 device matmuls.

Counterpart of hippomm_tpu/ops/mel.py `KaldiFbank` (ImageBind's audio
frontend; `WhisperMel` comes with the Whisper slice). The per-frame linear
preprocessing (DC removal, preemphasis 0.97, symmetric Hann window) is folded
with the real-DFT basis into two (400, 257) matrices, so the frontend is

    frames (T, 400) @ A_cos, A_sin → re² + im² → @ melbankᵀ → ln

25 ms / 10 ms snip-edges framing, pad-to-512 DFT, HTK mel. Matches
torchaudio.compliance.kaldi.fbank (dither=0) on unscaled [-1, 1] input.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hippomm_tpu_torch.ops.melbank import mel_filterbank_kaldi


def _rdft_matrices(frame_len: int, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis: (frame_len, n_fft//2+1) cos and -sin matrices."""
    n = np.arange(frame_len)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang), -np.sin(ang)


class KaldiFbank:
    """torchaudio.compliance.kaldi.fbank-compatible filterbank features."""

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
        dev = torch.device("cpu" if device is None else device)
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

    def __call__(self, pcm: torch.Tensor) -> torch.Tensor:
        """pcm (..., N) fp32 in [-1, 1] -> (..., T, num_mel_bins) natural-log
        mel energies. Leading dims batch (the JAX vmap). No ×32768 rescale."""
        x = pcm.float()
        t = self.num_frames(x.shape[-1])
        frames = x.unfold(-1, self.FRAME_LEN, self.HOP)[..., :t, :]
        re = frames @ self.a_cos
        im = frames @ self.a_sin
        power = re * re + im * im
        mel = power @ self.melbank.t()
        eps = float(np.finfo(np.float32).eps)
        return torch.log(torch.clamp(mel, min=eps))
