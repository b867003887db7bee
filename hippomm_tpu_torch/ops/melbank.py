"""Mel filterbank construction (host-side, numpy, built once).

Two families are needed for parity with the reference's model stack:
  * Slaney-scale (librosa-compatible) — Whisper's log-mel frontend
    (reference: faster-whisper/CTranslate2 internals behind foundation_models.py:181-215).
  * Kaldi HTK-scale (torchaudio.compliance.kaldi-compatible) — ImageBind's audio
    frontend (reference: imagebind data pipeline behind foundation_models.py:48-114).
"""

from __future__ import annotations

import numpy as np


def hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = m * f_sp
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)


def mel_filterbank_slaney(
    n_mels: int, n_fft: int, sample_rate: int, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """librosa.filters.mel(norm='slaney', htk=False) equivalent.

    Returns (n_mels, n_fft // 2 + 1) float32.
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # slaney normalization: equal area per band
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hz_to_mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (np.exp(np.asarray(m, dtype=np.float64) / 1127.0) - 1.0)


def mel_filterbank_kaldi(
    num_bins: int,
    padded_window_size: int,
    sample_rate: int,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """torchaudio.compliance.kaldi.get_mel_banks equivalent (vtln disabled).

    Triangular filters in HTK mel space, NOT area-normalized. Returns
    (num_bins, padded_window_size // 2 + 1) float32 — the final (nyquist) column
    is zero-padded exactly as torchaudio does.
    """
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    num_fft_bins = padded_window_size // 2
    fft_bin_width = sample_rate / padded_window_size

    mel_low = hz_to_mel_htk(low_freq)
    mel_high = hz_to_mel_htk(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1.0) * mel_delta
    right_mel = mel_low + (bin_idx + 2.0) * mel_delta

    freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)[None, :]
    mel = hz_to_mel_htk(freqs)

    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    weights = np.maximum(0.0, np.minimum(up_slope, down_slope))
    # pad the nyquist column with zeros (torchaudio kaldi.py get_mel_banks caller)
    out = np.zeros((num_bins, num_fft_bins + 1), dtype=np.float32)
    out[:, :num_fft_bins] = weights.astype(np.float32)
    return out
