"""Audio silence detection.

Counterpart of hippomm_tpu/ops/silence.py: one windowed-RMS reduction over
the whole waveform. The reduction is memory-bound with ~0 FLOPs/byte, so
host-resident audio runs in numpy (`window_rms_db_host`); `window_rms_db`
serves device-resident waveforms.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hippomm_tpu_torch.utils.device import as_tensors

_DB_FLOOR = -100.0


def window_rms_db_host(pcm: np.ndarray, window: int, hop: int) -> np.ndarray:
    """Windowed RMS dB in numpy, for audio that lives in host memory."""
    pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
    n = len(pcm)
    num = 1 + (n - window) // hop
    sq = np.square(pcm)
    if window % hop == 0:
        k = window // hop
        nh = n // hop
        block = sq[: nh * hop].reshape(nh, hop).sum(axis=1)
        sums = np.convolve(block, np.ones(k, np.float32), mode="valid")[:num]
    else:
        csum = np.concatenate([[0.0], np.cumsum(sq)])
        starts = np.arange(num) * hop
        sums = csum[starts + window] - csum[starts]
    rms = np.sqrt(np.maximum(sums, 0.0) / window)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10))
    return np.maximum(db, _DB_FLOOR).astype(np.float32)


def window_rms_db_bucketed(pcm: np.ndarray, window: int, hop: int) -> np.ndarray:
    """Windowed RMS dB for host-resident audio (numpy; the JAX package's
    historical name is kept)."""
    pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
    if len(pcm) < window:
        return np.zeros((0,), np.float32)
    return window_rms_db_host(pcm, window, hop)


def window_rms_db(pcm, window: int, hop: int, device=None) -> torch.Tensor:
    """RMS level in dBFS per window for a device-resident (N,) waveform in
    [-1, 1] (an array goes to `device`, None: CUDA). Returns (1 + (N -
    window) // hop,) fp32. When window is a multiple of hop, each window is
    an exact sum of hop-blocks."""
    (pcm,) = as_tensors(pcm, device=device)
    n = pcm.shape[0]
    num = 1 + (n - window) // hop
    sq = pcm.float().square()
    if window % hop == 0:
        k = window // hop
        nh = n // hop
        block = sq[: nh * hop].reshape(nh, hop).sum(dim=1)
        # rolling sum of k consecutive hop-blocks
        sums = F.conv1d(block[None, None], torch.ones((1, 1, k), device=pcm.device))[0, 0][:num]
        sums = torch.clamp(sums, min=0.0)
    else:
        csum = torch.cat([torch.zeros((1,), device=pcm.device), torch.cumsum(sq, 0)])
        starts = torch.arange(num, device=pcm.device) * hop
        sums = torch.clamp(csum[starts + window] - csum[starts], min=0.0)
    rms = torch.sqrt(sums / window)
    db = 20.0 * torch.log10(torch.clamp(rms, min=1e-10))
    return torch.clamp(db, min=_DB_FLOOR)


def detect_silence_regions(
    pcm: np.ndarray,
    sample_rate: int = 16000,
    threshold_db: float = -50.0,
    min_duration: float = 0.1,
    window_seconds: float = 0.05,
) -> List[Tuple[float, float]]:
    """ffmpeg-silencedetect equivalent: contiguous regions below threshold_db
    lasting >= min_duration. Returns [(start_s, end_s), ...]."""
    pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
    window = max(1, int(sample_rate * window_seconds))
    if pcm.shape[0] < window:
        db = 20.0 * np.log10(max(float(np.sqrt(np.mean(pcm**2) if pcm.size else 0.0)), 1e-10))
        if db < threshold_db and pcm.size / sample_rate >= min_duration:
            return [(0.0, pcm.size / sample_rate)]
        return []
    hop = window
    db = window_rms_db_bucketed(pcm, window, hop)
    silent = db < threshold_db
    regions: List[Tuple[float, float]] = []
    start = None
    for i, s in enumerate(silent):
        if s and start is None:
            start = i
        elif not s and start is not None:
            regions.append((start * hop / sample_rate, i * hop / sample_rate))
            start = None
    if start is not None:
        regions.append((start * hop / sample_rate, len(silent) * hop / sample_rate))
    return [(s, e) for (s, e) in regions if e - s >= min_duration]


def silence_fraction(
    pcm: np.ndarray,
    sample_rate: int = 16000,
    threshold_db: float = -50.0,
    regions=None,
) -> float:
    """Fraction of the waveform inside silence regions (the ingest skips audio
    more than 90 % silent). Pass `regions` when the caller already ran
    detect_silence_regions, so the windowed RMS runs once."""
    dur = len(pcm) / sample_rate
    if dur <= 0:
        return 1.0
    if regions is None:
        regions = detect_silence_regions(pcm, sample_rate, threshold_db)
    return min(1.0, sum(e - s for s, e in regions) / dur)
