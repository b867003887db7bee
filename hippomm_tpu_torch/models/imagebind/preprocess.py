"""ImageBind audio preprocessing, batched on the device.

Counterpart of the audio half of hippomm_tpu/models/imagebind/preprocess.py:
2 s clip sampling (3 clips per segment, pytorchvideo's
ConstantClipsPerVideoSampler offsets), Kaldi fbank (ops/mel.KaldiFbank), AST
normalisation (mean −4.268, std 9.138, ÷2). The vision half is
ops/resize; the text tokenizer comes with the query slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from hippomm_tpu_torch.ops.bucketing import pad_leading
from hippomm_tpu_torch.ops.mel import KaldiFbank

AUDIO_MEAN = -4.268
AUDIO_STD = 9.138
CLIP_DURATION_S = 2.0
CLIPS_PER_VIDEO = 3
SAMPLE_RATE = 16000

_FBANKS: Dict[Tuple[int, str], KaldiFbank] = {}


def _fbank(bins: int, device: torch.device) -> KaldiFbank:
    key = (bins, str(device))
    if key not in _FBANKS:
        _FBANKS[key] = KaldiFbank(num_mel_bins=bins, device=device)
    return _FBANKS[key]


def _clip_starts(n_samples: int, clips_per_video: int, clip_samples: int) -> np.ndarray:
    """Clip start offsets of pytorchvideo's ConstantClipsPerVideoSampler:
    start_i = span·i/clips (not linspace, whose last clip starts at the end)."""
    span = max(0, n_samples - clip_samples)
    return (span * np.arange(clips_per_video) / max(1, clips_per_video)).astype(int)


def _fbank_clips(clips: torch.Tensor, fbank: KaldiFbank, target_len: int) -> torch.Tensor:
    """(N, S) clips -> (N, bins, target_len) normalized fbank."""
    feats = fbank(clips).transpose(1, 2)  # (N, bins, T)
    t = feats.shape[2]
    if t < target_len:
        feats = torch.nn.functional.pad(feats, (0, target_len - t))
    feats = feats[:, :, :target_len]
    return (feats - AUDIO_MEAN) / (AUDIO_STD * 2.0)


def preprocess_audio_batch(
    pcms,
    mel_bins: int = 128,
    target_len: int = 204,
    clips_per_video: int = CLIPS_PER_VIDEO,
    device="cpu",
) -> torch.Tensor:
    """Many 16 kHz clips -> (B, clips, 1, mel_bins, target_len) on `device`:
    clip slicing on the host, fbank + normalize on the device in fixed
    32-window chunks (zero-padded, as the JAX program)."""
    device = torch.device(device)
    clip_samples = int(CLIP_DURATION_S * SAMPLE_RATE)
    if not len(pcms):
        return torch.zeros((0, clips_per_video, 1, mel_bins, target_len), device=device)
    windows = []
    for pcm in pcms:
        pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
        if len(pcm) < clip_samples:
            pcm = np.pad(pcm, (0, clip_samples - len(pcm)))
        for s in _clip_starts(len(pcm), clips_per_video, clip_samples):
            windows.append(pcm[s : s + clip_samples])
    fbank = _fbank(mel_bins, device)
    outs = []
    for lo in range(0, len(windows), 32):
        chunk, n_real = pad_leading(np.stack(windows[lo : lo + 32]), n=32, mode="zero")
        outs.append(_fbank_clips(torch.from_numpy(chunk).to(device), fbank, target_len)[:n_real])
    feats = torch.cat(outs)
    return feats.reshape(len(pcms), clips_per_video, 1, mel_bins, target_len)


def preprocess_audio(
    pcm: np.ndarray,
    mel_bins: int = 128,
    target_len: int = 204,
    clips_per_video: int = CLIPS_PER_VIDEO,
    device="cpu",
) -> torch.Tensor:
    """16 kHz mono float32 -> (1, clips, 1, mel_bins, target_len) fbank clips."""
    return preprocess_audio_batch(
        [pcm], mel_bins=mel_bins, target_len=target_len, clips_per_video=clips_per_video,
        device=device,
    )
