"""Temporal pattern separation (reference: hippocampal_memory.py:980-1114).

Counterpart of hippomm_tpu/memory/segmentation.py. Reference semantics: grow
a window to max_segment_duration; walk backwards to the LATEST boundary inside
the window — a frame pair with SSIM < threshold, or a 500 ms audio window with
RMS < silence_db — respecting min_segment_duration; cut there, repeat.

Every adjacent frame pair is scored on the device (resize → gray → SSIM, in
fixed 32-frame chunks) and every audio window on the host; the greedy walk
then runs over those two small fp32 vectors. A device fault raises: there is
no host fallback. The ≤33-frame host route of `adjacent_similarity_gray` is a
size rule, not a fallback.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from hippomm_tpu_torch.memory.schema import SequenceSegment
from hippomm_tpu_torch.ops.resize import resize_frames
from hippomm_tpu_torch.ops.ssim import adjacent_ssim, rgb_to_gray, ssim_pairs_host
from hippomm_tpu_torch.utils.device import fetch, resolve_device


SSIM_DOWNSCALE_H = 90  # reference computes SSIM on small grayscale frames
SSIM_DOWNSCALE_W = 160
AUDIO_WIN_S = 0.5
AUDIO_HOP_S = 0.1
CHUNK = 32


@torch.no_grad()
def adjacent_frame_similarity(frames_rgb: np.ndarray, device=None) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T-1,) SSIM between consecutive frames, one
    resize→gray→SSIM pass per 32-frame chunk on `device` (None:
    resolve_device, CUDA). Chunks overlap by one frame so every adjacent pair
    is scored; short chunks are padded by repeating the last frame (pad pairs
    score 1 and are dropped)."""
    device = resolve_device(device)
    frames_rgb = np.asarray(frames_rgb)
    t = frames_rgb.shape[0]
    if t < 2:
        return np.zeros((0,), np.float32)
    outs = []
    lo = 0
    while lo < t - 1:
        chunk = frames_rgb[lo : lo + CHUNK]
        m = len(chunk)
        if m < CHUNK:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], CHUNK - m, axis=0)])
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
        sims = adjacent_ssim(rgb_to_gray(resize_frames(x, SSIM_DOWNSCALE_H, SSIM_DOWNSCALE_W)))
        outs.append(sims[: m - 1])
        lo += CHUNK - 1
    return fetch(torch.cat(outs))[: t - 1]


@torch.no_grad()
def adjacent_similarity_gray(grays: np.ndarray, device=None) -> np.ndarray:
    """(T, h, w) uint8 scoring-resolution luma -> (T-1,) adjacent SSIM; one
    chunk's worth (≤ 33 frames) runs on the host in fp32, longer inputs on
    `device` (None: resolve_device, CUDA)."""
    grays = np.asarray(grays)
    t = grays.shape[0]
    if t < 2:
        return np.zeros((0,), np.float32)
    if t <= 33:
        return ssim_pairs_host(grays[:-1], grays[1:], dtype=np.float32).astype(np.float32)
    device = resolve_device(device)
    outs = []
    lo = 0
    while lo < t - 1:
        chunk = grays[lo : lo + CHUNK]
        m = len(chunk)
        if m < CHUNK:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], CHUNK - m, axis=0)])
        outs.append(adjacent_ssim(torch.from_numpy(np.ascontiguousarray(chunk)).to(device))[: m - 1])
        lo += CHUNK - 1
    return fetch(torch.cat(outs))[: t - 1]


def audio_window_levels(
    audio: Optional[np.ndarray], sample_rate: int = 16000
) -> Optional[np.ndarray]:
    """(S,) pcm -> per-window RMS dB at 500 ms / 100 ms hop (host numpy)."""
    if audio is None:
        return None
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    win = int(AUDIO_WIN_S * sample_rate)
    hop = int(AUDIO_HOP_S * sample_rate)
    if len(audio) < win:
        return None
    from hippomm_tpu_torch.ops.silence import window_rms_db_bucketed

    return window_rms_db_bucketed(audio, win, hop)


def find_boundaries(
    frame_times: Sequence[float],
    frame_ssim: np.ndarray,
    audio_db: Optional[np.ndarray],
    duration: float,
    max_segment: float = 30.0,
    min_segment: float = 10.0,
    ssim_threshold: float = 0.95,
    silence_db: float = -40.0,
    audio_hop_s: float = AUDIO_HOP_S,
) -> List[float]:
    """Greedy boundary times over precomputed scores (reference walk-back
    semantics, hippocampal_memory.py:1043-1084). Returns interior cut times."""
    frame_times = np.asarray(frame_times, dtype=np.float64)
    cuts: List[float] = []
    start = 0.0
    while duration - start > max_segment:
        lo, hi = start + min_segment, start + max_segment
        best: Optional[float] = None

        # latest dissimilar frame pair inside (lo, hi]: boundary at pair's 2nd frame
        if len(frame_ssim):
            pair_t = frame_times[1:]
            mask = (pair_t > lo) & (pair_t <= hi) & (frame_ssim < ssim_threshold)
            idx = np.nonzero(mask)[0]
            if len(idx):
                best = float(pair_t[idx[-1]])

        # latest silent audio window inside (lo, hi]
        if audio_db is not None and len(audio_db):
            win_t = np.arange(len(audio_db)) * audio_hop_s + AUDIO_WIN_S / 2
            mask = (win_t > lo) & (win_t <= hi) & (audio_db < silence_db)
            idx = np.nonzero(mask)[0]
            if len(idx):
                cand = float(win_t[idx[-1]])
                best = cand if best is None else max(best, cand)

        if best is None:
            best = hi  # hard cut at max duration
        cuts.append(best)
        start = best
    return cuts


def segment_sequence(
    frame_paths: Sequence[str],
    frame_times: Sequence[float],
    frames_rgb: Optional[np.ndarray],
    audio: Optional[np.ndarray],
    sample_rate: int = 16000,
    max_segment: float = 30.0,
    min_segment: float = 10.0,
    ssim_threshold: float = 0.95,
    silence_db: float = -40.0,
    duration: Optional[float] = None,
    precomputed_ssim: Optional[np.ndarray] = None,
    device=None,
) -> List[SequenceSegment]:
    """Full temporal pattern separation -> SequenceSegments with sliced frames
    and audio (reference: _segment_sequence, hippocampal_memory.py:1002-1114).
    The SSIM runs on `device` (None: resolve_device, CUDA)."""
    device = resolve_device(device)
    frame_times = list(map(float, frame_times))
    if duration is None:
        candidates = []
        if frame_times:
            candidates.append(frame_times[-1] + 1e-3)
        if audio is not None:
            candidates.append(len(audio) / sample_rate)
        duration = max(candidates) if candidates else 0.0

    if precomputed_ssim is not None:
        ssim = np.asarray(precomputed_ssim, np.float32)
    elif frames_rgb is not None and len(frames_rgb) >= 2:
        ssim = adjacent_frame_similarity(frames_rgb, device=device)
    else:
        ssim = np.zeros((0,), np.float32)
    db = audio_window_levels(audio, sample_rate)
    cuts = find_boundaries(
        frame_times, ssim, db, duration, max_segment, min_segment, ssim_threshold, silence_db
    )
    bounds = [0.0] + cuts + [duration]

    segments: List[SequenceSegment] = []
    ft = np.asarray(frame_times, dtype=np.float64)
    for s, e in zip(bounds[:-1], bounds[1:]):
        if e <= s:
            continue
        sel = np.nonzero((ft >= s) & (ft < e))[0] if len(ft) else np.zeros((0,), int)
        seg_audio = None
        if audio is not None:
            seg_audio = np.asarray(audio[int(s * sample_rate) : int(e * sample_rate)])
        segments.append(
            SequenceSegment(
                start_time=float(s),
                end_time=float(e),
                frames=[frame_paths[i] for i in sel] if frame_paths else [],
                audio_data=seg_audio,
                frame_times=[frame_times[i] for i in sel],
            )
        )
    return segments
