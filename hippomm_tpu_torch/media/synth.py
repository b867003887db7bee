"""Synthetic audiovisual content with ground truth — the hermetic test/bench
workload generator (the reference has no fixtures at all, SURVEY.md §4).

The port's copy of hippomm_tpu/media/synth.py. `write_synthetic_video`
writes .y4m and MJPEG .avi (with a sibling .wav); the libav containers wait
for the port's libav slice and raise.

Videos are scene-structured: each scene has a distinct background + a moving
square, so frame-difference segmentation has known boundaries. Audio interleaves
tones and silences at known times, so silence detection has known regions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass
class SynthSpec:
    duration: float = 30.0
    fps: float = 10.0
    width: int = 320
    height: int = 240
    scene_changes: Tuple[float, ...] = ()  # times of hard cuts
    sample_rate: int = 16000
    silence_regions: Tuple[Tuple[float, float], ...] = ()  # audio silences
    seed: int = 0


@dataclass
class SynthResult:
    frames: np.ndarray  # (N, H, W, 3) uint8
    frame_times: np.ndarray  # (N,)
    audio: np.ndarray  # (S,) float32 mono 16 kHz
    spec: SynthSpec = field(repr=False, default=None)


def _scene_background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Distinct per-scene background: colored gradient + fixed noise texture."""
    base = rng.integers(30, 220, size=3)
    gx = np.linspace(0, 60, w)[None, :, None]
    gy = np.linspace(0, 40, h)[:, None, None]
    img = base[None, None, :] + gx + gy + rng.normal(0, 6, size=(h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


class _Plan:
    """Deterministic per-spec scene layout, reusable for chunked rendering."""

    def __init__(self, spec: SynthSpec):
        rng = np.random.default_rng(spec.seed)
        self.spec = spec
        self.n = int(round(spec.duration * spec.fps))
        self.boundaries = sorted(t for t in spec.scene_changes if 0 < t < spec.duration)
        self.scene_starts = [0.0] + self.boundaries
        self.backgrounds = [
            _scene_background(rng, spec.height, spec.width) for _ in self.scene_starts
        ]
        self.sq = max(8, spec.height // 6)


def render_frames(plan: _Plan, i0: int, i1: int) -> np.ndarray:
    """Frames [i0, i1) of the planned video — chunked so hour-long/30 fps
    workloads never materialize in memory."""
    spec = plan.spec
    frames = np.empty((i1 - i0, spec.height, spec.width, 3), dtype=np.uint8)
    for k, i in enumerate(range(i0, i1)):
        t = i / spec.fps
        scene = sum(1 for b in plan.boundaries if t >= b)
        img = plan.backgrounds[scene].copy()
        # slowly moving square: small intra-scene motion so adjacent-frame SSIM
        # stays above the 0.95 segmentation threshold (like real video at
        # native fps), while scene cuts drop it far below
        phase = (t - plan.scene_starts[scene]) * 0.02
        cx = int((0.2 + 0.6 * (phase % 1.0)) * (spec.width - plan.sq))
        cy = int((0.3 + 0.3 * np.sin(2 * np.pi * phase)) * (spec.height - plan.sq))
        color = (np.array([255, 255, 255]) - plan.backgrounds[scene][0, 0]).astype(np.uint8)
        img[cy : cy + plan.sq, cx : cx + plan.sq] = color
        frames[k] = img
    return frames


def render_audio(spec: SynthSpec) -> np.ndarray:
    s = int(round(spec.duration * spec.sample_rate))
    tt = np.arange(s) / spec.sample_rate
    freq = 220.0 * (1 + (tt // 5.0) % 4)  # changing tone every 5 s
    audio = (0.3 * np.sin(2 * np.pi * freq * tt)).astype(np.float32)
    for start, end in spec.silence_regions:
        audio[int(start * spec.sample_rate) : int(end * spec.sample_rate)] = 0.0
    return audio


def generate(spec: SynthSpec) -> SynthResult:
    plan = _Plan(spec)
    frames = render_frames(plan, 0, plan.n)
    times = np.arange(plan.n) / spec.fps
    return SynthResult(
        frames=frames, frame_times=times, audio=render_audio(spec), spec=spec
    )


def write_synthetic_video(
    path: str,
    spec: Optional[SynthSpec] = None,
    audio_path: Optional[str] = None,
    codec: str = "",
) -> Optional[SynthResult]:
    """Generate and persist a synthetic clip (container chosen by extension):
    .y4m, or MJPEG .avi through the media shim, video-only, with the audio in
    a sibling wav when `audio_path` is given. Returns the full SynthResult.
    .mp4/.mov/.mkv (and .avi with a `codec`) go through libav, which the
    port does not have yet: NotImplementedError."""
    from hippomm_tpu_torch.media import io as mio

    spec = spec or SynthSpec()
    ext = path.rsplit(".", 1)[-1].lower()
    if ext in ("mp4", "mov", "mkv") or (ext == "avi" and codec != ""):
        raise NotImplementedError(mio._LIBAV_TODO.format(what=f"writing {path}"))
    if ext not in ("avi", "y4m"):
        # reject before rendering the whole clip into memory
        raise ValueError(f"unsupported container: {path}")
    result = generate(spec)
    if ext == "avi":
        mio.write_avi(path, result.frames, fps=spec.fps)
    else:
        mio.write_y4m(path, result.frames, fps=spec.fps)
    if audio_path:
        mio.write_wav(audio_path, result.audio, spec.sample_rate)
    return result
