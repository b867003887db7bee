"""Seeded synthetic media and their Y4M / WAV writers (frozen here so that
later changes to the program cannot move the yardstick).

A video is scene-structured, as the port's `media/synth.py` draws it: each
scene has its own background (a colour gradient plus a fixed noise
texture) and a slowly moving square in the inverse colour, so adjacent
frames of a scene stay similar and a cut changes everything. The audio is a
tone whose pitch steps every 5 s, with exact silences. Frames are drawn and
converted to YUV 4:2:0 on the device in bulk (BT.601 full range, the port
writer's 16-bit fixed point), so a 30 fps clip costs seconds, not minutes.
"""

from __future__ import annotations

import dataclasses
import struct
from fractions import Fraction
from typing import List, Sequence, Tuple

import numpy as np
import torch

from portbench.harness.seeds import seed_words, torch_seed


@dataclasses.dataclass(frozen=True)
class VideoSpec:
    duration: float
    fps: float
    width: int
    height: int
    cuts: Tuple[float, ...]
    silences: Tuple[Tuple[float, float], ...]
    seed: int  # orders the scenes
    pool_seed: int = 0  # draws the scenes' pictures, the same for every run
    sample_rate: int = 16000
    texture_px: int = 0  # side of a scene's coarse texture blocks (0: none)
    texture_amp: float = 0.0  # their standard deviation, in levels

    @property
    def num_frames(self) -> int:
        return int(round(self.duration * self.fps))


def scene_starts(spec: VideoSpec) -> List[float]:
    return [0.0] + sorted(t for t in spec.cuts if 0 < t < spec.duration)


def _backgrounds(spec: VideoSpec, n: int, device) -> torch.Tensor:
    """(n, h, w, 3) uint8 scene backgrounds: a pool of n scenes drawn from
    the pool seed, in an order drawn from the video's seed. Every run then
    holds the same scenes, and so the same key frames and work, in another
    order."""
    g = torch.Generator(device=device)
    g.manual_seed(spec.pool_seed)
    h, w = spec.height, spec.width
    base = torch.randint(30, 220, (n, 1, 1, 3), generator=g, device=device).float()
    gx = torch.linspace(0, 60, w, device=device)[None, None, :, None]
    gy = torch.linspace(0, 40, h, device=device)[None, :, None, None]
    noise = 6.0 * torch.randn((n, h, w, 3), generator=g, device=device)
    pic = base + gx + gy + noise
    if spec.texture_px:
        # blocks of a side of texture_px, each scene its own: a cut then
        # changes the picture's structure, not only its brightness
        gt = torch.Generator(device=device)
        gt.manual_seed(torch_seed(spec.pool_seed, 23))
        p = spec.texture_px
        coarse = spec.texture_amp * torch.randn((n, -(-h // p), -(-w // p), 3), generator=gt, device=device)
        pic = pic + coarse.repeat_interleave(p, 1).repeat_interleave(p, 2)[:, :h, :w]
    order = torch.from_numpy(np.random.default_rng(seed_words(spec.seed, 19)).permutation(n)).to(device)
    return torch.clamp(pic, 0, 255).to(torch.uint8)[order]


def _square_plan(spec: VideoSpec, starts: Sequence[float]):
    """Per frame: scene index and the square's top-left corner."""
    t = np.arange(spec.num_frames) / spec.fps
    b = np.asarray(starts[1:], np.float64)
    scene = np.searchsorted(b, t, side="right")
    phase = (t - np.asarray(starts)[scene]) * 0.02
    sq = max(8, spec.height // 6)
    cx = ((0.2 + 0.6 * (phase % 1.0)) * (spec.width - sq)).astype(np.int64)
    cy = ((0.3 + 0.3 * np.sin(2 * np.pi * phase)) * (spec.height - sq)).astype(np.int64)
    return scene, cx, cy, sq


def _yuv420(rgb: torch.Tensor):
    """(n, h, w, 3) uint8 -> Y (n, h, w), U, V (n, h/2, w/2) uint8 in the
    writer's BT.601 full-range 16-bit fixed point."""
    r, g, b = (rgb[..., i].to(torch.int64) for i in range(3))
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    u = (-11058 * r - 21710 * g + 32768 * b + (128 << 16) + 32768) >> 16
    v = (32768 * r - 27440 * g - 5328 * b + (128 << 16) + 32768) >> 16

    def down2(x):
        n, h, w = x.shape
        x = torch.clamp(x, 0, 255).reshape(n, h // 2, 2, w // 2, 2).sum(dim=(2, 4))
        return (x + 2) >> 2

    u8 = lambda x: torch.clamp(x, 0, 255).to(torch.uint8)  # noqa: E731
    return u8(y), u8(down2(u)), u8(down2(v))


def render_audio(spec: VideoSpec) -> np.ndarray:
    s = int(round(spec.duration * spec.sample_rate))
    tt = np.arange(s) / spec.sample_rate
    freq = 220.0 * (1 + (tt // 5.0) % 4)
    audio = (0.3 * np.sin(2 * np.pi * freq * tt)).astype(np.float32)
    for a, b in spec.silences:
        audio[int(a * spec.sample_rate):int(b * spec.sample_rate)] = 0.0
    return audio


def write_wav(path: str, pcm: np.ndarray, sample_rate: int = 16000) -> None:
    """float32 [-1, 1] mono -> 16-bit PCM WAV."""
    data = np.clip(np.round(np.asarray(pcm, np.float64) * 32767.0), -32768, 32767).astype("<i2")
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + 2 * len(data)) + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, 2 * sample_rate, 2, 16))
        f.write(b"data" + struct.pack("<I", 2 * len(data)))
        f.write(data.tobytes())


@torch.no_grad()
def write_video(path_y4m: str, path_wav: str, spec: VideoSpec, device, batch: int = 256) -> None:
    """The spec's Y4M (4:2:0, full range) and its sibling 16 kHz WAV."""
    starts = scene_starts(spec)
    bgs = _backgrounds(spec, len(starts), device)
    scene, cx, cy, sq = _square_plan(spec, starts)
    colors = (255 - bgs[:, 0, 0, :].to(torch.int64)).to(torch.uint8)  # (scenes, 3)
    h, w = spec.height, spec.width
    yy = torch.arange(h, device=device)[None, :, None]
    xx = torch.arange(w, device=device)[None, None, :]
    fr = Fraction(spec.fps).limit_denominator(1000)
    with open(path_y4m, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fr.numerator}:{fr.denominator} Ip A1:1 C420\n".encode())
        for lo in range(0, spec.num_frames, batch):
            hi = min(spec.num_frames, lo + batch)
            sc = torch.as_tensor(scene[lo:hi], device=device)
            x0 = torch.as_tensor(cx[lo:hi], device=device)[:, None, None]
            y0 = torch.as_tensor(cy[lo:hi], device=device)[:, None, None]
            inside = (yy >= y0) & (yy < y0 + sq) & (xx >= x0) & (xx < x0 + sq)
            frames = torch.where(inside[..., None], colors[sc][:, None, None, :], bgs[sc])
            y, u, v = _yuv420(frames)
            planes = torch.cat([y.reshape(hi - lo, -1), u.reshape(hi - lo, -1),
                                v.reshape(hi - lo, -1)], dim=1).cpu().numpy()
            header = np.frombuffer(b"FRAME\n", np.uint8)
            out = np.concatenate([np.broadcast_to(header, (hi - lo, 6)), planes], axis=1)
            f.write(out.tobytes())
    write_wav(path_wav, render_audio(spec), spec.sample_rate)


def specs_for(traffic: dict, seed: int) -> List[VideoSpec]:
    """The run's distinct videos: the traffic file fixes every size, cut,
    silence and the pool of scenes (each video its own pool); the seed
    orders each video's scenes."""
    dur = float(traffic["duration_s"])
    if "cut_every_s" in traffic:
        step = float(traffic["cut_every_s"])
        cuts = tuple(float(t) for t in np.arange(step, dur - 1e-9, step))
    else:
        cuts = tuple(float(t) for t in traffic.get("cuts_s", []))
    if "silence_every_s" in traffic:
        first, every, ln = (float(traffic["silence_first_s"]), float(traffic["silence_every_s"]),
                            float(traffic["silence_len_s"]))
        sil = tuple((float(t), float(t) + ln) for t in np.arange(first, dur - ln, every))
    else:
        sil = tuple((float(a), float(b)) for a, b in traffic.get("silences_s", []))
    rng = np.random.default_rng(seed_words(seed, 17))
    seeds = rng.integers(0, 2**62, size=int(traffic["videos_per_folder"]))
    pool = int(traffic.get("scene_pool_seed", 0))
    tex = (int(traffic.get("scene_texture_px", 0)), float(traffic.get("scene_texture_amp", 0.0)))
    return [VideoSpec(dur, float(traffic["fps"]), int(traffic["width"]), int(traffic["height"]),
                      cuts, sil, int(s), pool + i, texture_px=tex[0], texture_amp=tex[1])
            for i, s in enumerate(seeds)]
