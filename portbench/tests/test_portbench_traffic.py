"""The traffic is a function of the seed: equal seeds give equal inputs,
another seed other inputs, and every seed the same sizes."""

import hashlib
import os

import torch

from portbench.harness import media
from portbench.reference import media as rm
from portbench.tests import tiny


def _video_digest(tmp_path, seed, name):
    spec = media.specs_for(tiny.tiny_ingest_traffic(), seed)[0]
    spec = media.VideoSpec(6.0, spec.fps, spec.width, spec.height, (3.0,), ((1.0, 2.0),), spec.seed)
    y, w = os.path.join(tmp_path, name + ".y4m"), os.path.join(tmp_path, name + ".wav")
    media.write_video(y, w, spec, torch.device("cpu"))
    return hashlib.sha1(open(y, "rb").read() + open(w, "rb").read()).hexdigest()


def test_videos_follow_the_seed(tmp_path):
    big = 2**31 + 12345
    assert _video_digest(tmp_path, big, "a") == _video_digest(tmp_path, big, "b")
    assert _video_digest(tmp_path, big, "a") != _video_digest(tmp_path, big + 1, "c")


def test_video_specs_keep_sizes_across_seeds():
    for name in ("vlog", "fastcut", "clip30fps"):
        t = tiny.load("traffic", name)
        a, b = media.specs_for(t, 5), media.specs_for(t, 6)
        assert [(s.duration, s.fps, s.cuts, s.silences) for s in a] == \
            [(s.duration, s.fps, s.cuts, s.silences) for s in b]
        assert [s.seed for s in a] != [s.seed for s in b]
        assert len(a) == t["videos_per_folder"]


def test_textured_scenes_make_every_cut_a_key_frame(tmp_path):
    """fastcut's scenes differ in structure, not only in brightness, so the
    reference's key-frame walk keeps one frame at every cut; the untextured
    scenes of the same cuts lose some."""
    t = tiny.load("traffic", "fastcut")
    kept = {}
    for px in (t["scene_texture_px"], 0):
        spec = media.specs_for(dict(t, duration_s=40, scene_texture_px=px), 2**31 + 99)[0]
        y, w = os.path.join(tmp_path, "v.y4m"), os.path.join(tmp_path, "v.wav")
        media.write_video(y, w, spec, torch.device("cpu"))
        video = rm.Y4M(y)
        idx, times = rm.candidates(spec.num_frames, spec.fps)
        lumas = [rm.box_luma(video.luma(i), 90, 160) for i in idx]
        scenes = len(media.scene_starts(spec))
        kept[px] = _walk(lumas, times)
    assert kept[t["scene_texture_px"]] == scenes
    assert kept[0] < scenes


def _walk(lumas, times, thr=0.3, gap=1.0):
    """Key frames the reference's greedy walk keeps, deciding by itself."""
    n, ref, cum, tlast = 0, None, 0.0, -1e9
    for g, t in zip(lumas, times):
        save = ref is None
        if not save and t - tlast >= gap:
            d = 1.0 - rm.ssim(ref, g)
            save = max(d, cum + d) > thr
            cum += d
        if save:
            n, ref, cum, tlast = n + 1, g, 0.0, t
    return n

