"""End-to-end QA-accuracy harness (bench.py config #5: HippoVlog-style
ingest + question answering over a ground-truthed store).

The port's copy of hippomm_tpu/benchmarks/qa_harness.py: the same workload,
oracles, questions, scoring and return keys, driving the port's ingest CLI
(`core/batch_process.process_video_folder`), engine and `QARecallSystem`.
Two additions let it run on the card:

  * `run_harness(..., device=None)` runs on CUDA unless the caller passes
    device="cpu", and raises on a host without CUDA (every entry point of
    the port does);
  * `container` picks the corpus files: "mp4" (the JAX package's H.264 +
    AAC through the libav shim; raises where the shim is absent) or "y4m"
    (Y4M video written in 30 s chunks, the tone track in a sibling 16 kHz
    `<stem>.wav`), which a host without libav decodes.

The reference surface this measures: `batch_process.main` over a folder then
`ask_question` driven across a QA set (reference ask_question.py:50-65,
batch_process.py:749-826). HippoVlog itself isn't available offline, so the
harness builds a synthetic workload with EXACT ground truth:

  * video: K scenes, each with a distinct background color from a fixed
    palette and a unique audio tone frequency (200 + 40·i Hz)
  * oracle model clients replace the live VLM/LLM/ASR endpoints with
    DETERMINISTIC content-grounded versions:
      - OracleVLM captions a frame by nearest-palette-matching its mean color
      - OracleASR labels each second of audio by FFT dominant frequency
      - OracleReasoning answers every pipeline prompt (classify, caption
        selection, speech time frames, final answer) by parsing the prompt's
        own retrieved context — it has NO access to ground truth

  Accuracy therefore measures whether the RETRIEVAL pipeline surfaced the
  right windows: a video question is correct iff the answered time falls in a
  scene of the asked color (localized via caption-selection fallback → window
  frame fetch → captioning), an audio question iff the re-transcribed windows
  actually contain the asked tone (speech time-frame localization → window
  merge → re-transcription). Wrong windows give wrong colors/tones.

Embedding weights never matter: random text↔vision similarities stay far
below the 0.4 gate, so recall exercises the reference's low-similarity
fallback chains (hippocampal_memory.py:3156-3257, 2330-2428) end to end.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hippomm_tpu_torch.models.clients import ChatClient
from hippomm_tpu_torch.models.whisper.transcribe import Segment

# fixed, JPEG-robust base palette: saturated primaries/secondaries
_BASE_PALETTE: List[Tuple[str, Tuple[int, int, int]]] = [
    ("red", (200, 30, 30)),
    ("green", (30, 180, 40)),
    ("blue", (30, 60, 200)),
    ("yellow", (210, 200, 30)),
    ("magenta", (190, 40, 190)),
    ("cyan", (40, 190, 190)),
    ("white", (230, 230, 230)),
]


def _extended_palette(n: int = 48) -> List[Tuple[str, Tuple[int, int, int]]]:
    """Base 7 human-named colors + grid-generated `shadeNN` fills, every pair
    ≥60 apart in RGB so nearest-mean classification survives JPEG + the ±16
    scene noise. A large palette lets a MULTI-VIDEO corpus give every scene a
    globally UNIQUE color: color → (video, time) is then a function, so 'at
    what time is the background X?' stays well-defined over the whole store
    (VERDICT r2 Next #4: unsaturate the harness with a multi-video corpus)."""
    pal = list(_BASE_PALETTE)
    grid = (30, 100, 170, 240)  # uniform 70 spacing: every grid pair clears
    # the 60 separation gate (a 55-apart pair silently halved the palette)

    def d2(a, b):
        return sum((x - y) ** 2 for x, y in zip(a, b))

    for c in [(r, g, b) for r in grid for g in grid for b in grid]:
        if len(pal) >= n:
            break
        if all(d2(c, rgb) > 60 ** 2 for _, rgb in pal):
            pal.append((f"shade{len(pal):02d}", c))
    return pal


PALETTE = _extended_palette()

SAMPLE_RATE = 16000


def scene_color(i: int) -> Tuple[str, Tuple[int, int, int]]:
    return PALETTE[i % len(PALETTE)]


def scene_freq(i: int) -> float:
    return 200.0 + 40.0 * i


def tone_label(freq: float) -> str:
    return f"tone{int(round(freq / 10) * 10)}hz"


def nearest_color(rgb_mean: np.ndarray) -> str:
    d = [np.sum((rgb_mean - np.asarray(c, np.float32)) ** 2) for _, c in PALETTE]
    return PALETTE[int(np.argmin(d))][0]


# ---------------------------------------------------------------------------
# Workload generation
# ---------------------------------------------------------------------------


CONTAINERS = ("mp4", "y4m")


def write_palette_video(
    path: str,
    duration: float,
    scene_seconds: float = 30.0,
    fps: float = 2.0,
    width: int = 320,
    height: int = 180,
    seed: int = 0,
    scene_offset: int = 0,
    tone_offset: Optional[int] = None,
    container: str = "mp4",
) -> Dict:
    """The corpus file at `path`: scene i = solid palette color + a small
    moving square; audio = the scene's unique tone. Returns the ground truth
    {scenes: [(start, end, color, freq)]}.

    `container` "mp4": H.264 + embedded AAC through the libav shim (raises
    where the shim is absent). "y4m": Y4M video, the tone track in a sibling
    16 kHz `<stem>.wav` (the ingest CLI takes it as the video's audio). Both
    get the same frames and PCM, written in 30 s chunks of frames.

    `scene_offset` shifts both the color and tone assignment: video v of a
    multi-video corpus passes v·n_scenes so every scene in the corpus gets a
    globally unique color and tone. `tone_offset` (default = scene_offset)
    decouples the two: the distractor mode gives a video ANOTHER video's
    colors (near-duplicate distractor scenes) while keeping its tones
    globally unique, so audio-keyed questions stay well-defined."""
    from hippomm_tpu_torch.media import io as mio

    if container not in CONTAINERS:
        raise ValueError(f"container must be one of {CONTAINERS}, got {container!r}")
    if tone_offset is None:
        tone_offset = scene_offset
    n_scenes = max(1, int(np.ceil(duration / scene_seconds)))
    scenes = []
    for i in range(n_scenes):
        s = i * scene_seconds
        e = min(duration, (i + 1) * scene_seconds)
        scenes.append((s, e, scene_color(scene_offset + i)[0],
                       scene_freq(tone_offset + i)))

    n_frames = int(round(duration * fps))
    sq = max(8, height // 8)
    # per-scene FIXED zero-mean noise texture: keeps the scene mean on its
    # palette color (what the oracle VLM reads) while making cross-scene SSIM
    # low like real footage — solid colors alone defeat SSIM-based keyframing
    # and the reference's 0.3 recall dedup gate (different solid colors score
    # SSIM ~0.85: similar luminance + identical flat structure)
    backgrounds = []
    for i in range(n_scenes):
        srng = np.random.default_rng(seed * 1000 + i)
        noise = srng.normal(0.0, 16.0, size=(height, width, 3))
        bg = np.clip(
            np.asarray(scene_color(scene_offset + i)[1], np.float32) + noise, 0, 255
        )
        backgrounds.append(bg.astype(np.uint8))

    if container == "mp4":
        wr = mio.LibavWriter(path, width, height, fps, SAMPLE_RATE, "")
    else:
        wr = mio.Y4MWriter(path, width, height, fps)
    try:
        # audio first (one pass)
        tt = np.arange(int(duration * SAMPLE_RATE)) / SAMPLE_RATE
        scene_idx = np.minimum((tt // scene_seconds).astype(int), n_scenes - 1)
        freqs = np.asarray(
            [scene_freq(tone_offset + i) for i in range(n_scenes)]
        )[scene_idx]
        phase = np.cumsum(2 * np.pi * freqs / SAMPLE_RATE)
        pcm = (0.3 * np.sin(phase)).astype(np.float32)
        if container == "mp4":
            wr.write_audio(pcm)
        else:
            mio.write_wav(os.path.splitext(path)[0] + ".wav", pcm, SAMPLE_RATE)
        del tt, scene_idx, freqs, phase, pcm
        chunk = max(1, int(fps * 30))
        for f0 in range(0, n_frames, chunk):
            f1 = min(n_frames, f0 + chunk)
            frames = np.empty((f1 - f0, height, width, 3), np.uint8)
            for k, fi in enumerate(range(f0, f1)):
                t = fi / fps
                si = min(int(t // scene_seconds), n_scenes - 1)
                img = backgrounds[si].copy()
                ph = (t - si * scene_seconds) * 0.05
                cx = int((0.1 + 0.8 * (ph % 1.0)) * (width - sq))
                cy = int((0.4 + 0.2 * np.sin(2 * np.pi * ph)) * (height - sq))
                # small dark square: intra-scene motion without pulling the
                # scene mean off its palette color
                img[cy : cy + sq, cx : cx + sq] = (20, 20, 20)
                frames[k] = img
            wr.write_video(frames)
    finally:
        wr.close()
    return {"scenes": scenes, "duration": duration, "fps": fps}


def build_questions(
    truth: Dict, n: int, seed: int = 0, negatives: bool = True
) -> List[Dict]:
    """Cycle video (color → time), audio (tone presence), multimodal
    (tone → scene color, exercising the audio-first cross-modality chain),
    summary (SUMMARY classification → fast-path direct answer over event
    summaries + captions — the reference's 4th question type), three HARD
    families the pipeline can genuinely get wrong (VERDICT r3 Next #5 —
    families with gradient, so the accuracy gauge has headroom):

      * order  — "which of two colors appears first" (same video): needs
        retrieval to surface BOTH scenes' windows, not just one
      * count  — "how many distinct background colors in the collection":
        needs EVERY scene to have survived keyframing + captioning + replay
      * xmodal — "while tone X plays, is the background Y? yes/no": needs
        the tone localized to the right video AND window, then the in-window
        captions to name the true color (half the questions pair a WRONG
        color, so a majority-color echo can't score by luck)

    and — with `negatives` — distractor questions about colors/tones NOT in
    the corpus, which a correct pipeline must answer in the negative
    (VERDICT r2 Next #4)."""
    rng = np.random.default_rng(seed)
    scenes = truth["scenes"]
    # per-video scene grouping: run_harness provides it; direct callers with a
    # flat list get it reconstructed from the per-video time restarts
    video_scenes = truth.get("video_scenes")
    if not video_scenes:
        video_scenes = []
        for sc in scenes:
            if not video_scenes or sc[0] == 0.0:
                video_scenes.append([])
            video_scenes[-1].append(sc)
    used_colors = {c for _, _, c, _ in scenes}
    absent_colors = [name for name, _ in PALETTE if name not in used_colors]
    used_freqs = {f for _, _, _, f in scenes}
    max_freq_idx = max(
        (i for i in range(len(PALETTE) * 4) if scene_freq(i) in used_freqs),
        default=0,
    )
    kinds = ("video", "audio", "multimodal", "summary", "count", "xmodal")
    if any(len(vs) >= 2 for vs in video_scenes):
        kinds = kinds + ("order",)
        # multi-hop temporal (VERDICT r4 Next #4): localize a tone, then name
        # the color of the NEXT scene — needs the localization window's +2 s
        # buffer to actually capture frames past the tone's end, and the
        # answer stage to read the latest-timed evidence, not the majority
        kinds = kinds + ("after_tone",)
    # cross-video aggregation ("which video contains both X and Y?") needs at
    # least two named videos, each with two scenes to pair — the answer is only
    # derivable when recall attributes evidence to its source video (the
    # attribution the multi-video evidence format carries)
    video_names = truth.get("video_names") or []
    if len(video_names) >= 2 and any(
        len(vs) >= 2 for vs in video_scenes[: len(video_names)]
    ):
        kinds = kinds + ("which_video",)
    if len(video_names) >= 2:
        # cross-video counting (VERDICT r4 Next #4): "how many distinct
        # colors in video X" — only answerable when the fast path's evidence
        # is attributed to its source video (a lost scene OR a
        # cross-attributed caption both move the count)
        kinds = kinds + ("count_video",)
    if negatives:
        # a palette-saturating truth leaves no absent colors to ask about —
        # degrade to the kinds that still have material instead of indexing
        # into an empty list (ADVICE r3 #4: absent_colors[qi % max(1,0)]
        # raised IndexError for direct callers)
        if absent_colors:
            kinds = kinds + ("video_neg",)
        kinds = kinds + ("audio_neg",)
    qs: List[Dict] = []
    for qi in range(n):
        s, e, color, freq = scenes[int(rng.integers(len(scenes)))]
        kind = kinds[qi % len(kinds)]
        if kind == "video":
            qs.append(
                {
                    "question": (
                        f"At what time in the video is the background {color}? "
                        "Reply with a time in seconds."
                    ),
                    "type": "video",
                    "color": color,
                }
            )
        elif kind == "audio":
            qs.append(
                {
                    "question": f"Is the audio tone {tone_label(freq)} heard in the video?",
                    "type": "audio",
                    "label": tone_label(freq),
                }
            )
        elif kind == "multimodal":
            qs.append(
                {
                    "question": (
                        f"What is the background color while tone {tone_label(freq)} "
                        "is playing?"
                    ),
                    "type": "multimodal",
                    "color": color,
                }
            )
        elif kind == "summary":
            qs.append(
                {
                    "question": "Summarize the overall content of the video.",
                    "type": "summary",
                }
            )
        elif kind == "video_neg":
            neg_color = absent_colors[qi % max(1, len(absent_colors))]
            qs.append(
                {
                    "question": (
                        f"At what time in the video is the background {neg_color}? "
                        "Reply with a time in seconds."
                    ),
                    "type": "video_neg",
                    "color": neg_color,
                }
            )
        elif kind == "order":
            vs = [v for v in video_scenes if len(v) >= 2]
            v = vs[int(rng.integers(len(vs)))]
            i, j = sorted(rng.choice(len(v), size=2, replace=False))
            first_c, later_c = v[i][2], v[j][2]
            a, b = (first_c, later_c) if rng.integers(2) else (later_c, first_c)
            qs.append(
                {
                    "question": (
                        f"Which background color appears first in the video, "
                        f"{a} or {b}? Reply with one color."
                    ),
                    "type": "order",
                    "pair": [a, b],
                    "expected": first_c,
                }
            )
        elif kind == "count":
            qs.append(
                {
                    "question": (
                        "How many distinct background colors appear across "
                        "the video collection? Reply with a number."
                    ),
                    "type": "count",
                    "expected": len({c for _, _, c, _ in scenes}),
                }
            )
        elif kind == "xmodal":
            # alternate yes/no pairings by a per-KIND counter (counting on qi
            # parity broke whenever len(kinds) was even: every xmodal question
            # landed on the same parity, so a constant 'no' answered them all)
            n_xmodal = sum(1 for q in qs if q["type"] == "xmodal")
            expect_yes = bool(n_xmodal % 2 == 0)
            if expect_yes or len(scenes) < 2:
                asked = color
                expect_yes = True
            else:
                others = [c for _, _, c, _ in scenes if c != color]
                asked = others[int(rng.integers(len(others)))]
            qs.append(
                {
                    "question": (
                        f"While tone {tone_label(freq)} is playing, is the "
                        f"background {asked}? Answer yes or no."
                    ),
                    "type": "xmodal",
                    "expected_yes": expect_yes,
                    "color": asked,
                    "label": tone_label(freq),
                }
            )
        elif kind == "which_video":
            # pick a video with >=2 scenes; ask for the pair of its colors —
            # globally-unique palette colors mean retrieval must surface BOTH
            # scenes' windows AND recall must attribute them to one video
            # vi < len(video_names): a truth dict with more video_scenes
            # entries than names (possible for direct build_questions callers)
            # must not IndexError below (ADVICE r4 #5)
            # the chosen (video, pair) must UNIQUELY identify the video: the
            # distractor mode duplicates whole color SETS across videos, so
            # any pair drawn from a duplicated video has two correct answers.
            # Enumerate the unique combos and draw among them (a distractor
            # corpus leaves only the non-duplicated videos eligible).
            color_sets = [{sc[2] for sc in vs} for vs in video_scenes]
            combos = [
                (vi, i, j)
                for vi, vs in enumerate(video_scenes)
                if len(vs) >= 2 and vi < len(video_names)
                for i in range(len(vs))
                for j in range(i + 1, len(vs))
                if not any(
                    oi != vi and {vs[i][2], vs[j][2]} <= cs
                    for oi, cs in enumerate(color_sets)
                )
            ]
            if not combos:  # every pair ambiguous: fall back to any pair
                combos = [
                    (vi, 0, 1) for vi, vs in enumerate(video_scenes)
                    if len(vs) >= 2 and vi < len(video_names)
                ]
            vi, i, j = combos[int(rng.integers(len(combos)))]
            v = video_scenes[vi]
            qs.append(
                {
                    "question": (
                        f"Which video contains both a {v[i][2]} background and "
                        f"a {v[j][2]} background? Reply with the video name."
                    ),
                    "type": "which_video",
                    "pair": [v[i][2], v[j][2]],
                    "expected": video_names[vi],
                    "names": list(video_names),
                }
            )
        elif kind == "after_tone":
            # multi-hop: tone of scene i → color of scene i+1 (same video)
            vs = [v for v in video_scenes if len(v) >= 2]
            v = vs[int(rng.integers(len(vs)))]
            i = int(rng.integers(len(v) - 1))
            qs.append(
                {
                    "question": (
                        f"What is the background color in the scene immediately "
                        f"after tone {tone_label(v[i][3])} stops playing? "
                        "Reply with one color."
                    ),
                    "type": "after_tone",
                    "label": tone_label(v[i][3]),
                    "expected": v[i + 1][2],
                }
            )
        elif kind == "count_video":
            vi = int(rng.integers(len(video_names)))
            qs.append(
                {
                    "question": (
                        f"How many distinct background colors appear in the "
                        f"video {video_names[vi]}? Reply with a number."
                    ),
                    "type": "count_video",
                    "video": video_names[vi],
                    "expected": len({sc[2] for sc in video_scenes[vi]}),
                }
            )
        else:  # audio_neg: a tone frequency the corpus never plays
            neg_freq = scene_freq(max_freq_idx + 3 + (qi % 7))
            qs.append(
                {
                    "question": f"Is the audio tone {tone_label(neg_freq)} heard in the video?",
                    "type": "audio_neg",
                    "label": tone_label(neg_freq),
                }
            )
    return qs


def score_answer(q: Dict, answer: str, truth: Dict) -> bool:
    if q["type"] == "video":
        m = re.search(r"(\d+(?:\.\d+)?)", answer)
        if not m:
            return False
        t = float(m.group(1))
        return any(
            s - 2.0 <= t <= e + 2.0 for s, e, c, _ in truth["scenes"] if c == q["color"]
        )
    if q["type"] == "video_neg":
        # the color is NOT in the corpus: correct = the pipeline declines to
        # name a time (a hallucinated localization names one)
        return "not found" in answer.lower() or not re.search(
            r"\d+(?:\.\d+)?\s*seconds", answer
        )
    if q["type"] == "audio_neg":
        # the tone is NOT in the corpus: naming it asserts a false positive
        return bool(answer) and q["label"] not in answer
    if q["type"] == "multimodal":
        return q["color"] in answer.lower()
    if q["type"] == "order":
        al = answer.lower()
        # the FIRST pair color named in the answer is the claim
        hits = sorted(
            (al.find(c), c) for c in q["pair"] if c in al
        )
        return bool(hits) and hits[0][1] == q["expected"]
    if q["type"] in ("count", "count_video"):
        m = re.search(r"\d+", answer)
        return bool(m) and int(m.group(0)) == q["expected"]
    if q["type"] == "after_tone":
        # the FIRST palette color named is the claim (echoing the in-window
        # color instead of the next scene's scores 0)
        al = answer.lower()
        hits = sorted((al.find(c), c) for c, _ in PALETTE if c in al)
        return bool(hits) and hits[0][1] == q["expected"]
    if q["type"] == "which_video":
        # the FIRST corpus video name the answer mentions is the claim
        # (longest-first so "palette01" can't be claimed by a "palette0" hit)
        al = answer.lower()
        hits = sorted(
            (al.find(nm.lower()), -len(nm), nm)
            for nm in q["names"]
            if nm.lower() in al
        )
        return bool(hits) and hits[0][2] == q["expected"]
    if q["type"] == "xmodal":
        al = answer.lower()
        said_yes = bool(re.search(r"\byes\b", al))
        said_no = bool(re.search(r"\bno\b", al))
        if said_yes == said_no:  # neither, or contradictory
            return False
        return said_yes == q["expected_yes"]
    if q["type"] == "summary":
        # grounded summary: most of the distinct scene colors must appear —
        # a content-free "a video" answer scores 0
        colors = {c for _, _, c, _ in truth["scenes"]}
        hit = sum(1 for c in colors if c in answer.lower())
        return hit >= max(2, (3 * len(colors) + 4) // 5)
    return q["label"] in answer


# ---------------------------------------------------------------------------
# Oracle model clients (deterministic; no ground-truth access)
# ---------------------------------------------------------------------------


class OracleVLM(ChatClient):
    """Captions frames by their actual mean color; also stands in for the
    Qwen summary endpoint.

    `caption_noise` is the harness's difficulty knob (VERDICT r4 Next #4):
    with that probability a caption names the NEAREST-BY-RGB other corpus
    color instead of the true one — the confusion model of a real VLM mixing
    up two similar shades. The pipeline's evidence aggregation (majority
    voting, latest-time tie-breaks, per-video attribution) determines how
    much corruption it absorbs, so retrieval-quality regressions move the
    measured accuracy instead of hiding under a saturated 1.0."""

    def __init__(self, caption_noise: float = 0.0,
                 noise_colors: Optional[Sequence[str]] = None, seed: int = 0):
        super().__init__()
        self.caption_noise = float(caption_noise)
        self._rng = np.random.default_rng(seed)
        name_to_rgb = dict(PALETTE)
        pool = [c for c in (noise_colors or []) if c in name_to_rgb]
        # nearest-other-color confusion table over the corpus palette
        self._confuse: Dict[str, str] = {}
        for c in pool:
            others = [o for o in pool if o != c]
            if others:
                self._confuse[c] = min(
                    others,
                    key=lambda o: sum(
                        (a - b) ** 2
                        for a, b in zip(name_to_rgb[c], name_to_rgb[o])
                    ),
                )

    def caption_images(self, jpeg_batches: Sequence[bytes], prompt: str, max_workers: int = 8) -> List[str]:
        from hippomm_tpu_torch.media.io import jpeg_decode

        out = []
        for data in jpeg_batches:
            try:
                rgb = jpeg_decode(data)
                color = nearest_color(rgb.mean(axis=(0, 1)))
                if (self.caption_noise > 0.0 and color in self._confuse
                        and self._rng.random() < self.caption_noise):
                    color = self._confuse[color]
                out.append(f"A scene with a {color} background.")
            except Exception:
                out.append("[Error processing image]")
        return out

    def generate(self, prompt: str, max_tokens: int = 512, **kw) -> str:
        # content-grounded event summary: name the scene colors the captions
        # actually mention (wrong captions → wrong summary → SUMMARY
        # questions score 0), in first-appearance order
        seen: List[str] = []
        for m in re.finditer(r"(?m)^- (.*)$", prompt):
            for c, _ in PALETTE:
                if c in m.group(1) and c not in seen:
                    seen.append(c)
        if seen:
            return ("A synthetic palette video with scenes whose backgrounds "
                    "are " + ", ".join(seen) + ".")
        return "A synthetic palette video with scene-coded colors and tones."

    def chat(self, messages, max_tokens: int = 512, temperature: float = 0.0) -> str:
        return self.generate("")


class OracleASR:
    """Foundation-Whisper-surface ASR labeling each second by FFT dominant
    frequency (rounded to 10 Hz)."""

    def transcribe(self, audio, sample_rate: int = SAMPLE_RATE) -> List[Segment]:
        pcm = np.asarray(audio, np.float32).reshape(-1)
        segs: List[Segment] = []
        for s0 in range(0, len(pcm), sample_rate):
            win = pcm[s0 : s0 + sample_rate]
            if len(win) < sample_rate // 4 or float(np.max(np.abs(win))) < 1e-4:
                continue
            spec = np.abs(np.fft.rfft(win))
            freq = float(np.argmax(spec[1:]) + 1) * sample_rate / len(win)
            segs.append(
                Segment(s0 / sample_rate, min(len(pcm), s0 + sample_rate) / sample_rate,
                        tone_label(freq))
            )
        return segs

    def transcribe_batch(self, audios, sample_rate: int = SAMPLE_RATE):
        return [self.transcribe(a, sample_rate) for a in audios]

    def transcribe_async(self, audio, sample_rate: int = SAMPLE_RATE):
        return None  # engine falls back to the synchronous path


class OracleReasoning(ChatClient):
    """Answers every reasoning prompt by parsing its own retrieved context —
    if retrieval surfaced the wrong windows, the answer is wrong."""

    def chat(self, messages, max_tokens: int = 512, temperature: float = 0.0) -> str:
        text = messages[-1]["content"] if messages else ""
        if not isinstance(text, str):
            text = " ".join(x.get("text", "") for x in text if isinstance(x, dict))
        lower = text.lower()
        question = text.rsplit("Question:", 1)[-1] if "Question:" in text else text

        if "classify this question" in lower:
            ql = question.lower()
            if "summar" in ql or "overall" in ql or "how many" in ql:
                # counting needs the whole store's captions: the SUMMARY fast
                # path is the only stage that sees every event at once
                return "SUMMARY"
            if "tone" in ql and ("color" in ql or "background" in ql):
                return "VIDEO+AUDIO"
            return "AUDIO" if "tone" in ql else "VIDEO"
        if "primary modality" in lower:
            # tones ride the transcript path: deterministic localization that
            # doesn't depend on (random) audio-embedding similarities
            return "speech"
        if "do these two answers" in lower:
            return "YES"
        if "compress this question" in lower or "search query" in lower:
            # a competent compressor keeps the salient CONTENT words — the
            # palette colors — not the interrogative scaffolding ("which
            # video contains both...")
            colors = [c for c, _ in PALETTE if c in question.lower()]
            if colors:
                return " ".join(colors[:4]) + " background"
            return " ".join(re.findall(r"[a-z]+", question.lower())[:4]) or "scene"
        if "return the indices" in lower:
            # caption-selection fallback: pick captions mentioning ANY color
            # the question names (ordering questions name two — selecting only
            # the first would blind the pipeline to the comparison)
            colors = [c for c, _ in PALETTE if c in question.lower()]
            idx = [
                int(m.group(1))
                for m in re.finditer(r"(?m)^(\d+): (.+)$", text)
                if any(c in m.group(2) for c in colors)
            ]
            return json.dumps(idx[:8] if idx else [0])
        if "json list" in lower and "time frames" in lower:
            # speech localization: snippets "N: [s-e s] text" containing the
            # tone; cite the snippet number so the pipeline can attribute the
            # window to the right VIDEO in a multi-video store. A competent
            # LLM returns the CONTIGUOUS SPANS of matching content, not the
            # first five seconds of it — truncating per-second snippets to 5
            # clipped every >5 s tone to its first seconds, so the buffered
            # window never reached the tone's END (which the after_tone
            # multi-hop family needs to look past)
            label = next(iter(re.findall(r"tone\d+hz", question)), None)
            matches = sorted(
                (float(m.group(2)), float(m.group(3)), int(m.group(1)))
                for m in re.finditer(
                    r"(?m)^(\d+): \[(\d+\.?\d*)-(\d+\.?\d*)s\] (.*)$", text
                )
                if label and label in m.group(4)
            )
            spans: List[List[float]] = []
            for s, e, sn in matches:
                if spans and s - spans[-1][1] <= 1.0:
                    spans[-1][1] = max(spans[-1][1], e)
                else:
                    spans.append([s, e, sn])
            return json.dumps([
                {"start_time": s, "end_time": e, "snippet": int(sn)}
                for s, e, sn in spans[:5]
            ])
        if "using only the retrieved evidence" in lower:
            ql = question.lower()

            def windows_of():
                """Audio-localized windows from the evidence header; each
                includes the pipeline's ±2 s buffer."""
                m = re.search(r"(?m)^Audio-localized windows[^:]*: (.*)$", text)
                if not m:
                    return []
                return [
                    (float(w.group(1)), float(w.group(2)))
                    for w in re.finditer(r"(\d+\.?\d*)-(\d+\.?\d*)s", m.group(1))
                ]

            def in_tone(entries, wins):
                """Entries inside the un-buffered window cores (a window
                start of 0 was clamped, so its core starts at 0)."""
                if not wins:
                    return entries
                sel = []
                for t, c in entries:
                    for ws, we in wins:
                        lo = ws + 2.0 if ws > 0 else 0.0
                        if lo <= t < we - 2.0:
                            sel.append((t, c))
                            break
                return sel or entries

            def entries_of():
                """(time, color) pairs parsed from the caption evidence lines
                ('[Ns] ...' or '[Ns (since keyframe Ms)] ...')."""
                return [
                    (float(m.group(1)), c)
                    for m in re.finditer(r"\[(\d+\.?\d*)s[^\]]*\] (.*)", text)
                    for c, _ in PALETTE
                    if c in m.group(2)
                ]

            def majority_color(entries):
                """Most-mentioned color among the window's INTERIOR evidence,
                tie-broken by LATEST time. The localization stage's ±2 s
                buffer (reference parity) bleeds one entry into each
                neighboring scene, and recall's SSIM dedup collapses the many
                near-identical in-window frames to a few entries — so a
                competent reasoner discounts the edge entries (when interior
                ones exist) before voting."""
                if len(entries) >= 3:
                    tmin = min(t for t, _ in entries)
                    tmax = max(t for t, _ in entries)
                    inner = [(t, c) for t, c in entries
                             if tmin + 2.0 < t < tmax - 2.0]
                    if inner:
                        entries = inner
                counts: Dict[str, int] = {}
                latest: Dict[str, float] = {}
                for t, c in entries:
                    counts[c] = counts.get(c, 0) + 1
                    latest[c] = max(latest.get(c, -1.0), t)
                return max(counts, key=lambda c: (counts[c], latest[c]))

            if "answer yes or no" in ql:
                # cross-modal verification: majority color among the retrieved
                # in-window captions vs the asked color — wrong windows (or a
                # wrong-video attribution) flip the verdict
                asked = next((c for c, _ in PALETTE if c in ql), None)
                entries = in_tone(entries_of(), windows_of())
                if not entries or asked is None:
                    return "ANSWER: unknown\nCONFIDENCE: 0.2"
                best = majority_color(entries)
                if best == asked:
                    return "ANSWER: yes\nCONFIDENCE: 0.9"
                return f"ANSWER: no (the background is {best})\nCONFIDENCE: 0.9"
            if "which video" in ql:
                # cross-video aggregation: group attributed evidence lines
                # ("[video NAME] [Ns] caption") by video, answer the video
                # whose evidence names ALL asked colors — unattributed or
                # partial evidence degrades honestly
                asked = [c for c, _ in PALETTE if c in ql]
                per_video: Dict[str, set] = {}
                for m in re.finditer(r"\[video ([^\]]+)\] \[[^\]]*\] (.*)", text):
                    s = per_video.setdefault(m.group(1), set())
                    for c, _ in PALETTE:
                        if c in m.group(2):
                            s.add(c)
                full = [v for v, cs in per_video.items() if all(c in cs for c in asked)]
                if full:
                    return f"ANSWER: {full[0]}\nCONFIDENCE: 0.9"
                if per_video and asked:
                    best = max(per_video, key=lambda v: sum(c in per_video[v] for c in asked))
                    return f"ANSWER: {best}\nCONFIDENCE: 0.5"
                return "ANSWER: unknown\nCONFIDENCE: 0.2"
            if "appears first" in ql:
                # temporal ordering: earliest evidence time per asked color;
                # missing evidence for one color forces a one-sided guess
                asked = [c for c, _ in PALETTE if c in ql]
                earliest: Dict[str, float] = {}
                for t, c in entries_of():
                    if c in asked:
                        earliest[c] = min(earliest.get(c, np.inf), t)
                if len(earliest) == len(asked) and asked:
                    best = min(earliest, key=lambda c: earliest[c])
                    return f"ANSWER: {best}\nCONFIDENCE: 0.9"
                if earliest:  # partial evidence: answer what was retrieved
                    best = min(earliest, key=lambda c: earliest[c])
                    return f"ANSWER: {best}\nCONFIDENCE: 0.5"
                return "ANSWER: not found\nCONFIDENCE: 0.2"
            if "immediately after" in ql or "right after" in ql:
                # multi-hop: the color right after the tone stops = the
                # earliest caption evidence PAST the window core's end (the
                # +2 s buffer reaches past the tone, so a correct pipeline
                # retrieves a few next-scene frames). No window header or no
                # past-end evidence → the latest entry is the best guess;
                # no timestamps at all → scored wrong.
                entries = entries_of()
                wins = windows_of()
                if entries and wins:
                    tone_end = max(we - 2.0 for _, we in wins)
                    after = [(t, c) for t, c in entries if t >= tone_end]
                    if after:
                        _, c_after = min(after)
                        return f"ANSWER: {c_after}\nCONFIDENCE: 0.8"
                if entries:
                    _, c_last = max(entries)
                    return f"ANSWER: {c_last}\nCONFIDENCE: 0.5"
                return "ANSWER: not found\nCONFIDENCE: 0.2"
            if "color" in ql and not any(c in ql for c in (c for c, _ in PALETTE)):
                # asked FOR a color (multimodal): majority color among the
                # retrieved caption entries, restricted to the audio window
                # cores when the evidence names them — wrong windows give
                # wrong colors
                entries = in_tone(entries_of(), windows_of())
                if entries:
                    return f"ANSWER: {majority_color(entries)}\nCONFIDENCE: 0.9"
                return "ANSWER: no frames retrieved\nCONFIDENCE: 0.2"
            color = next((c for c, _ in PALETTE if c in question.lower()), None)
            if color:
                times = [t for t, c in entries_of() if c == color]
                if times:
                    return f"ANSWER: {float(np.median(times)):.1f} seconds\nCONFIDENCE: 0.9"
                return "ANSWER: not found\nCONFIDENCE: 0.2"
            labels = sorted(set(re.findall(r"tone\d+hz", text.split("Question:")[0])))
            if labels:
                return "ANSWER: heard tones: " + ", ".join(labels) + "\nCONFIDENCE: 0.9"
            return "ANSWER: no tones retrieved\nCONFIDENCE: 0.2"
        if "confidence" in lower:
            ql = question.lower()
            if "how many" in ql:
                # counting: distinct palette colors the retrieved context
                # actually names — a scene whose keyframe/caption was lost in
                # ingest is invisible here and the count comes out short.
                # A per-video count ("in the video NAME") restricts to the
                # evidence lines ATTRIBUTED to that video; without
                # attribution the whole-context count answers (honestly
                # wrong for a multi-video store)
                context = text.rsplit("Question:", 1)[0].lower()
                m = re.search(r"video\s+([a-z0-9_\-]+)", ql)
                if m and f"[video {m.group(1)}]" in context:
                    lines = [ln for ln in context.splitlines()
                             if f"[video {m.group(1)}]" in ln]
                    found = {c for c, _ in PALETTE
                             if any(c in ln for ln in lines)}
                else:
                    found = {c for c, _ in PALETTE if c in context}
                if found:
                    return f"ANSWER: {len(found)}\nCONFIDENCE: 0.9"
                return "ANSWER: 0\nCONFIDENCE: 0.2"
            if "summar" in ql or "overall" in ql:
                # SUMMARY fast path: answer from the retrieved summaries +
                # captions in the prompt — wrong ingest → missing colors
                context = text.rsplit("Question:", 1)[0]
                seen = []
                for c, _ in PALETTE:
                    if c in context.lower() and c not in seen:
                        seen.append(c)
                if seen:
                    return ("ANSWER: a palette video with scene backgrounds: "
                            + ", ".join(seen) + "\nCONFIDENCE: 0.9")
                return "ANSWER: a video\nCONFIDENCE: 0.2"
            # direct fast-path probe: defer to detailed recall
            return "ANSWER: unknown\nCONFIDENCE: 0.1"
        if "summarize these frame captions" in lower:
            # a faithful summarizer keeps what the question needs: the timed,
            # attributed color mentions (dropping them would blind the
            # downstream answer stages whenever >10 captions trigger
            # summarization)
            kept = [
                ln.strip()
                for ln in text.split("\n")
                if ln.strip().startswith("[")  # evidence lines, not the header
                and any(c in ln for c, _ in PALETTE)
            ]
            # one entry per line: downstream parsers (and readers) treat each
            # timed/attributed mention as a distinct evidence item
            return "\n".join(kept[:40]) or "A synthetic palette video."
        if "summar" in lower:
            return "A synthetic palette video."
        return "unknown"


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def _wilson_ci95(k: int, n: int) -> Tuple[float, float]:
    """95% Wilson score interval for a binomial proportion — reported with
    every accuracy number so n=8-style saturated results are visibly
    uninformative (VERDICT r2 Weak #5)."""
    if n == 0:
        return (0.0, 1.0)
    z = 1.959964
    p = k / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (round(max(0.0, center - half), 4), round(min(1.0, center + half), 4))


def run_harness(
    work_dir: str,
    duration: float = 3600.0,
    scene_seconds: float = 30.0,
    n_questions: int = 20,
    imagebind_variant: str = "tiny",
    fps: float = 2.0,
    width: int = 320,
    height: int = 180,
    seed: int = 0,
    n_videos: int = 1,
    negatives: bool = True,
    caption_noise: float = 0.0,
    distractors: bool = False,
    device=None,
    container: str = "mp4",
) -> Dict:
    """Build the workload, ingest via the real batch pipeline, answer the QA
    set via the real QARecallSystem, return accuracy + throughput + latency.

    `n_videos` > 1 ingests a CORPUS of distinct palette vlogs into one store
    (duration is per video). Scene colors and tones are globally unique across
    the corpus, so every question also implicitly tests that retrieval picked
    the right VIDEO, not just the right window.

    Difficulty knobs (VERDICT r4 Next #4 — see benchmarks/README.md):
      * `caption_noise` — per-caption probability that the oracle VLM names
        the nearest-by-RGB OTHER corpus color (a real VLM's similar-shade
        confusion), applied to QUERY-TIME re-captioning only. Swept upward
        it takes headline accuracy off 1.0 and makes evidence-aggregation
        regressions measurable.
      * `distractors` — the LAST video reuses the FIRST video's scene colors
        (near-duplicate distractor scenes) while keeping unique tones:
        color→video stops being a function, so which_video / per-video
        counting must rely on attributed evidence, not color uniqueness.

    `device`: where the engine runs (CUDA unless the caller passes "cpu";
    without CUDA it raises before any media is written). `container`: the
    corpus files, "mp4" or "y4m" (write_palette_video)."""
    from hippomm_tpu_torch.config import Config
    from hippomm_tpu_torch.core.batch_process import process_video_folder
    from hippomm_tpu_torch.memory.engine import HippocampalMemory
    from hippomm_tpu_torch.retrieval.qa import QARecallSystem
    from hippomm_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    videos = os.path.join(work_dir, "videos")
    os.makedirs(videos, exist_ok=True)
    scenes_per_video = max(1, int(np.ceil(duration / scene_seconds)))
    if n_videos * scenes_per_video > len(PALETTE) - 4:
        raise ValueError(
            f"{n_videos} videos x {scenes_per_video} scenes needs "
            f"{n_videos * scenes_per_video} unique colors; palette has "
            f"{len(PALETTE)} (4 reserved for negative questions)"
        )
    truth: Dict = {"scenes": [], "video_scenes": [], "duration": duration, "fps": fps}
    media_total = 0.0
    for v in range(n_videos):
        # distractor mode: the last video REUSES video 0's colors (its scenes
        # are near-duplicates of video 0's) but keeps globally unique tones
        color_off = (0 if (distractors and n_videos >= 2 and v == n_videos - 1)
                     else v * scenes_per_video)
        t_v = write_palette_video(
            os.path.join(videos, f"palette{v:02d}.{container}"),
            duration=duration, scene_seconds=scene_seconds,
            fps=fps, width=width, height=height, seed=seed + 17 * v,
            scene_offset=color_off, tone_offset=v * scenes_per_video,
            container=container,
        )
        truth["scenes"] += t_v["scenes"]
        truth["video_scenes"].append(list(t_v["scenes"]))
        media_total += t_v["duration"]
    # store video_ids are the filename stems (batch_process.py:159) — the
    # which_video family asks for these names and recall's attributed
    # evidence lines carry them
    truth["video_names"] = [f"palette{v:02d}" for v in range(n_videos)]
    questions = build_questions(truth, n_questions, seed=seed, negatives=negatives)

    cfg = Config()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = imagebind_variant
    cfg.models.imagebind_path = ""
    cfg.models.whisper_variant = "stub"  # replaced by the injected OracleASR
    cfg.storage.base_dir = os.path.join(work_dir, "store")
    # RANDOM tower weights crowd distinct scenes above the 0.9 consolidation
    # cosine gate (real ImageBind separates them); raise the gate so keyframe
    # retention reflects the production behavior the harness is measuring
    cfg.processing.keyframe_dedup_threshold = 0.999
    used_colors = sorted({c for _, _, c, _ in truth["scenes"]})
    # noise applies to QUERY-TIME re-captioning only (flipped on after
    # ingest): the knob measures how much VLM confusion the RETRIEVAL
    # pipeline's evidence aggregation absorbs. Ingest-stored captions stay
    # clean so the counting/summary families remain exact gauges of scene
    # retention (a single corrupted stored caption would binary-fail a
    # distinct-color count — a cliff, not a gradient).
    vlm = OracleVLM(caption_noise=0.0, noise_colors=used_colors, seed=seed)
    mem = HippocampalMemory(
        config=cfg,
        models={"whisper": OracleASR(), "frame_client": vlm, "qwen": vlm},
        device=device,
    )

    t0 = time.perf_counter()
    stats = process_video_folder(videos, cfg.storage.base_dir, config=cfg,
                                 memory_system=mem, checkpoint_every=0, device=device)
    ingest_wall = time.perf_counter() - t0
    ingest_x = (stats["media_seconds"] or 1e-9) / ingest_wall

    vlm.caption_noise = float(caption_noise)  # query-time corruption from here
    qa = QARecallSystem(mem, cfg, reasoning_client=OracleReasoning())
    lat: List[float] = []
    correct = 0
    by_type: Dict[str, List[bool]] = {}
    results = []
    for q in questions:
        t0 = time.perf_counter()
        r = qa.answer_question(q["question"])
        lat.append(time.perf_counter() - t0)
        ok = score_answer(q, r.answer, truth)
        correct += ok
        by_type.setdefault(q["type"], []).append(bool(ok))
        results.append({"q": q["question"], "type": q["type"], "answer": r.answer,
                        "correct": bool(ok)})

    # the BATCHED serving path (answer_questions: pooled LLM stages + one
    # fused multi-query top-k) must localize just as well
    t0 = time.perf_counter()
    batched = qa.answer_questions([q["question"] for q in questions])
    batch_wall = time.perf_counter() - t0
    batch_correct = sum(
        score_answer(q, r.answer, truth) for q, r in zip(questions, batched)
    )

    n = max(1, len(questions))
    return {
        "qa_accuracy": correct / n,
        "ci95": list(_wilson_ci95(correct, n)),
        "qa_accuracy_batched": batch_correct / n,
        "accuracy_by_type": {
            k: round(sum(v) / len(v), 3) for k, v in sorted(by_type.items())
        },
        "batched_s_per_q": round(batch_wall / n, 3),
        "n_questions": len(questions),
        "n_videos": n_videos,
        "n_scenes": len(truth["scenes"]),
        "caption_noise": caption_noise,
        "distractors": bool(distractors),
        "ingest_x": round(ingest_x, 2),
        "ingest_wall_s": round(ingest_wall, 2),
        "media_s": stats["media_seconds"],
        "recall_p50_ms": round(float(np.percentile(lat, 50)) * 1000, 1),
        "failed_videos": stats["failed"],
        "results": results,
    }
