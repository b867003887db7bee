"""The port's QA-accuracy harness (hippomm_tpu_torch/benchmarks/qa_harness)
against the JAX package's, on the CPU.

Exact: the palette and its helpers, `build_questions` over seeds, corpus
sizes, negatives and distractor truths, `score_answer` on those questions
against crafted answers and on the JAX run's answers, the three oracles,
and the corpus writer (frames and PCM equal to JAX's; the Y4M and WAV bytes
equal to the JAX package's `write_y4m` / `write_wav`; an mp4 decoded
equal to the JAX file's where the libav shim builds). End to end: both
`run_harness` functions with the same tiny fp32 ImageBind (the JAX weights
carried to the port through a monkeypatch of each engine's `ImageBind`)
give the same questions, answers and verdicts at caption noise 0 on both
paths, and the same single-path answers at noise 0.9 on one video (one
video: no thread pool draws the noise on that path).

Run as a script, it measures the run-to-run spread of both harnesses under
caption noise at bench.py config #5's shape (3 videos × 180 s, 15 s
scenes, 120 questions, noise 0.15, distractors, seed 0), each run a fresh
process with the same tiny fp32 ImageBind in both packages; `--serial`
runs the QA path's thread pools with one worker (patched after the
ingest), which shows whether the spread comes from the order in which
those threads draw the oracle VLM's noise:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_qa_harness.py --runs 10
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_qa_harness.py --runs 2 --serial

One line a run (package, serial, single-path and batched accuracy, a hash
of the 120 single-path answers), then a JSON summary line."""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.benchmarks import qa_harness as J
from hippomm_tpu.media import io as jio
from hippomm_tpu.memory import engine as jengine
from hippomm_tpu.models.foundation import ImageBind as JImageBind
from hippomm_tpu_torch.benchmarks import qa_harness as T
from hippomm_tpu_torch.media import io as tio
from hippomm_tpu_torch.memory import engine as tengine
from hippomm_tpu_torch.models.foundation import ImageBind as TImageBind
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax

# ---------------------------------------------------------------------------
# the palette
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["PALETTE", "SAMPLE_RATE", "scene_color", "scene_freq", "tone_label"])
def test_palette_helpers_equal(name):
    if name in ("PALETTE", "SAMPLE_RATE"):
        assert getattr(T, name) == getattr(J, name)
        return
    if name == "tone_label":
        args = [200.0 + 0.37 * i for i in range(4000)] + [5.0, 4.99, 15.0, 25.0, 1e4]
    else:
        args = range(-5, 400)
    for a in args:
        assert getattr(T, name)(a) == getattr(J, name)(a), a


def test_nearest_color_equal():
    rng = np.random.default_rng(0)
    means = [np.asarray(c, np.float32) for _, c in J.PALETTE]
    means += list(rng.uniform(0, 255, size=(64, 3)).astype(np.float32))
    for m in means:
        assert T.nearest_color(m) == J.nearest_color(m)


# ---------------------------------------------------------------------------
# questions and scoring
# ---------------------------------------------------------------------------


def _truth(n_videos, distractors, spv=3, duration=45.0, ss=15.0):
    """run_harness's truth for a corpus, without writing it."""
    truth = {"scenes": [], "video_scenes": [], "duration": duration, "fps": 2.0}
    for v in range(n_videos):
        color_off = 0 if (distractors and n_videos >= 2 and v == n_videos - 1) else v * spv
        scenes = [(i * ss, min(duration, (i + 1) * ss), J.scene_color(color_off + i)[0],
                   J.scene_freq(v * spv + i)) for i in range(spv)]
        truth["scenes"] += scenes
        truth["video_scenes"].append(scenes)
    truth["video_names"] = [f"palette{v:02d}" for v in range(n_videos)]
    return truth


_Q_CASES = [(s, nv, neg, dis) for s in range(4) for nv in (1, 2, 3) for neg in (False, True)
            for dis in (False, True)]


def _answers_for(q, truth):
    """A right answer (where one is simple to write) and crafted wrong ones."""
    out = ["", "unknown", "ANSWER: not found\nCONFIDENCE: 0.2", "yes", "no", "yes and no",
           "ANSWER: 3", "ANSWER: 7 seconds", "red", "green then red", "palette00", "palette01 (not palette00)",
           "heard tones: tone200hz, tone240hz", "a palette video with scene backgrounds: red, green, blue"]
    if "color" in q:
        times = [s for s, _, c, _ in truth["scenes"] if c == q["color"]]
        out += [f"ANSWER: {t + 1.0:.1f} seconds" for t in times[:1]] + [q["color"], f"no ({q['color']})"]
    for k in ("expected", "label"):
        if k in q:
            out.append(f"ANSWER: {q[k]}")
    if "pair" in q:
        out += [" or ".join(q["pair"]), " or ".join(reversed(q["pair"]))]
    out.append(", ".join(c for _, _, c, _ in truth["scenes"]))
    return out


@pytest.mark.parametrize("seed,n_videos,negatives,distractors", _Q_CASES)
def test_build_questions_equal(seed, n_videos, negatives, distractors):
    truth = _truth(n_videos, distractors)
    want = J.build_questions(truth, 40, seed=seed, negatives=negatives)
    got = T.build_questions(truth, 40, seed=seed, negatives=negatives)
    assert got == want
    # a flat truth (no per-video grouping) takes the reconstruction path
    flat = {"scenes": truth["scenes"]}
    assert T.build_questions(flat, 20, seed=seed, negatives=negatives) == J.build_questions(
        flat, 20, seed=seed, negatives=negatives)


@pytest.mark.parametrize("seed,n_videos,negatives,distractors", _Q_CASES)
def test_score_answer_equal(seed, n_videos, negatives, distractors):
    truth = _truth(n_videos, distractors)
    verdicts = []
    for q in J.build_questions(truth, 40, seed=seed, negatives=negatives):
        for a in _answers_for(q, truth):
            want = J.score_answer(q, a, truth)
            assert T.score_answer(q, a, truth) == want, (q, a)
            verdicts.append(want)
    assert True in verdicts and False in verdicts


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------


def _tone(freqs, seconds=1.0, amp=0.3):
    t = np.arange(int(seconds * 16000)) / 16000.0
    return np.concatenate([amp * np.sin(2 * np.pi * f * t) for f in freqs]).astype(np.float32)


_ASR_CASES = {
    "one_tone": lambda: _tone([240.0], 2.0),
    "scene_tones": lambda: _tone([200.0, 240.0, 280.0, 1080.0], 1.5),
    "silence": lambda: np.zeros(3 * 16000, np.float32),
    "quiet": lambda: _tone([400.0], 2.0, amp=5e-5),
    "short_tail": lambda: np.concatenate([_tone([320.0], 2.0), _tone([360.0], 0.2)]),
    "tone_then_silence": lambda: np.concatenate([_tone([520.0], 1.7), np.zeros(16000, np.float32)]),
}


@pytest.mark.parametrize("case", sorted(_ASR_CASES))
def test_oracle_asr_equal(case):
    pcm = _ASR_CASES[case]()
    want = [(s.start, s.end, s.text) for s in J.OracleASR().transcribe(pcm)]
    got = [(s.start, s.end, s.text) for s in T.OracleASR().transcribe(pcm)]
    assert got == want
    assert [[(s.start, s.end, s.text) for s in segs] for segs in T.OracleASR().transcribe_batch([pcm, pcm])] == [
        want, want]
    assert T.OracleASR().transcribe_async(pcm) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_vlm_captions_equal(seed):
    """The same JPEG sequence at caption noise 0.5 from the same seed: the
    same captions, draw for draw; a broken JPEG gives the error caption."""
    rng = np.random.default_rng(100 + seed)
    used = [c for c, _ in J.PALETTE[:9]]
    frames = []
    for i in range(60):
        img = np.empty((24, 32, 3), np.uint8)
        img[:] = dict(J.PALETTE)[used[int(rng.integers(len(used)))]]
        frames.append(tio.jpeg_encode(img))
    frames.insert(7, b"not a jpeg")
    jv = J.OracleVLM(caption_noise=0.5, noise_colors=used, seed=seed)
    tv = T.OracleVLM(caption_noise=0.5, noise_colors=used, seed=seed)
    want = jv.caption_images(frames[:30], "") + jv.caption_images(frames[30:], "")
    got = tv.caption_images(frames[:30], "") + tv.caption_images(frames[30:], "")
    assert got == want
    assert "[Error processing image]" in got and len(set(got)) > 3
    prompt = "Captions:\n- A scene with a red background.\n- A scene with a shade09 background.\n- none"
    for p in (prompt, "", "- blue and green"):
        assert tv.generate(p) == jv.generate(p)
    assert tv.chat([]) == jv.chat([])


# ---------------------------------------------------------------------------
# the corpus writer
# ---------------------------------------------------------------------------


class _Recorder:
    """Stands in for a LibavWriter: keeps what it is given."""

    last = None

    def __init__(self, path, width, height, fps, sample_rate=0, codec=""):
        self.args = (width, height, fps, sample_rate, codec)
        self.audio, self.frames, self.closed = [], [], False
        type(self).last = self

    def write_audio(self, pcm):
        self.audio.append(np.array(pcm))

    def write_video(self, frames):
        self.frames.append(np.array(frames))

    def close(self):
        self.closed = True


_WRITER_CASES = {  # name: write_palette_video kwargs past the path
    "one_scene": dict(duration=20.0, scene_seconds=30.0, fps=2.0, width=64, height=48),
    "chunks": dict(duration=75.0, scene_seconds=15.0, fps=2.0, width=64, height=48, seed=3),
    "offsets": dict(duration=45.0, scene_seconds=15.0, fps=1.0, width=80, height=60, seed=17,
                    scene_offset=0, tone_offset=6),
    "odd_tail": dict(duration=31.5, scene_seconds=10.0, fps=4.0, width=48, height=32, seed=1,
                     scene_offset=4),
}


@pytest.mark.parametrize("case", sorted(_WRITER_CASES))
def test_writer_frames_pcm_and_bytes_equal(case, tmp_path, monkeypatch):
    kw = _WRITER_CASES[case]
    monkeypatch.setattr(jio, "LibavWriter", _Recorder)
    want_truth = J.write_palette_video(str(tmp_path / "j.mp4"), **kw)
    jrec = _Recorder.last
    monkeypatch.setattr(tio, "LibavWriter", _Recorder)
    got_truth = T.write_palette_video(str(tmp_path / "t.mp4"), **kw)
    trec = _Recorder.last
    assert got_truth == want_truth
    assert trec.args == jrec.args and trec.closed and jrec.closed
    assert len(trec.frames) == len(jrec.frames)  # the same 30 s chunks
    for a, b in zip(trec.frames, jrec.frames):
        np.testing.assert_array_equal(a, b)
    assert len(trec.audio) == len(jrec.audio) == 1
    np.testing.assert_array_equal(trec.audio[0], jrec.audio[0])

    # y4m: chunked, byte-equal to the JAX package's one-shot writers
    y4m_truth = T.write_palette_video(str(tmp_path / "v.y4m"), container="y4m", **kw)
    assert y4m_truth == want_truth
    frames = np.concatenate(jrec.frames)
    jio.write_y4m(str(tmp_path / "ref.y4m"), frames, fps=kw["fps"])
    jio.write_wav(str(tmp_path / "ref.wav"), jrec.audio[0], J.SAMPLE_RATE)
    assert (tmp_path / "v.y4m").read_bytes() == (tmp_path / "ref.y4m").read_bytes()
    assert (tmp_path / "v.wav").read_bytes() == (tmp_path / "ref.wav").read_bytes()
    # the ingest CLI's reader takes it back frame for frame
    r = tio.Y4MReader(str(tmp_path / "v.y4m"))
    assert (r.num_frames, r.width, r.height, r.fps) == (len(frames), kw["width"], kw["height"], kw["fps"])


def test_writer_mp4_decodes_equal_to_jax(tmp_path):
    if not (tio.libav_available() and jio._load_native() is not None):
        pytest.skip("the libav shims did not build on this host")
    kw = _WRITER_CASES["chunks"]
    J.write_palette_video(str(tmp_path / "j.mp4"), **kw)
    T.write_palette_video(str(tmp_path / "t.mp4"), **kw)
    jr, tr = tio.open_video(str(tmp_path / "j.mp4")), tio.open_video(str(tmp_path / "t.mp4"))
    try:
        assert tr.info == jr.info and tr.info.num_frames == 150
        idx = list(range(tr.info.num_frames))
        np.testing.assert_array_equal(tr.read_rgb(idx), jr.read_rgb(idx))
    finally:
        jr.close()
        tr.close()
    np.testing.assert_array_equal(tio.demux_audio(str(tmp_path / "t.mp4")),
                                  tio.demux_audio(str(tmp_path / "j.mp4")))


def test_writer_rejects_unknown_container(tmp_path):
    with pytest.raises(ValueError, match="container"):
        T.write_palette_video(str(tmp_path / "v.avi"), 10.0, container="avi")


def test_mp4_without_libav_raises(tmp_path, monkeypatch):
    """No silent switch to y4m: the mp4 corpus needs the libav shim."""
    monkeypatch.setattr(tio, "_libav", lambda: None)
    with pytest.raises(RuntimeError, match="libav shim"):
        T.run_harness(str(tmp_path), duration=20.0, scene_seconds=10.0, n_questions=2, width=64,
                      height=48, device="cpu")
    assert not os.listdir(tmp_path / "videos")


# ---------------------------------------------------------------------------
# end to end: both run_harness functions, one tiny fp32 ImageBind
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def towers():
    jib = JImageBind(variant="tiny", dtype=jnp.float32, seed=0)
    tib = TImageBind(variant="tiny", dtype=torch.float32, device="cpu",
                     params=params_from_jax(jax.tree.map(np.asarray, jib.params), jib.cfg, "cpu",
                                            torch.float32))
    return jib, tib


def _both(towers, tmp_path_factory, prompts=None, **kw):
    """Each package's run_harness on the CPU with the shared ImageBind, each
    result with its batched path's answers (`batched`); the JAX reasoning
    oracle's prompts appended to `prompts`."""
    from hippomm_tpu.retrieval.qa import QARecallSystem as JQA
    from hippomm_tpu_torch.retrieval.qa import QARecallSystem as TQA

    jib, tib = towers
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "ImageBind", lambda *a, **k: jib)
        mp.setattr(tengine, "ImageBind", lambda *a, **k: tib)
        batched = {}
        for pkg, cls in (("jax", JQA), ("torch", TQA)):
            def spy_batch(self, questions, real=cls.answer_questions, pkg=pkg):
                rs = real(self, questions)
                batched[pkg] = [r.answer for r in rs]
                return rs

            mp.setattr(cls, "answer_questions", spy_batch)
        if prompts is not None:
            real = J.OracleReasoning.chat

            def spy(self, messages, *a, **k):
                prompts.append(messages)
                return real(self, messages, *a, **k)

            mp.setattr(J.OracleReasoning, "chat", spy)
        common = dict(scene_seconds=15.0, width=160, height=120, **kw)
        out["jax"] = J.run_harness(str(tmp_path_factory.mktemp("jax_qa")), **common)
        out["torch"] = T.run_harness(str(tmp_path_factory.mktemp("torch_qa")), device="cpu", **common)
    for pkg in out:
        out[pkg]["batched"] = batched[pkg]
    return out


@pytest.fixture(scope="module")
def clean_runs(towers, tmp_path_factory):
    prompts = []
    out = _both(towers, tmp_path_factory, prompts=prompts, duration=45.0, n_questions=12, n_videos=2,
                negatives=True)
    return out, prompts


@pytest.fixture(scope="module")
def noisy_runs(towers, tmp_path_factory):
    return _both(towers, tmp_path_factory, duration=45.0, n_questions=12, n_videos=1, negatives=False,
                 caption_noise=0.9)


@pytest.mark.parametrize("key", ["questions", "answers", "verdicts", "batched", "qa_accuracy",
                                 "qa_accuracy_batched", "accuracy_by_type", "ci95", "counts"])
def test_run_harness_clean_equal(clean_runs, key):
    (out, _), field = clean_runs, {"questions": "q", "answers": "answer", "verdicts": "correct"}.get(key)
    j, t = out["jax"], out["torch"]
    if field:
        assert [r[field] for r in t["results"]] == [r[field] for r in j["results"]]
        assert [r["type"] for r in t["results"]] == [r["type"] for r in j["results"]]
    elif key == "counts":
        for k in ("n_questions", "n_videos", "n_scenes", "media_s", "failed_videos", "caption_noise",
                  "distractors"):
            assert t[k] == j[k], k
        assert (t["n_questions"], t["n_scenes"], t["failed_videos"]) == (12, 6, 0)
        assert sorted(t) == sorted(j)
    else:
        assert t[key] == j[key]
    assert len(t["batched"]) == 12
    assert t["qa_accuracy"] == 1.0 and t["qa_accuracy_batched"] == 1.0


def test_reasoning_oracle_equal_on_every_prompt(clean_runs):
    _, prompts = clean_runs
    assert len(prompts) > 50
    for messages in prompts:
        assert T.OracleReasoning().chat(messages) == J.OracleReasoning().chat(messages)


def test_score_answer_on_the_jax_runs_answers(clean_runs, noisy_runs):
    """Both scorers agree on every answer the JAX runs gave, clean and noisy."""
    truth_runs = [(clean_runs[0]["jax"], dict(n_videos=2, negatives=True)),
                  (noisy_runs["jax"], dict(n_videos=1, negatives=False))]
    for run, kw in truth_runs:
        truth = _truth(kw["n_videos"], False)
        qs = J.build_questions(truth, 12, seed=0, negatives=kw["negatives"])
        assert [q["question"] for q in qs] == [r["q"] for r in run["results"]]
        for q, r in zip(qs, run["results"]):
            assert T.score_answer(q, r["answer"], truth) == J.score_answer(q, r["answer"], truth) == r["correct"]


@pytest.mark.parametrize("field", ["q", "answer", "correct"])
def test_run_harness_noisy_single_path_equal(noisy_runs, field):
    j, t = noisy_runs["jax"], noisy_runs["torch"]
    assert [r[field] for r in t["results"]] == [r[field] for r in j["results"]]
    assert t["qa_accuracy"] == j["qa_accuracy"] < 1.0
    assert t["accuracy_by_type"]["count"] == 1.0


# ---------------------------------------------------------------------------
# the spread under caption noise (run as a script; see the module doc)
# ---------------------------------------------------------------------------


def _spread_run(pkg: str, serial: bool) -> dict:
    """One run of `pkg`'s harness at bench config #5's shape (this process
    only: its engine's ImageBind and, with `serial`, its thread pools are
    patched for good)."""
    import concurrent.futures

    from hippomm_tpu.retrieval import qa as jqa
    from hippomm_tpu_torch.retrieval import qa as tqa

    jib = JImageBind(variant="tiny", dtype=jnp.float32, seed=0)
    if pkg == "jax":
        harness, qa, kw = J, jqa, {}
        jengine.ImageBind = lambda *a, **k: jib
    else:
        harness, qa, kw = T, tqa, {"device": "cpu"}
        tib = TImageBind(variant="tiny", dtype=torch.float32, device="cpu",
                         params=params_from_jax(jax.tree.map(np.asarray, jib.params), jib.cfg, "cpu",
                                                torch.float32))
        tengine.ImageBind = lambda *a, **k: tib
    if serial:
        real_init = qa.QARecallSystem.__init__

        class OneWorker(concurrent.futures.ThreadPoolExecutor):
            def __init__(self, max_workers=None, *a, **k):
                super().__init__(1, *a, **k)

        def init(self, *a, **k):
            # the QA system is built after the ingest: only the QA pools serialize
            concurrent.futures.ThreadPoolExecutor = OneWorker
            real_init(self, *a, **k)

        qa.QARecallSystem.__init__ = init
    with tempfile.TemporaryDirectory() as work:
        out = harness.run_harness(work, duration=180.0, scene_seconds=15.0, n_questions=120, n_videos=3,
                                  negatives=True, caption_noise=0.15, distractors=True, seed=0, **kw)
    answers = [r["answer"] for r in out["results"]]
    return {"package": pkg, "serial": serial, "qa_accuracy": out["qa_accuracy"],
            "qa_accuracy_batched": out["qa_accuracy_batched"],
            "answers_sha": hashlib.sha1(json.dumps(answers).encode()).hexdigest()[:12]}


def _spread_main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10, help="runs per package")
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--serial", action="store_true", help="QA thread pools at one worker")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)  # a child run: the package
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(_spread_run(args.one, args.serial)))
        return
    runs = []
    for pkg in args.packages.split(","):
        for _ in range(args.runs):
            cmd = [sys.executable, os.path.abspath(__file__), "--one", pkg] + (["--serial"] if args.serial else [])
            proc = subprocess.run(cmd, capture_output=True, text=True, check=True,
                                  env=dict(os.environ, JAX_PLATFORMS="cpu"))
            r = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append(r)
            print(r["package"], r["serial"], r["qa_accuracy"], r["qa_accuracy_batched"], r["answers_sha"],
                  flush=True)
    summary = {}
    for pkg in args.packages.split(","):
        mine = [r for r in runs if r["package"] == pkg]
        summary[pkg] = {k: [r[k] for r in mine] for k in ("qa_accuracy", "qa_accuracy_batched", "answers_sha")}
    print(json.dumps({"serial": args.serial, "runs": summary}))


if __name__ == "__main__":
    _spread_main()
