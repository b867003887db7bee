"""The port's query path as a whole against the JAX package, on the CPU:
`FeatureSearchIndex` on both routes, the budget and window helpers, the
recall media helpers, `QARecallSystem` of both packages over one store
(every question type, single and batched, with stub clients and ImageBind
weights carried across) and the `ask_question` CLI.

The store is two videos' ThetaEvents written by the JAX store: random unit
features with the stub-compressed query's own text embedding planted in
some rows (so the searches pass the similarity gate), key-frame JPEGs on
disk, transcripts, and each video's audio track as audio.npy (so the sound
pathway re-transcribes)."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hippomm_tpu.config import Config as JConfig
from hippomm_tpu.core import ask_question as jask
from hippomm_tpu.media import io as jio
from hippomm_tpu.memory.engine import HippocampalMemory as JMemory
from hippomm_tpu.memory.schema import ThetaEvent as JThetaEvent
from hippomm_tpu.memory.store import MemoryStore as JStore
from hippomm_tpu.models.clients import StubClient as JStub
from hippomm_tpu.models.foundation import ImageBind as JImageBind
from hippomm_tpu.models.foundation import Whisper as JWhisper
from hippomm_tpu.models.imagebind import model as jm
from hippomm_tpu.retrieval import budget as jbudget
from hippomm_tpu.retrieval.qa import QARecallSystem as JQA
from hippomm_tpu.retrieval.search import FeatureSearchIndex as JIndex
from hippomm_tpu.retrieval.search import merge_windows as jmerge
from hippomm_tpu_torch.config import Config as TConfig
from hippomm_tpu_torch.core import ask_question as task
from hippomm_tpu_torch.media import io as tio
from hippomm_tpu_torch.memory.engine import HippocampalMemory as TMemory
from hippomm_tpu_torch.memory.schema import ThetaEvent as TThetaEvent
from hippomm_tpu_torch.models.clients import StubClient as TStub
from hippomm_tpu_torch.models.foundation import ImageBind as TImageBind
from hippomm_tpu_torch.models.foundation import Whisper as TWhisper
from hippomm_tpu_torch.models.imagebind import model as tm
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
from hippomm_tpu_torch.retrieval import budget as tbudget
from hippomm_tpu_torch.retrieval import search as tsearch
from hippomm_tpu_torch.retrieval.qa import QARecallSystem as TQA
from hippomm_tpu_torch.retrieval.search import FeatureSearchIndex as TIndex
from hippomm_tpu_torch.retrieval.search import merge_windows as tmerge
from torch_parity import assert_close, imagebind_params_np

Q_VIDEO = "What color is the moving square?"
Q_SOUND = "What sound plays in the background?"
Q_SPEECH = "What did the speaker say?"
Q_SUMMARY = "What is the overall summary of the videos?"
Q_MM_SOUND = "What is seen while the sound plays together?"
Q_MM_VIDEO = "What is shown on screen together?"
QUESTIONS = [Q_VIDEO, Q_SOUND, Q_SPEECH, Q_SUMMARY, Q_MM_SOUND, Q_MM_VIDEO]
_SIGNATURE = re.compile(r"frame signature [0-9a-f]{8}")


class Reasoner:
    """The package's stub client with two changes, the same for both
    packages: a question with "together" classifies as VIDEO+AUDIO (the stub
    never replies that label), and the detailed final answer differs from
    the fast path's, so reflection runs. Records every final-answer prompt."""

    def __init__(self, stub):
        self.stub = stub
        self.final_prompts = []

    def chat(self, messages, max_tokens=512, temperature=0.0):
        text = messages[-1]["content"] if isinstance(messages[-1]["content"], str) else ""
        if text.startswith("Classify this question") and "together" in text.rsplit("Question:", 1)[-1]:
            return "VIDEO+AUDIO"
        if text.startswith("Using only the retrieved evidence"):
            self.final_prompts.append(_SIGNATURE.sub("frame signature -", text))
            return "ANSWER: The detailed recall answer.\nCONFIDENCE: 0.6"
        return self.stub.chat(messages, max_tokens, temperature)

    def caption_images(self, jpegs, prompt, max_workers=8):
        return self.stub.caption_images(jpegs, prompt, max_workers)


def _jax_imagebind(monkeypatch):
    monkeypatch.setattr(jm, "init_imagebind", lambda key, cfg: imagebind_params_np(cfg, 7))
    jib = JImageBind(variant="tiny", dtype=jnp.float32)
    tib = TImageBind(variant="tiny", dtype=torch.float32, device="cpu",
                     params=params_from_jax(jax.tree.map(np.asarray, jib.params), jib.cfg, "cpu",
                                            torch.float32))
    return jib, tib


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _compressed(question):
    """The stub's search query for `question` (its first four words)."""
    return " ".join(re.findall(r"[a-z]+", question.lower())[:4])


def _write_store(base, jib, rng):
    store = JStore(base)
    planted = jib.encode_text([_compressed(Q_VIDEO), _compressed(Q_SOUND)])
    frames_dir = os.path.join(base, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    for v, (vid, n_vis, n_aud, dur) in enumerate((("va", 24, 8, 40.0), ("vb", 30, 6, 36.0))):
        vis = _unit(rng.standard_normal((n_vis, 1024)))
        vis[5 + v] = _unit(planted[0] + 0.3 * np.linalg.norm(planted[0]) * _unit(rng.standard_normal(1024)))
        aud = 20.0 * _unit(rng.standard_normal((n_aud, 1024)))
        if vid == "vb":
            aud[2] = 20.0 * _unit(planted[1] + 0.2 * np.linalg.norm(planted[1]) * _unit(rng.standard_normal(1024)))
        kf_times = [2.0 + 6.0 * i for i in range(6)]
        paths = []
        for i, t in enumerate(kf_times):
            img = np.zeros((180, 320, 3), np.uint8)
            img[:, :, i % 3] = 40 + 30 * i
            img[20 * i : 20 * i + 60, 40 * i : 40 * i + 90] = rng.integers(0, 255, 3)
            p = os.path.join(frames_dir, f"{vid}_{i}.jpg")
            jio.write_jpeg(p, img)
            paths.append(p)
        seg = dur / n_aud
        trans = [{"text": f"{vid} speech part {i}", "start": i * seg, "end": (i + 1) * seg}
                 for i in range(n_aud)]
        ev = JThetaEvent(
            video_id=vid,
            features={"vision": vis, "audio": aud},
            feature_times={"vision": [1.5 * i for i in range(n_vis)],
                           "audio": [i * seg for i in range(n_aud)]},
            frames=paths, frame_times=kf_times,
            frame_captions=[f"{vid} caption {i}" for i in range(6)],
            audio_times=[i * seg for i in range(n_aud)], audio_transcription=trans,
            holistic_audio_transcription=[dict(t, text=t["text"] + " (whole track)") for t in trans],
            summary=f"Video {vid} shows colored blocks.", start_time=0.0, end_time=dur,
            modalities=["vision", "audio"],
        )
        store.save_theta_event(ev)
        store.add_video(vid, os.path.join(base, f"{vid}.y4m"))  # names no file
        t = np.arange(int(dur * 16000), dtype=np.float32) / 16000
        pcm = (0.1 + 0.05 * v) * np.sin(2 * np.pi * 440 * t) * (1 + np.sin(2 * np.pi * 0.05 * t))
        os.makedirs(os.path.join(store.audio_dir, vid), exist_ok=True)
        np.save(os.path.join(store.audio_dir, vid, "audio.npy"), pcm.astype(np.float32))
    return base


def _configs(base):
    out = {}
    for pkg, cls in (("jax", JConfig), ("torch", TConfig)):
        cfg = cls()
        cfg.api.mode = "stub"
        cfg.models.imagebind_variant = "tiny"
        cfg.models.whisper_variant = "stub"
        cfg.storage.base_dir = base
        cfg.processing.fast_path_confidence = 2.0
        if pkg == "jax":
            cfg.system.mesh_data = 1  # one device: the single-device index
        else:
            cfg.models.compute_dtype = "float32"
        out[pkg] = cfg
    return out


@pytest.fixture(scope="module")
def qa_pair(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        jib, tib = _jax_imagebind(mp)
    base = _write_store(str(tmp_path_factory.mktemp("qa_store")), jib, np.random.default_rng(21))
    cfgs = _configs(base)
    jmem = JMemory(cfgs["jax"], models={"imagebind": jib, "whisper": JWhisper(variant="stub")})
    tmem = TMemory(cfgs["torch"], device="cpu", models={"imagebind": tib, "whisper": TWhisper(variant="stub")})
    assert jmem.mesh is None
    for mem in (jmem, tmem):
        mem.load_all_events()
    return jmem, tmem, cfgs


def _qa(pair):
    jmem, tmem, cfgs = pair
    jr, tr = Reasoner(JStub("reasoning")), Reasoner(TStub("reasoning"))
    return JQA(jmem, cfgs["jax"], reasoning_client=jr), TQA(tmem, cfgs["torch"], reasoning_client=tr), jr, tr


def _assert_results_equal(request, got, want, what):
    g, w = got.to_dict(), want.to_dict()
    gs, ws = g.pop("retrieved_segments"), w.pop("retrieved_segments")
    assert g == w, what
    assert len(gs) == len(ws), what
    for a, b in zip(gs, ws):
        sa, sb = a.pop("similarity", None), b.pop("similarity", None)
        assert a == b, what
        if sb is not None:
            assert_close(request, [sa], [sb], 1e-5, f"similarity_{what}")


@pytest.mark.parametrize("route", ["host", "device"])
def test_answer_question_matches_jax(request, qa_pair, monkeypatch, route):
    monkeypatch.setenv("HIPPOMM_TOPK_ROUTE", route)
    jqa, tqa, jr, tr = _qa(qa_pair)
    seen = set()
    for q in QUESTIONS:
        want, got = jqa.answer_question(q), tqa.answer_question(q)
        _assert_results_equal(request, got, want, f"{route}:{q}")
        seen.add((got.question_type, got.primary_modality))
        if got.question_type != "SUMMARY":
            assert got.used_reflection and not got.used_direct_answer
    # every pathway ran: video, speech, sound, multimodal both ways, summary
    assert seen == {("VIDEO", "video"), ("AUDIO", "sound"), ("AUDIO", "speech"), ("SUMMARY", ""),
                    ("VIDEO+AUDIO", "sound"), ("VIDEO+AUDIO", "video")}
    # the evidence the answers saw: frame times and dedup, transcripts
    assert tr.final_prompts == jr.final_prompts
    video = tqa.answer_question(Q_VIDEO)
    assert video.retrieved_segments[0]["similarity"] >= 0.4  # the planted row, not the fallback
    assert any("Tone segment" in p for p in tr.final_prompts)  # re-transcribed audio


@pytest.mark.parametrize("route", ["host", "device"])
def test_answer_questions_batched_matches_jax(request, qa_pair, monkeypatch, route):
    monkeypatch.setenv("HIPPOMM_TOPK_ROUTE", route)
    jqa, tqa, _, _ = _qa(qa_pair)
    want = jqa.answer_questions(QUESTIONS + [Q_VIDEO])
    got = tqa.answer_questions(QUESTIONS + [Q_VIDEO])
    assert len(got) == len(want) == len(QUESTIONS) + 1
    for q, g, w in zip(QUESTIONS + [Q_VIDEO], got, want):
        _assert_results_equal(request, g, w, f"batch {route}:{q}")
    _assert_results_equal(request, got[0], tqa.answer_question(Q_VIDEO), "batch vs single")


def _events(pkg_event, rng):
    """One event dominating the best rows (the over-fetch must widen) and
    two more."""
    q = _unit(rng.standard_normal(1024))
    evs = []
    for e, (n, pull) in enumerate(((150, 0.9), (12, 0.3), (9, 0.0))):
        f = _unit(rng.standard_normal((n, 1024)) + pull * 32 * q)
        evs.append(pkg_event(video_id=f"v{e}", features={"vision": f},
                             feature_times={"vision": [0.5 * i for i in range(n)]},
                             start_time=10.0 * e, end_time=10.0 * e + 30))
    return evs, q


@pytest.mark.parametrize("route", ["host", "device"])
def test_search_matches_jax(request, monkeypatch, route):
    monkeypatch.setenv("HIPPOMM_TOPK_ROUTE", route)
    jev, q = _events(JThetaEvent, np.random.default_rng(5))
    tev, _ = _events(TThetaEvent, np.random.default_rng(5))
    jidx, tidx = JIndex.build(jev, "vision"), TIndex.build(tev, "vision", device="cpu")
    assert len(tidx) == len(jidx) == 171
    queries = np.stack([q, _unit(np.random.default_rng(6).standard_normal(1024))])
    # first k 40, 28, 12 and 171: the deficient ones widen past 128 rows
    cases = [(5, 5, 1.0), (2, 7, 2.0), (1, 3, 1.0), (30, 45, 1.0)]
    for per, glob, win in cases:
        for qi in range(2):
            want = jidx.search(queries[qi], per, glob, win)
            got = tidx.search(torch.from_numpy(queries[qi]), per, glob, win)
            _compare_hits(request, got, want)
        for got, want in zip(tidx.search_batch(queries, per, glob, win), jidx.search_batch(queries, per, glob, win)):
            _compare_hits(request, got, want)


def _compare_hits(request, got, want):
    assert [(h.event_id, h.video_id, h.time, h.index_in_event, h.window) for h in got] == [
        (h.event_id, h.video_id, h.time, h.index_in_event, h.window) for h in want]
    if want:
        assert_close(request, [h.similarity for h in got], [h.similarity for h in want], 1e-5)


def test_search_device_route_runs_k5_and_raises_on_a_fault(monkeypatch):
    """k ≤ 128 takes K5, the widened k > 128 rounds the plain top-k; a fault
    on the device route raises instead of being served from the host."""
    monkeypatch.setenv("HIPPOMM_TOPK_ROUTE", "device")
    tev, q = _events(TThetaEvent, np.random.default_rng(5))
    idx = TIndex.build(tev, "vision", device="cpu")
    calls = []
    real = tsearch.top_k_cosine_kernel
    monkeypatch.setattr(tsearch, "top_k_cosine_kernel", lambda *a: calls.append(a[2]) or real(*a))
    hits = idx.search(torch.from_numpy(q), 1, 3)
    # k 12 and 48 through K5; the last round ranks all 171 rows by the matmul
    assert calls == [12, 48] and len(hits) == 3
    calls.clear()
    idx.search(q, 5, 5)
    assert calls == [40]

    def boom(*a):
        raise RuntimeError("device fault")

    monkeypatch.setattr(tsearch, "top_k_cosine_kernel", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        idx.search(q, 5, 5)
    monkeypatch.setenv("HIPPOMM_TOPK_ROUTE", "host")
    assert len(idx.search(q, 5, 5)) == 5


def test_search_runs_on_the_stores_device_unless_host_is_asked(monkeypatch):
    """With no HIPPOMM_TOPK_ROUTE every query, single or batched, of a small
    store runs where the store lives (K5's wrapper, the batched matmul);
    HIPPOMM_TOPK_ROUTE=host sends them all to the numpy route."""
    monkeypatch.delenv("HIPPOMM_TOPK_ROUTE", raising=False)
    tev, q = _events(TThetaEvent, np.random.default_rng(5))
    idx = TIndex.build(tev, "vision", device="cpu")
    calls, batches, host = [], [], []
    real, real_batch = tsearch.top_k_cosine_kernel, tsearch.top_k_cosine_prenorm
    monkeypatch.setattr(tsearch, "top_k_cosine_kernel", lambda *a: calls.append(a[2]) or real(*a))
    monkeypatch.setattr(tsearch, "top_k_cosine_prenorm", lambda *a: batches.append(a[2]) or real_batch(*a))
    for name in ("_topk_host", "_topk_batch_host"):
        fn = getattr(TIndex, name)
        monkeypatch.setattr(TIndex, name, lambda self, *a, fn=fn: host.append(a[-1]) or fn(self, *a))
    for _ in range(40):
        idx.search(q)
    idx.search_batch(np.stack([q, q]))
    assert calls == [40] * 40 and batches == [40] and host == []
    monkeypatch.setenv("HIPPOMM_TOPK_ROUTE", "host")
    calls.clear(), batches.clear()
    idx.search(q)
    idx.search_batch(np.stack([q, q]))
    assert calls == [] and batches == [] and host == [40, 40]


def test_merge_windows_and_budget_match_jax():
    windows = [(5.0, 7.0), (0.0, 2.0), (3.5, 4.0), (12.0, 13.0), (6.5, 9.0)]
    for gap in (0.0, 1.0, 2.0, 5.0):
        assert tmerge(windows, gap) == jmerge(windows, gap)
    assert tmerge([]) == jmerge([]) == []
    items = [f"caption number {i} " + "word " * (i % 7) for i in range(60)]
    for n, k in ((10, 3), (10, 1), (5, 9), (100, 7)):
        assert tbudget.evenly_spaced_indices(n, k) == jbudget.evenly_spaced_indices(n, k)
    for budget in (10, 100, 400, 10_000):
        assert tbudget.evenly_distribute_items(items, budget, "- {}\n") == \
            jbudget.evenly_distribute_items(items, budget, "- {}\n")
    text = " ".join(items)
    for budget in (5, 50, 5000):
        assert tbudget.truncate_text_to_tokens(text, budget) == jbudget.truncate_text_to_tokens(text, budget)
    assert tbudget.proportional_split(1000, [1.0, 2.0, 0.5]) == jbudget.proportional_split(1000, [1.0, 2.0, 0.5])
    assert tbudget.subsample_note(3, 9) == jbudget.subsample_note(3, 9)
    assert tbudget.subsample_note(9, 9) == jbudget.subsample_note(9, 9) == ""


def test_recall_media_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 255, (3, 360, 640, 3), dtype=np.uint8)
    for gh, gw in ((180, 320), (120, 160), (100, 170), (360, 640)):
        np.testing.assert_array_equal(tio.downscale_rgb(frames, gh, gw), jio.downscale_rgb(frames, gh, gw))
    np.testing.assert_array_equal(tio._luma_u8(frames), jio._luma_u8(frames))
    p = str(tmp_path / "f.jpg")
    jio.write_jpeg(p, frames[0])
    assert np.abs(tio.read_jpeg(p).astype(int) - jio.read_jpeg(p).astype(int)).max() <= 1
    assert tio.jpeg_decode(tio.jpeg_encode(frames[1])).shape == (360, 640, 3)
    with pytest.raises(OSError):
        tio.probe_video(str(tmp_path / "missing.mp4"))
    with pytest.raises(ValueError, match="unsupported video container"):
        tio.open_video(p)


def test_engine_exposes_what_qa_reads(qa_pair):
    _, tmem, _ = qa_pair
    for name in ("imagebind", "frame_client", "_full_audio", "store", "load_all_events",
                 "load_theta_event", "device"):
        assert hasattr(tmem, name), name
    assert callable(tmem.whisper.transcribe_batch)


def _cli_env(tmp_path, monkeypatch, qa_pair):
    """The CLIs build their engines from a YAML config; the towers get the
    fixture's weights through the init functions."""
    jmem, tmem, cfgs = qa_pair
    monkeypatch.setattr(jm, "init_imagebind", lambda key, cfg: imagebind_params_np(cfg, 7))
    monkeypatch.setattr(tm, "init_imagebind", lambda cfg, device, dtype, seed: tmem.imagebind.params)
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({
        "api": {"mode": "stub"}, "system": {"mesh_data": 1},
        "models": {"imagebind_variant": "tiny", "whisper_variant": "stub"},
    }))
    return cfgs["torch"].storage.base_dir, str(cfg)


def test_ask_question_cli_matches_jax(qa_pair, tmp_path, monkeypatch, capsys):
    store, cfg = _cli_env(tmp_path, monkeypatch, qa_pair)
    qf = tmp_path / "qs.txt"
    qf.write_text("\n".join(QUESTIONS) + "\n")
    eid = JStore(store).list_events()[0]
    for argv in (["--list"], ["--event", eid], ["--event", "nope"], ["--question", Q_VIDEO, "--json"],
                 ["--question", Q_SUMMARY], ["--questions-file", str(qf), "--json"]):
        argv = ["--memory-store", store, "--config", cfg] + argv
        rc_j = jask.main(argv)
        out_j = capsys.readouterr()
        rc_t = task.main(argv, device="cpu")
        out_t = capsys.readouterr()
        assert rc_t == rc_j and out_t.out == out_j.out, argv
        if "--json" in argv:
            assert json.loads(out_t.out)
    assert "2 event(s)" in task_list_output(store, capsys)


def task_list_output(store, capsys):
    task.main(["--memory-store", store, "--list"], device="cpu")
    return capsys.readouterr().out


def test_ask_question_runs_on_cuda_by_default(qa_pair, tmp_path, monkeypatch):
    store, cfg = _cli_env(tmp_path, monkeypatch, qa_pair)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from hippomm_tpu_torch.config import load_config

    c = load_config(cfg)
    c.storage.base_dir = store
    with pytest.raises(RuntimeError, match="no CUDA device"):
        task.ask_question(Q_VIDEO, c)
    assert task.ask_question(Q_SUMMARY, c, device="cpu").used_direct_answer
