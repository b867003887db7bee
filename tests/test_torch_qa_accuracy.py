"""The port's copy of tests/test_qa_accuracy.py: the CI-sized QA-accuracy
harness run (bench.py config #5 shape) through hippomm_tpu_torch, on
the CPU (device="cpu"), each run over both corpus containers (mp4 needs the
libav shim and skips without it; y4m always runs). Synthetic palette video,
oracle model clients, real ingest + QA pipelines. Accuracy measures
retrieval localization — wrong windows give wrong colors/tones."""

import pytest

from hippomm_tpu_torch.benchmarks.qa_harness import (
    OracleASR,
    OracleVLM,
    build_questions,
    run_harness,
    score_answer,
    tone_label,
)


@pytest.fixture(params=["mp4", "y4m"])
def container(request):
    """The corpus container; mp4 only where the libav shim builds."""
    from hippomm_tpu_torch.media.io import libav_available

    if request.param == "mp4" and not libav_available():
        pytest.skip("the libav shim did not build on this host")
    return request.param



def test_qa_harness_end_to_end(tmp_path, container):
    out = run_harness(
        str(tmp_path),
        duration=90.0,
        scene_seconds=15.0,
        n_questions=8,
        imagebind_variant="tiny",
        device="cpu",
        container=container,
        width=160,
        height=120,
        negatives=False,
    )
    assert out["failed_videos"] == 0
    assert out["n_questions"] == 8
    # the oracle clients are deterministic; every question must localize
    assert out["qa_accuracy"] >= 0.85
    assert out["qa_accuracy_batched"] >= 0.85  # batched serving path too
    assert out["ingest_x"] > 0
    lo, hi = out["ci95"]
    assert lo <= out["qa_accuracy"] <= hi


def test_qa_harness_multivideo_with_negatives(tmp_path, container):
    """Two-video corpus (globally unique colors/tones) + distractor questions:
    retrieval must pick the right video AND decline absent content."""
    out = run_harness(
        str(tmp_path),
        duration=45.0,
        scene_seconds=15.0,
        n_questions=12,
        imagebind_variant="tiny",
        device="cpu",
        container=container,
        width=160,
        height=120,
        n_videos=2,
        negatives=True,
    )
    assert out["failed_videos"] == 0
    assert out["n_videos"] == 2 and out["n_scenes"] == 6
    assert set(out["accuracy_by_type"]) == {
        "video", "audio", "multimodal", "summary", "count", "xmodal", "order",
        "which_video", "video_neg", "audio_neg", "after_tone", "count_video"
    }
    assert out["qa_accuracy"] >= 0.8
    assert out["accuracy_by_type"]["video_neg"] == 1.0
    assert out["accuracy_by_type"]["audio_neg"] == 1.0
    # cross-video aggregation: answerable only because multi-video recall
    # evidence is attributed to its source video
    assert out["accuracy_by_type"]["which_video"] == 1.0
    # per-video counting rides the fast path's attributed captions
    assert out["accuracy_by_type"]["count_video"] == 1.0


def test_oracle_asr_labels_tones(tmp_path):
    import numpy as np

    t = np.arange(16000 * 2) / 16000.0
    pcm = (0.3 * np.sin(2 * np.pi * 240.0 * t)).astype(np.float32)
    segs = OracleASR().transcribe(pcm)
    assert segs and all(s.text == tone_label(240.0) for s in segs)


def test_score_answer():
    truth = {"scenes": [(0.0, 15.0, "red", 200.0), (15.0, 30.0, "green", 240.0)]}
    q = {"type": "video", "color": "green"}
    assert score_answer(q, "ANSWER: 16.0 seconds", truth)
    assert not score_answer(q, "ANSWER: 5.0 seconds", truth)
    qa = {"type": "audio", "label": "tone240hz"}
    assert score_answer(qa, "heard tones: tone240hz", truth)
    assert not score_answer(qa, "heard tones: tone200hz", truth)


def test_score_answer_hard_families():
    truth = {"scenes": [(0.0, 15.0, "red", 200.0), (15.0, 30.0, "green", 240.0)]}
    qo = {"type": "order", "pair": ["green", "red"], "expected": "red"}
    assert score_answer(qo, "red", truth)
    assert not score_answer(qo, "green", truth)
    assert not score_answer(qo, "not found", truth)
    qc = {"type": "count", "expected": 2}
    assert score_answer(qc, "2", truth)
    assert not score_answer(qc, "3", truth)
    assert not score_answer(qc, "several", truth)
    qx = {"type": "xmodal", "expected_yes": True, "color": "red", "label": "tone200hz"}
    assert score_answer(qx, "yes", truth)
    assert not score_answer(qx, "no (the background is green)", truth)
    assert not score_answer(qx, "unknown", truth)
    qxn = {"type": "xmodal", "expected_yes": False, "color": "green", "label": "tone200hz"}
    assert score_answer(qxn, "no (the background is red)", truth)
    assert not score_answer(qxn, "yes", truth)
    qw = {"type": "which_video", "pair": ["red", "green"],
          "expected": "palette00", "names": ["palette00", "palette01"]}
    assert score_answer(qw, "ANSWER: palette00", truth)
    assert not score_answer(qw, "ANSWER: palette01", truth)
    assert not score_answer(qw, "unknown", truth)
    # the FIRST named video is the claim; a later mention of the right name
    # doesn't rescue a wrong first claim
    assert not score_answer(qw, "palette01 (not palette00)", truth)


def test_build_questions_hard_families_and_empty_negatives():
    """Hard families are generated with oracle-checkable expectations, and a
    palette-saturating truth (no absent colors) degrades gracefully instead of
    raising IndexError (ADVICE r3 #4)."""
    from hippomm_tpu_torch.benchmarks.qa_harness import PALETTE

    truth = {
        "scenes": [(0.0, 15.0, "red", 200.0), (15.0, 30.0, "green", 240.0),
                   (0.0, 15.0, "blue", 280.0), (15.0, 30.0, "yellow", 320.0)],
        "video_scenes": [
            [(0.0, 15.0, "red", 200.0), (15.0, 30.0, "green", 240.0)],
            [(0.0, 15.0, "blue", 280.0), (15.0, 30.0, "yellow", 320.0)],
        ],
    }
    qs = build_questions(truth, 27, seed=3, negatives=True)
    kinds = {q["type"] for q in qs}
    assert {"order", "count", "xmodal"} <= kinds
    # no video names in the truth -> cross-video questions can't be asked
    assert "which_video" not in kinds

    named = dict(truth, video_names=["vidA", "vidB"])
    qs_n = build_questions(named, 30, seed=3, negatives=True)
    wv = [q for q in qs_n if q["type"] == "which_video"]
    assert wv
    for q in wv:
        # both asked colors belong to the expected video's scene set
        vi = named["video_names"].index(q["expected"])
        colors = {c for _, _, c, _ in truth["video_scenes"][vi]}
        assert set(q["pair"]) <= colors
        assert q["names"] == ["vidA", "vidB"]
    for q in qs:
        if q["type"] == "order":
            # the expected color is the pair member whose scene starts earlier
            # WITHIN one video (cross-video times overlap)
            a, b = q["pair"]
            assert q["expected"] in (a, b)
            vid = next(v for v in truth["video_scenes"]
                       if {a, b} <= {c for _, _, c, _ in v})
            starts = {c: s for s, _, c, _ in vid}
            assert starts[q["expected"]] == min(starts[a], starts[b])
        elif q["type"] == "count":
            assert q["expected"] == 4
        elif q["type"] == "xmodal":
            scene = next(s for s in truth["scenes"]
                         if f"tone{int(s[3])}hz" == q["label"])
            assert q["expected_yes"] == (scene[2] == q["color"])

    # palette-saturating truth: every color used -> no video_neg, no crash
    full = {"scenes": [(float(i), float(i + 1), name, 200.0 + 40 * i)
                       for i, (name, _) in enumerate(PALETTE)]}
    qs2 = build_questions(full, 30, seed=0, negatives=True)
    assert all(q["type"] != "video_neg" for q in qs2)
    assert any(q["type"] == "audio_neg" for q in qs2)
    # xmodal yes/no balance must survive an EVEN kinds count (this config has
    # 8 kinds): a qi-parity rule gave every xmodal question the same answer,
    # letting a constant-'no' pipeline score 100% on the family
    xm = [q["expected_yes"] for q in qs2 if q["type"] == "xmodal"]
    assert len(xm) >= 2 and True in xm and False in xm


def test_score_answer_new_families():
    truth = {"scenes": [(0.0, 15.0, "red", 200.0), (15.0, 30.0, "green", 240.0)]}
    qa = {"type": "after_tone", "label": "tone200hz", "expected": "green"}
    assert score_answer(qa, "ANSWER: green", truth)
    # the FIRST color named is the claim — echoing the in-window color first
    # doesn't score even if the right color appears later
    assert not score_answer(qa, "red (then green)", truth)
    assert not score_answer(qa, "not found", truth)
    qc = {"type": "count_video", "video": "palette01", "expected": 2}
    assert score_answer(qc, "2", truth)
    assert not score_answer(qc, "3", truth)


def test_build_questions_new_families():
    truth = {
        "scenes": [(0.0, 15.0, "red", 200.0), (15.0, 30.0, "green", 240.0),
                   (0.0, 15.0, "blue", 280.0), (15.0, 30.0, "yellow", 320.0)],
        "video_scenes": [
            [(0.0, 15.0, "red", 200.0), (15.0, 30.0, "green", 240.0)],
            [(0.0, 15.0, "blue", 280.0), (15.0, 30.0, "yellow", 320.0)],
        ],
        "video_names": ["vidA", "vidB"],
    }
    qs = build_questions(truth, 40, seed=1, negatives=True)
    at = [q for q in qs if q["type"] == "after_tone"]
    assert at
    for q in at:
        # expected = the color of the scene FOLLOWING the tone's scene
        scene = next(s for v in truth["video_scenes"] for s in v
                     if tone_label(s[3]) == q["label"])
        vid = next(v for v in truth["video_scenes"] if scene in v)
        assert q["expected"] == vid[vid.index(scene) + 1][2]
    cv = [q for q in qs if q["type"] == "count_video"]
    assert cv
    for q in cv:
        vi = truth["video_names"].index(q["video"])
        assert q["expected"] == len({c for _, _, c, _ in truth["video_scenes"][vi]})


def test_which_video_pairs_unique_under_duplicated_colors():
    """Distractor corpora duplicate whole color sets; which_video questions
    must still have exactly one correct answer."""
    dup = [(0.0, 15.0, "red", 200.0), (15.0, 30.0, "green", 240.0)]
    uniq = [(0.0, 15.0, "blue", 280.0), (15.0, 30.0, "yellow", 320.0)]
    dup2 = [(0.0, 15.0, "red", 360.0), (15.0, 30.0, "green", 400.0)]
    truth = {
        "scenes": dup + uniq + dup2,
        "video_scenes": [dup, uniq, dup2],
        "video_names": ["vidA", "vidB", "vidC"],
    }
    qs = build_questions(truth, 60, seed=2, negatives=False)
    wv = [q for q in qs if q["type"] == "which_video"]
    assert wv
    for q in wv:
        # every drawn pair identifies exactly ONE video
        holders = [
            nm for nm, vs in zip(truth["video_names"], truth["video_scenes"])
            if set(q["pair"]) <= {c for _, _, c, _ in vs}
        ]
        assert holders == [q["expected"]] == ["vidB"]


def test_oracle_vlm_caption_noise():
    import io

    import numpy as np

    from hippomm_tpu_torch.media.io import jpeg_encode

    # solid red frame
    img = np.zeros((32, 32, 3), np.uint8)
    img[:] = (200, 30, 30)
    data = jpeg_encode(img)
    clean = OracleVLM(caption_noise=0.0, noise_colors=["red", "green", "blue"])
    assert all("red" in c for c in clean.caption_images([data] * 20, ""))
    noisy = OracleVLM(caption_noise=1.0, noise_colors=["red", "green", "blue"],
                      seed=1)
    caps = noisy.caption_images([data] * 20, "")
    # always corrupted at p=1.0, always to the nearest-by-RGB OTHER color
    assert all("red" not in c for c in caps)
    assert len({c for c in caps}) == 1  # deterministic confusion target


def test_qa_harness_noise_takes_gauge_off_ceiling(tmp_path, container):
    """The difficulty knob's contract (VERDICT r4 Next #4): extreme
    query-time caption noise must push accuracy measurably below 1.0 —
    a gauge that still reads 1.0 under p=0.9 corruption measures nothing."""
    out = run_harness(
        str(tmp_path),
        duration=45.0,
        scene_seconds=15.0,
        n_questions=12,
        imagebind_variant="tiny",
        device="cpu",
        container=container,
        width=160,
        height=120,
        n_videos=1,
        negatives=False,
        caption_noise=0.9,
    )
    assert out["caption_noise"] == 0.9
    assert out["qa_accuracy"] < 1.0
    # ingest-stored evidence stays clean: counting is still exact
    assert out["accuracy_by_type"]["count"] == 1.0
