"""The port's QA server (core/serve.py) against the JAX package's, on the
CPU, over HTTP on ephemeral ports.

Each package ingests the same seeded .mp4 clip into its own store and
serves it; both load one tiny ImageBind checkpoint written from the
manifest (`models.imagebind_path`), so both hold the same weights with no
model construction patched. The port runs fp32 with `device="cpu"` (the JAX
engine builds ImageBind in bf16 whatever the config says). Stub clients;
detailed recall forced (`fast_path_confidence` 2.0). Every endpoint is
driven: /healthz, /events, /ask, /ask_batch and /ingest (a folder and one
file), the 400 and 404 codes, `reload`, a failed ingest and the latency
histogram."""

import concurrent.futures
import json
import os
import threading
import urllib.error
import urllib.request

import pytest
import torch

from hippomm_tpu.config import Config as JConfig
from hippomm_tpu.core import batch_process as jbp
from hippomm_tpu.core import serve as jserve
from hippomm_tpu_torch.config import Config as TConfig
from hippomm_tpu_torch.core import batch_process as tbp
from hippomm_tpu_torch.core import serve as tserve
from hippomm_tpu_torch.media.synth import SynthSpec, write_synthetic_video
from hippomm_tpu_torch.models.imagebind.manifest import random_state_dict
from hippomm_tpu_torch.models.imagebind.model import tiny_config
from hippomm_tpu_torch.ops import _native

QUESTIONS = ["What color is the moving square?", "What sound plays in the background?",
             "What is the overall summary of the video?", "What happens after the scene cut?"]


def _cfg(cls, store: str, ckpt: str):
    cfg = cls()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = "tiny"
    cfg.models.imagebind_path = ckpt
    cfg.models.whisper_variant = "stub"
    cfg.models.compute_dtype = "float32"
    cfg.processing.fast_path_confidence = 2.0
    cfg.storage.base_dir = store
    return cfg


def _req(port: int, path: str, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    if payload is None:
        r = urllib.request.urlopen(url, timeout=120)
    else:
        req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        r = urllib.request.urlopen(req, timeout=300)
    return r.status, json.loads(r.read())


def _both(served, path, payload=None):
    return [_req(served[pkg][1], path, payload) for pkg in ("jax", "torch")]


def _clip(path, seed, duration=12.0, cut=(6.0,)):
    write_synthetic_video(path, SynthSpec(duration=duration, fps=2.0, width=160, height=120,
                                          scene_changes=cut, silence_regions=((2.0, 3.0),), seed=seed))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    if _native.media_libav_lib() is None:
        pytest.skip("the port's libav shim did not build or load on this host: no .mp4")
    tmp = tmp_path_factory.mktemp("torch_serve")
    ckpt = str(tmp / "imagebind_tiny.pth")
    torch.save({k: torch.from_numpy(v) for k, v in random_state_dict(tiny_config(), seed=11).items()}, ckpt)
    videos = tmp / "videos"
    videos.mkdir()
    _clip(str(videos / "clip.mp4"), seed=11, duration=16.0, cut=(9.0,))
    out = {}
    for pkg, cls, bp, serve, kw in (("jax", JConfig, jbp, jserve, {}),
                                    ("torch", TConfig, tbp, tserve, {"device": "cpu"})):
        cfg = _cfg(cls, str(tmp / f"{pkg}_store"), ckpt)
        stats = bp.process_video_folder(str(videos), cfg.storage.base_dir, config=cfg, **kw)
        assert (stats["processed"], stats["failed"]) == (1, 0)
        service = serve.QAService(cfg, **kw)
        server = serve.make_server(service, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        out[pkg] = (service, server.server_address[1], server)
    out["tmp"] = str(tmp)
    out["ckpt"] = ckpt
    yield out
    for pkg in ("jax", "torch"):
        out[pkg][2].shutdown()
        out[pkg][2].server_close()


def test_healthz_and_events_match_jax(served):
    (js, jh), (ts, th) = _both(served, "/healthz")
    assert js == ts == 200 and th["status"] == "ok"
    assert (th["events"], th["videos"]) == (jh["events"], jh["videos"]) == (1, 1)
    (_, je), (_, te) = _both(served, "/events")
    assert te == je and len(te["events"]) == 1


def test_ask_matches_jax(served):
    for q in QUESTIONS:
        (js, want), (ts, got) = _both(served, "/ask", {"question": q})
        assert js == ts == 200
        assert got == want, q
    assert got["answer"] and got["question_type"]


def test_ask_batch_matches_jax(served):
    (js, want), (ts, got) = _both(served, "/ask_batch", {"questions": QUESTIONS})
    assert js == ts == 200 and len(got["results"]) == len(QUESTIONS)
    assert got == want
    # a batch answers as the questions one by one
    (_, single) = _req(served["torch"][1], "/ask", {"question": QUESTIONS[0]})
    assert got["results"][0] == single


@pytest.mark.parametrize("path,payload,code", [
    ("/ask", {}, 400), ("/ask_batch", {"questions": "not a list"}, 400), ("/ingest", {}, 400),
    ("/nope", None, 404), ("/nope", {"x": 1}, 404),
])
def test_bad_requests_match_jax(served, path, payload, code):
    for pkg in ("jax", "torch"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(served[pkg][1], path, payload)
        assert e.value.code == code, pkg


def test_bad_json_is_400(served):
    req = urllib.request.Request(f"http://127.0.0.1:{served['torch'][1]}/ask", data=b"{not json",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400


def test_ingest_folder_and_single_file_refresh_the_resident_store(served):
    """/ingest of a folder, then of one .mp4 (idempotent on a second call):
    each package's resident engine sees the new events without a restart,
    and the answers over the grown stores still match."""
    more = os.path.join(served["tmp"], "more_videos")
    os.makedirs(more, exist_ok=True)
    _clip(os.path.join(more, "clip2.mp4"), seed=12, duration=10.0, cut=(5.0,))
    solo = os.path.join(served["tmp"], "solo.mp4")
    _clip(solo, seed=13, duration=8.0, cut=())
    for pkg in ("jax", "torch"):
        port = served[pkg][1]
        before = _req(port, "/healthz")[1]["events"]
        status, stats = _req(port, "/ingest", {"path": more})
        assert status == 200 and (stats["processed"], stats["failed"]) == (1, 0) and "engine" not in stats
        status, stats = _req(port, "/ingest", {"path": solo})
        assert status == 200 and stats["processed"] == 1 and stats["video_id"] == "solo"
        assert _req(port, "/ingest", {"path": solo})[1]["skipped"] == 1
        assert _req(port, "/healthz")[1]["events"] == before + 2
    (_, je), (_, te) = _both(served, "/events")
    assert te == je
    for q in QUESTIONS[:2]:
        (_, want), (_, got) = _both(served, "/ask", {"question": q})
        assert got == want, q


def test_reload_sees_an_external_writer(served):
    """reload=true re-reads indices and events from disk: another engine
    (the ingest CLI) extended the store; the server picks it up."""
    service, port, _ = served["torch"]
    ext = os.path.join(served["tmp"], "ext_videos")
    os.makedirs(ext, exist_ok=True)
    _clip(os.path.join(ext, "external.mp4"), seed=14, duration=8.0, cut=())
    cfg = _cfg(TConfig, service.config.storage.base_dir, served["ckpt"])
    stats = tbp.process_video_folder(ext, cfg.storage.base_dir, config=cfg, device="cpu")
    assert stats["processed"] == 1
    before = len(service.memory.long_term_store)
    status, r = _req(port, "/ask", {"question": "What is new?"})
    assert status == 200 and len(service.memory.long_term_store) == before
    status, r = _req(port, "/ask", {"question": "What is new?", "reload": True})
    assert status == 200 and r["answer"]
    assert len(service.memory.long_term_store) == before + 1
    assert "external_0" in _req(port, "/events")[1]["events"]


def test_failed_ingest_leaves_the_engine_clean(served):
    """A corrupt upload is a 500 with the error, in both packages, and
    leaves no per-video residue in the long-lived engine."""
    bad = os.path.join(served["tmp"], "corrupt.mp4")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 4096)
    for pkg in ("jax", "torch"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(served[pkg][1], "/ingest", {"path": bad})
        assert e.value.code == 500
        assert "cannot open video" in json.loads(e.value.read())["error"]
        mem = served[pkg][0].memory
        for residue in (mem._asr_futures, mem._full_audio, mem.short_term_buffer, mem.consolidated):
            assert "corrupt" not in residue, pkg
    assert _req(served["torch"][1], "/healthz")[0] == 200


def test_latency_histogram_after_concurrent_asks(served):
    """4 concurrent /ask requests serialize on the engine lock, each on its
    own handler thread; /healthz's histogram counts them."""
    port = served["torch"][1]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = [pool.submit(_req, port, "/ask", {"question": f"What happens at {i} s?"}) for i in range(4)]
        for f in futs:
            status, r = f.result(timeout=300)
            assert status == 200 and r["answer"]
    lat = _req(port, "/healthz")[1]["latency_ms"]
    assert lat["ask"]["count"] >= 4 and lat["ask"]["p50"] > 0 and lat["ask"]["p95"] >= lat["ask"]["p50"]
    assert lat["ask"]["max"] >= lat["ask"]["p95"]
    assert set(lat) >= {"ask"}


def test_qa_service_runs_on_cuda_by_default(served, monkeypatch):
    service = served["torch"][0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.QAService(service.config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--memory-store", service.config.storage.base_dir, "--port", "0"])


def test_warmup_failure_stops_startup(served, monkeypatch):
    """The port's warmup is not caught (the JAX server logs it and serves):
    a server whose first question fails does not start."""
    from hippomm_tpu_torch.retrieval import qa

    def broken(self, question):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(qa.QARecallSystem, "answer_question", broken)
    with pytest.raises(RuntimeError, match="kernel fault"):
        tserve.QAService(served["torch"][0].config, device="cpu")
    assert tserve.QAService(served["torch"][0].config, warm=False, device="cpu").memory.long_term_store


def test_a_handler_fault_is_a_500_with_the_error(served, monkeypatch):
    service, port, _ = served["torch"]

    def broken(questions):
        raise RuntimeError("top-k kernel fault")

    monkeypatch.setattr(service.qa, "answer_questions", broken)
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(port, "/ask_batch", {"questions": ["q"]})
    assert e.value.code == 500 and "top-k kernel fault" in json.loads(e.value.read())["error"]
    assert _req(port, "/healthz")[0] == 200
