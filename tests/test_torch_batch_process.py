"""The port's ingest CLI (core/batch_process) against the JAX package's.

One folder — a .y4m and an MJPEG .avi, each with a sibling .wav, a
standalone .wav (audio-only ingest) and a corrupt .y4m — through both
packages' `process_video_folder`, with engines carrying the same tiny fp32
ImageBind and Whisper weights and stub clients. The stores must agree:
stats, indices, the frame tree and its metadata.yaml, audio.npy and the
ThetaEvents (wall-clock fields aside). Then the port alone: a second run
skips everything, single-file `main(..., device="cpu")`, the queue consumer,
the chunked streaming path and both vision-stream routes."""

import glob
import json
import os
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hippomm_tpu.config import Config as JConfig
from hippomm_tpu.core import batch_process as jbp
from hippomm_tpu.media.synth import SynthSpec as JSynthSpec
from hippomm_tpu.media.synth import write_synthetic_video as jwrite_synthetic_video
from hippomm_tpu.memory.engine import HippocampalMemory as JMemory
from hippomm_tpu.models.foundation import ImageBind as JImageBind
from hippomm_tpu.models.foundation import Whisper as JWhisper
from hippomm_tpu_torch.config import Config as TConfig
from hippomm_tpu_torch.core import batch_process as tbp
from hippomm_tpu_torch.media.synth import SynthSpec, write_synthetic_video
from hippomm_tpu_torch.memory.engine import HippocampalMemory as TMemory
from hippomm_tpu_torch.models.foundation import ImageBind as TImageBind
from hippomm_tpu_torch.models.foundation import VisionEncodeStream
from hippomm_tpu_torch.models.foundation import Whisper as TWhisper
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
from hippomm_tpu_torch.models.whisper.carry import params_from_jax as whisper_from_jax
from torch_parity import assert_close

_CLIPS = {  # name: (container, SynthSpec kwargs)
    "a": ("y4m", dict(duration=12.0, fps=4.0, width=160, height=120, scene_changes=(6.0,),
                      silence_regions=((5.5, 6.5),), seed=3)),
    "b": ("avi", dict(duration=8.0, fps=2.0, width=160, height=120, scene_changes=(4.0,), seed=4)),
}


class IdTokenizer:
    """Decodes ids to their decimal text, so transcripts are comparable text."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _config(cls, base_dir):
    cfg = cls()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = "tiny"
    cfg.models.whisper_variant = "tiny"
    cfg.storage.base_dir = str(base_dir)
    return cfg


@pytest.fixture(scope="module")
def towers():
    """Tiny fp32 ImageBind and Whisper of both packages, same weights."""
    jib = JImageBind(variant="tiny", dtype=jnp.float32, seed=0)
    tib = TImageBind(variant="tiny", dtype=torch.float32, device="cpu",
                     params=params_from_jax(jax.tree.map(np.asarray, jib.params), jib.cfg, "cpu",
                                            torch.float32))
    jwh = JWhisper(variant="tiny", dtype=jnp.float32, seed=0, beam_size=1)
    twh = TWhisper(variant="tiny", dtype=torch.float32, beam_size=1, device="cpu",
                   params=whisper_from_jax(jax.tree.map(np.asarray, jwh._impl.params), jwh.cfg,
                                           "cpu", torch.float32))
    for w in (jwh, twh):
        w._impl.tokenizer = IdTokenizer()
    return {"jax": (jib, jwh), "torch": (tib, twh)}


def _engine(pkg, towers, store):
    ib, wh = towers[pkg]
    if pkg == "jax":
        return JMemory(_config(JConfig, store), models={"imagebind": ib, "whisper": wh})
    return TMemory(_config(TConfig, store), device="cpu", models={"imagebind": ib, "whisper": wh})


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    for name, (ext, spec) in _CLIPS.items():
        write_synthetic_video(str(d / f"{name}.{ext}"), SynthSpec(**spec), audio_path=str(d / f"{name}.wav"))
    # the JAX package writes the same files
    jd = tmp_path_factory.mktemp("jax_videos")
    for name, (ext, spec) in _CLIPS.items():
        jwrite_synthetic_video(str(jd / f"{name}.{ext}"), JSynthSpec(**spec), audio_path=str(jd / f"{name}.wav"))
        assert (jd / f"{name}.{ext}").read_bytes() == (d / f"{name}.{ext}").read_bytes()
    t = np.arange(int(6.0 * 16000)) / 16000.0
    speech = (0.25 * np.sin(2 * np.pi * 330 * t) * (1 + np.sin(2 * np.pi * 0.5 * t))).astype(np.float32)
    speech[int(2.0 * 16000):int(2.6 * 16000)] = 0.0
    from hippomm_tpu_torch.media.io import write_wav

    write_wav(str(d / "c.wav"), speech)
    (d / "d.y4m").write_bytes(b"not a video at all\n" * 8)
    return str(d)


@pytest.fixture(scope="module")
def ingested(folder, towers, tmp_path_factory):
    out = {}
    for pkg, bp in (("jax", jbp), ("torch", tbp)):
        store = str(tmp_path_factory.mktemp(f"{pkg}_store"))
        mem = _engine(pkg, towers, store)
        stats = bp.process_video_folder(folder, store, config=mem.config, memory_system=mem)
        out[pkg] = (store, mem, stats)
    return out


def _rel(obj, store):
    """`obj` with the store's path prefix removed from every string in it."""
    if isinstance(obj, str):
        return obj.replace(store + os.sep, "")
    if isinstance(obj, list):
        return [_rel(x, store) for x in obj]
    if isinstance(obj, dict):
        return {k: _rel(v, store) for k, v in obj.items()}
    return obj


def test_folder_stats_agree(ingested):
    js, ts = ingested["jax"][2], ingested["torch"][2]
    for k in ("total", "processed", "skipped", "failed", "media_seconds"):
        assert ts[k] == js[k], k
    assert (ts["total"], ts["processed"], ts["failed"]) == (4, 3, 1)
    assert sorted(ts["errors"]) == sorted(js["errors"]) == ["d"]
    assert "not a y4m file" in ts["errors"]["d"]
    assert ts["realtime_multiple"] > 0 and ts["wall_seconds"] > 0


def test_indices_agree(ingested):
    (jstore, _, _), (tstore, _, _) = ingested["jax"], ingested["torch"]
    for name in ("video_index.json", "event_index.json"):
        with open(os.path.join(jstore, name)) as f:
            want = _rel(json.load(f), jstore)
        with open(os.path.join(tstore, name)) as f:
            got = _rel(json.load(f), tstore)
        assert got == want, name
    assert sorted(got) == ["a_0", "b_0", "c_0"]


def test_frame_tree_and_metadata_agree(request, ingested):
    (jstore, _, _), (tstore, _, _) = ingested["jax"], ingested["torch"]

    def tree(store):
        return sorted(os.path.relpath(p, store) for p in glob.glob(os.path.join(store, "frames", "**", "*"),
                                                                   recursive=True))

    assert tree(tstore) == tree(jstore)
    for vid in ("a", "b"):
        metas = []
        for store in (jstore, tstore):
            with open(os.path.join(store, "frames", vid, "metadata.yaml")) as f:
                metas.append(_rel(yaml.safe_load(f), store))
        want, got = metas
        ssim_w, ssim_g = want.pop("frame_ssim"), got.pop("frame_ssim")
        assert got == want
        assert len(got["frame_times"]) >= 2
        assert_close(request, ssim_g, ssim_w, 1e-5, f"frame_ssim_{vid}")
        for p in got["frame_paths"]:  # the same JPEG bytes (one libjpeg)
            with open(os.path.join(jstore, p), "rb") as f, open(os.path.join(tstore, p), "rb") as g:
                assert f.read() == g.read()


def test_audio_tracks_agree(ingested):
    (jstore, _, _), (tstore, _, _) = ingested["jax"], ingested["torch"]
    for vid in ("a", "b", "c"):
        want = np.load(os.path.join(jstore, "audio", vid, "audio.npy"))
        got = np.load(os.path.join(tstore, "audio", vid, "audio.npy"))
        np.testing.assert_array_equal(got, want)
        with open(os.path.join(jstore, "audio", vid, "metadata.yaml")) as f:
            jm = yaml.safe_load(f)
        with open(os.path.join(tstore, "audio", vid, "metadata.yaml")) as f:
            assert yaml.safe_load(f) == jm


def test_theta_events_agree(request, ingested):
    (jstore, jmem, _), (tstore, tmem, _) = ingested["jax"], ingested["torch"]
    jev = {e.video_id: e for e in jmem.store.load_all_events()}
    tev = {e.video_id: e for e in tmem.store.load_all_events()}
    assert sorted(tev) == sorted(jev) == ["a", "b", "c"]
    for vid, je in jev.items():
        te = tev[vid]
        jd, td = _rel(je.to_dict(), jstore), _rel(te.to_dict(), tstore)
        jf, tf = jd.pop("features"), td.pop("features")
        assert td == jd, vid  # times, frames, captions, transcripts, summary
        assert sorted(tf) == sorted(jf)
        for k, norm in (("vision", 1.0), ("audio", 20.0)):
            if k in jf:
                assert_close(request, tf[k], jf[k], 1e-5, f"max_abs_err_{vid}_{k}", scale=norm)
    assert tev["c"].modalities == ["audio"] and not tev["c"].frames
    assert tev["a"].holistic_audio_transcription  # the tiny Whisper's text reached the event


def test_second_run_skips_everything(ingested, folder):
    tstore, tmem, _ = ingested["torch"]
    stats = tbp.process_video_folder(folder, tstore, config=tmem.config, memory_system=tmem)
    assert (stats["skipped"], stats["processed"], stats["failed"]) == (3, 0, 1)


def test_main_single_file_and_no_skip_existing(tmp_path):
    """The CLI on one file, building its own engine on the CPU; then
    --no-skip-existing reprocesses it; a third call skips it."""
    write_synthetic_video(str(tmp_path / "one.y4m"), SynthSpec(duration=6.0, fps=2.0, width=96, height=64),
                          audio_path=str(tmp_path / "one.wav"))
    (tmp_path / "cfg.yaml").write_text(
        'api: {mode: "stub"}\nmodels: {imagebind_variant: "tiny", whisper_variant: "stub", '
        'compute_dtype: "float32"}\n')
    argv = ["--path", str(tmp_path / "one.y4m"), "--memory_store", str(tmp_path / "store"),
            "--config", str(tmp_path / "cfg.yaml")]
    first = tbp.main(argv, device="cpu")
    assert (first["processed"], first["video_id"]) == (1, "one")
    again = tbp.main(argv + ["--no-skip-existing"], device="cpu")
    assert again["processed"] == 1 and again["skipped"] == 0
    assert tbp.main(argv, device="cpu")["skipped"] == 1
    assert os.path.exists(str(tmp_path / "store" / "audio" / "one" / "audio.npy"))


def test_process_memory_sync_matches_jax(request, ingested, towers, tmp_path):
    """The queue consumer over the stored key frames of video "a": frames in
    micro-batches, then complete → one ThetaEvent, equal to the JAX one."""
    tstore = ingested["torch"][0]
    with open(os.path.join(tstore, "frames", "a", "metadata.yaml")) as f:
        meta = yaml.safe_load(f)
    events = {}
    for pkg, bp in (("jax", jbp), ("torch", tbp)):
        mem = _engine(pkg, towers, tmp_path / pkg)
        mem.frame_buffer_size = 2
        q = queue.Queue()
        for p, t in zip(meta["frame_paths"], meta["frame_times"]):
            q.put({"type": "frame", "video_id": "live", "path": p, "time": t})
        q.put({"type": "error", "video_id": "other", "message": "dropped"})
        q.put({"type": "complete", "video_id": "live"})
        q.put({"type": "stop"})
        stats = bp.process_memory_sync(mem, q)
        assert stats == {"frames": len(meta["frame_paths"]), "completed": ["live"],
                         "errors": {"other": "dropped"}}
        events[pkg] = mem.long_term_store[-1]
    assert events["torch"].frame_times == events["jax"].frame_times
    assert_close(request, events["torch"].features["vision"], events["jax"].features["vision"], 1e-5)
    assert os.path.exists(tmp_path / "torch" / "checkpoints" / "stream.json")


def test_streaming_path_selects_the_whole_video_keyframes(towers, tmp_path):
    """process_single_video_streaming in 60 s chunks over a 140 s clip (140
    candidates, scan blocks of 64, so three chunks): the same key frames as
    the whole-video pass, one event, and its vision rows for every key frame
    that survives consolidation."""
    clip = str(tmp_path / "long.y4m")
    write_synthetic_video(clip, SynthSpec(duration=140.0, fps=1.0, width=64, height=48,
                                          scene_changes=(30.0, 70.0, 100.0), seed=9),
                          audio_path=str(tmp_path / "long.wav"))
    whole = tbp.extract_frames_from_video(clip, str(tmp_path / "whole"), device="cpu")
    cfg = _config(TConfig, tmp_path / "s")
    cfg.models.whisper_variant = "stub"
    mem = TMemory(cfg, device="cpu", models={"imagebind": towers["torch"][0]})
    res = tbp.process_single_video_streaming(clip, str(tmp_path / "s"), video_id="long_streamed",
                                             memory_system=mem, chunk_seconds=60.0)
    assert res["streamed"] and res["frames"]["streamed_chunks"] == 3
    assert res["frames"]["frame_times"] == whole["frame_times"]
    assert len(whole["frame_times"]) >= 4
    (ev,) = mem.store.load_all_events()
    assert ev.video_id == "long_streamed" and ev.end_time == pytest.approx(140.0, abs=1.0)
    assert ev.features["vision"].shape[0] == len(ev.frames) >= 1


@pytest.mark.parametrize("route", ["encode_all_candidates", "keyframe_feed"])
def test_vision_stream_routes_match_direct_encode(request, folder, towers, tmp_path, monkeypatch, route):
    """Both routes of the extraction's vision stream: every candidate encoded
    (≤ HIPPOMM_ENCODE_ALL_MAX candidates, rows indexed down to the key
    frames) or the key frames fed as their masks are read."""
    if route == "keyframe_feed":
        monkeypatch.setenv("HIPPOMM_ENCODE_ALL_MAX", "4")  # 12 candidates > 4
    ib = towers["torch"][0]
    meta = tbp.extract_frames_from_video(os.path.join(folder, "a.y4m"), str(tmp_path), video_id="a",
                                         vision_stream=ib.vision_stream(), device="cpu")
    stream = meta["vision_stream"]
    is_feed = type(stream) is VisionEncodeStream
    assert is_feed == (route == "keyframe_feed")
    frames = meta["frames_rgb"]
    assert frames is not None and len(frames) >= 2
    assert (stream.frames_fed if is_feed else stream._stream.frames_fed) == (len(frames) if is_feed else 12)
    assert_close(request, stream.result(), ib.encode_vision(frames), 1e-5)


def test_engine_reencodes_a_mismatched_stream(towers, tmp_path):
    """A stream whose rows disagree with frames_rgb is discarded and the
    frames re-encoded, as the JAX engine does."""
    mem = _engine("torch", towers, tmp_path)
    frames = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    bad = mem.imagebind.vision_stream()
    bad.feed(frames[:2])
    stms = mem.process_sequence("v", frame_paths=[f"f{i}.jpg" for i in range(4)],
                                frame_times=[0.0, 1.0, 2.0, 3.0], frames_rgb=frames, video_duration=4.0,
                                auto_consolidate=False, vision_stream=bad)
    got = np.concatenate([s.features["vision"] for s in stms])
    np.testing.assert_array_equal(got, mem.imagebind.encode_vision(frames)[: len(got)])


def test_engine_decodes_frame_paths(towers, tmp_path):
    """frames_rgb None: the engine reads the key-frame JPEGs themselves."""
    from hippomm_tpu_torch.media.io import write_jpeg

    mem = _engine("torch", towers, tmp_path)
    frames = np.random.default_rng(1).integers(0, 256, (3, 40, 40, 3)).astype(np.uint8)
    paths = []
    for i, fr in enumerate(frames):
        paths.append(str(tmp_path / f"f{i}.jpg"))
        write_jpeg(paths[-1], fr)
    stms = mem.process_sequence("v", frame_paths=paths, frame_times=[0.0, 1.0, 2.0], video_duration=3.0,
                                auto_consolidate=False)
    got = np.concatenate([s.features["vision"] for s in stms])
    np.testing.assert_array_equal(got, mem.imagebind.encode_vision(paths))


def test_launch_counter_holds_every_count_across_threads():
    """The ingest launches kernels from several threads (the vision stream's
    worker beside the engine): `_native.count_launch` loses no count under
    16 threads and a short switch interval."""
    import sys
    import threading

    from hippomm_tpu_torch.ops import _native

    def fn():
        pass

    fn.launches = 0
    per_thread, n_threads = 20_000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_native.count_launch(fn) for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == per_thread * n_threads
