"""The port's libav containers (media/io over csrc/media_libav.cpp) against
the JAX package's shim, on the CPU, on the same files: reader info and
dispatch for mp4/mkv/mov, decoded RGB and scoring luma, held blocks, index
order, audio demux (full and windowed), the ingest's container audio with
its mostly-silent skip, malformed files, and an mp4 folder through the
port's ingest CLI against the JAX CLI's store.

Each test needs the port's libav shim; it skips, saying so, only on a host
where the shim did not build or load."""

import dataclasses
import json
import os

import numpy as np
import pytest
import yaml

from hippomm_tpu.core import batch_process as jbp
from hippomm_tpu.media import io as jio
from hippomm_tpu.media import synth as jsynth
from hippomm_tpu_torch.core import batch_process as tbp
from hippomm_tpu_torch.media import io as tio
from hippomm_tpu_torch.media import synth as tsynth
from hippomm_tpu_torch.ops import _native
from torch_parity import assert_close

SPEC = dict(duration=12.0, fps=10.0, width=160, height=120, scene_changes=(6.0,),
            silence_regions=((3.0, 4.0),), seed=7)


@pytest.fixture(scope="module", autouse=True)
def libav():
    if _native.media_libav_lib() is None:
        pytest.skip("the port's libav shim did not build or load on this host "
                    "(no libavformat/libavcodec/libavutil/libswscale/libswresample headers or libraries)")


@pytest.fixture(scope="module")
def clips(tmp_path_factory, libav):
    """One 12 s clip (scene cut at 6 s, silence 3-4 s) in every container,
    written by the port's writer (byte-equal to the JAX writer's)."""
    root = tmp_path_factory.mktemp("torch_libav")
    res = tsynth.generate(tsynth.SynthSpec(**SPEC))
    paths = {}
    for ext in ("mp4", "mkv", "mov"):
        paths[ext] = str(root / f"clip.{ext}")
        tio.write_video_av(paths[ext], res.frames, fps=10.0, audio=res.audio, sample_rate=16000)
    return res, paths


def test_writers_are_byte_equal(tmp_path):
    res = tsynth.generate(tsynth.SynthSpec(duration=3.0, fps=5.0, width=64, height=48, seed=1))
    for ext in ("mp4", "mkv"):
        tio.write_video_av(str(tmp_path / f"t.{ext}"), res.frames, fps=5.0, audio=res.audio)
        jio.write_video_av(str(tmp_path / f"j.{ext}"), res.frames, fps=5.0, audio=res.audio)
        if ext == "mp4":
            assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
        else:  # matroska writes a random segment UID: the streams must agree
            t, j = tio.open_video(str(tmp_path / "t.mkv")), jio.open_video(str(tmp_path / "j.mkv"))
            np.testing.assert_array_equal(t.read_rgb(range(15)), j.read_rgb(range(15)))
            np.testing.assert_array_equal(tio.demux_audio(str(tmp_path / "t.mkv")),
                                          jio.demux_audio(str(tmp_path / "j.mkv")))
            t.close()
            j.close()
    spec = dict(duration=4.0, fps=4.0, width=64, height=48, scene_changes=(2.0,), seed=3)
    for name in ("s.mp4", "s.mov", "s.avi"):
        codec = "mpeg4" if name.endswith(".avi") else ""
        assert tsynth.write_synthetic_video(str(tmp_path / f"t{name}"), tsynth.SynthSpec(**spec),
                                            codec=codec) is None
        jsynth.write_synthetic_video(str(tmp_path / f"j{name}"), jsynth.SynthSpec(**spec), codec=codec)
        assert (tmp_path / f"t{name}").read_bytes() == (tmp_path / f"j{name}").read_bytes()
    with pytest.raises(ValueError, match="unsupported container"):
        tsynth.write_synthetic_video(str(tmp_path / "t.webm"), tsynth.SynthSpec(**spec))


@pytest.mark.parametrize("ext", ["mp4", "mkv", "mov"])
def test_info_and_dispatch(clips, ext):
    _, paths = clips
    r, j = tio.open_video(paths[ext]), jio.open_video(paths[ext])
    assert isinstance(r, tio.LibavReader)
    assert dataclasses.astuple(r.info) == dataclasses.astuple(j.info)
    assert r.info.width == 160 and r.info.height == 120 and r.info.has_audio
    assert abs(r.info.fps - 10.0) < 0.5 and abs(r.info.duration - 12.0) < 0.5
    assert dataclasses.astuple(tio.probe_video(paths[ext])) == dataclasses.astuple(jio.probe_video(paths[ext]))
    r.close()
    j.close()


def test_non_mjpeg_avi_goes_through_libav(tmp_path, clips):
    res, _ = clips
    p = str(tmp_path / "m4.avi")
    tio.write_video_av(p, res.frames[:20], fps=10.0, codec="mpeg4")
    r = tio.open_video(p)
    assert isinstance(r, tio.LibavReader)
    np.testing.assert_array_equal(r.read_rgb([0, 7, 19]), jio.open_video(p).read_rgb([0, 7, 19]))
    r.close()


@pytest.mark.parametrize("ext", ["mp4", "mkv", "mov"])
def test_decoded_rgb_and_gray_equal_jax(clips, ext):
    res, paths = clips
    r, j = tio.LibavReader(paths[ext]), jio.LibavReader(paths[ext])
    idx = [0, 30, 59, 61, 119]
    rgb = r.read_rgb(idx)
    np.testing.assert_array_equal(rgb, j.read_rgb(idx))
    np.testing.assert_array_equal(r.read_gray_small(idx, 30, 40), j.read_gray_small(idx, 30, 40))
    for k, i in enumerate(idx):  # the decode is the source, up to the codec
        mse = np.mean((rgb[k].astype(np.float32) - res.frames[i].astype(np.float32)) ** 2)
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)) > 28.0
    r.close()
    j.close()


@pytest.mark.parametrize("skip_nonref", [False, True])
def test_held_block_equals_jax(clips, skip_nonref):
    _, paths = clips
    r, j = tio.LibavReader(paths["mp4"]), jio.LibavReader(paths["mp4"])
    cand = list(range(0, 120, 10))
    a = r.read_block(cand, 30, 40, skip_nonref=skip_nonref)
    b = j.read_block(cand, 30, 40, skip_nonref=skip_nonref)
    np.testing.assert_array_equal(a.gray, b.gray)
    np.testing.assert_array_equal(a.take_rgb([0, 5, 11]), b.take_rgb([0, 5, 11]))
    a.close()
    b.close()
    r.close()
    j.close()


def test_unsorted_duplicate_and_backward_reads(clips):
    _, paths = clips
    r = tio.LibavReader(paths["mp4"])
    a = r.read_rgb([50, 10, 50, 90])
    np.testing.assert_array_equal(a, jio.LibavReader(paths["mp4"]).read_rgb([50, 10, 50, 90]))
    assert np.array_equal(a[1], r.read_rgb([10])[0]) and np.array_equal(a[0], a[2])
    late = r.read_rgb([100])[0]
    early = r.read_rgb([5])[0]  # backward after a forward read
    assert np.array_equal(early, tio.LibavReader(paths["mp4"]).read_rgb([5])[0])
    assert not np.array_equal(late, early)
    # a sparse spread set splits across reader threads: equal to one reader
    idx = list(range(0, 120, 13))
    np.testing.assert_array_equal(r.read_rgb(idx), r.read_rgb(idx, _parallel=False))
    r.close()


@pytest.mark.parametrize("ext", ["mp4", "mkv"])
def test_demux_audio_equals_jax(clips, ext):
    _, paths = clips
    pcm = tio.demux_audio(paths[ext])
    np.testing.assert_array_equal(pcm, jio.demux_audio(paths[ext]))
    assert pcm.dtype == np.float32 and abs(len(pcm) / 16000.0 - 12.0) < 0.2
    assert np.sqrt((pcm[int(3.2 * 16000): int(3.8 * 16000)] ** 2).mean()) < 0.02  # the silence
    win = tio.demux_audio(paths[ext], 5.0, 7.0)
    np.testing.assert_array_equal(win, jio.demux_audio(paths[ext], 5.0, 7.0))
    assert abs(len(win) / 16000.0 - 2.0) < 0.15


def test_demux_audio_of_a_video_only_container_is_none(tmp_path):
    res = tsynth.generate(tsynth.SynthSpec(duration=2.0, fps=5.0, width=64, height=48))
    p = str(tmp_path / "mute.mp4")
    tio.write_video_av(p, res.frames, fps=5.0)
    assert tio.demux_audio(p) is None and jio.demux_audio(p) is None


def test_extract_audio_from_container_equals_jax(request, clips, tmp_path):
    """No sibling wav: the track comes from the container itself."""
    _, paths = clips
    got = tbp.extract_audio_from_video(paths["mp4"], str(tmp_path / "t"))
    want = jbp.extract_audio_from_video(paths["mp4"], str(tmp_path / "j"))
    assert got["has_audio"] and want["has_audio"]
    assert_close(request, got["audio"], want["audio"], 1e-6, "container_audio")
    assert (got["duration"], got["skipped_as_silent"]) == (want["duration"], want["skipped_as_silent"])
    np.testing.assert_allclose(got["silence_regions"], want["silence_regions"], atol=1e-6)
    assert got["silence_fraction"] == pytest.approx(want["silence_fraction"], abs=1e-6)
    assert any(abs(s - 3.0) < 0.5 for s, e in got["silence_regions"])
    again = tbp.extract_audio_from_video(paths["mp4"], str(tmp_path / "t"))
    assert again["resumed"] and np.array_equal(again["audio"], got["audio"])


def test_extract_audio_skips_a_mostly_silent_track(tmp_path):
    res = tsynth.generate(tsynth.SynthSpec(duration=10.0, fps=2.0, width=64, height=48, seed=9))
    pcm = np.zeros_like(res.audio)
    pcm[: len(pcm) // 25] = res.audio[: len(pcm) // 25]  # ~4 % not silent
    path = str(tmp_path / "quiet.mp4")
    tio.write_video_av(path, res.frames, fps=2.0, audio=pcm)
    got = tbp.extract_audio_from_video(path, str(tmp_path / "t"))
    want = jbp.extract_audio_from_video(path, str(tmp_path / "j"))
    assert got["skipped_as_silent"] and not got["has_audio"] and got["audio"] is None
    assert got["silence_fraction"] == pytest.approx(want["silence_fraction"], abs=1e-6) and got["silence_fraction"] > 0.9
    assert not os.path.exists(tmp_path / "t" / "audio" / "quiet" / "audio.npy")
    assert tbp.extract_audio_from_video(path, str(tmp_path / "t"))["resumed"]


def _outcome(io_mod, path):
    """What opening, reading and demuxing a file raises, by type (None: it
    went through); the JAX robustness suite's walk."""
    out = []
    try:
        r = io_mod.open_video(path)
    except Exception as e:  # noqa: BLE001 — the type is the result
        return [type(e)]
    for call in (lambda: r.read_gray_small([0, 1, 2, 3], 30, 40), lambda: r.read_rgb([0])):
        try:
            call()
            out.append(None)
        except Exception as e:  # noqa: BLE001
            out.append(type(e))
    r.close()
    try:
        io_mod.demux_audio(path)
        out.append(None)
    except Exception as e:  # noqa: BLE001
        out.append(type(e))
    return out


@pytest.fixture(scope="module")
def good_mp4(tmp_path_factory, libav):
    p = str(tmp_path_factory.mktemp("robust") / "good.mp4")
    tsynth.write_synthetic_video(p, tsynth.SynthSpec(duration=8.0, fps=4.0, width=160, height=120,
                                                     scene_changes=(4.0,), seed=3))
    return p


@pytest.mark.parametrize("fault", ["empty", "garbage", "trunc10", "trunc50", "trunc90", "trunc99",
                                   "bitflip", "headflip"])
def test_malformed_files_raise_what_jax_raises(good_mp4, tmp_path, fault):
    data = bytearray(open(good_mp4, "rb").read())
    rng = np.random.default_rng(0)
    if fault == "empty":
        data = b""
    elif fault == "garbage":
        data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    elif fault.startswith("trunc"):
        data = bytes(data[: int(len(data) * int(fault[5:]) / 100)])
    elif fault == "bitflip":
        for pos in rng.integers(1024, len(data), size=200):
            data[int(pos)] ^= 0xFF
    else:
        for pos in rng.integers(4, min(2048, len(data)), size=64):
            data[int(pos)] ^= 0x55
    p = str(tmp_path / f"{fault}.mp4")
    with open(p, "wb") as f:
        f.write(bytes(data))
    assert _outcome(tio, p) == _outcome(jio, p)


def test_without_the_shim_libav_raises_naming_it(tmp_path, clips, monkeypatch):
    _, paths = clips
    monkeypatch.setattr(_native, "media_libav_lib", lambda: None)
    assert not tio.libav_available()
    for call in (lambda: tio.open_video(paths["mp4"]), lambda: tio.demux_audio(paths["mp4"]),
                 lambda: tio.write_video_av(str(tmp_path / "x.mp4"), np.zeros((1, 16, 16, 3), np.uint8)),
                 lambda: tbp.extract_audio_from_video(paths["mkv"], str(tmp_path / "store"))):
        with pytest.raises(RuntimeError, match="libav shim"):
            call()


def test_mp4_folder_through_the_cli_matches_jax(request, tmp_path):
    """A folder of .mp4 clips with embedded audio through both packages'
    ingest CLI, both loading one tiny ImageBind checkpoint: the same stats,
    key frames and audio, ThetaEvent features within 1e-5 (fp32 on the
    CPU)."""
    import torch

    from hippomm_tpu_torch.models.imagebind.manifest import random_state_dict
    from hippomm_tpu_torch.models.imagebind.model import tiny_config

    ckpt = str(tmp_path / "imagebind_tiny.pth")
    torch.save({k: torch.from_numpy(v) for k, v in random_state_dict(tiny_config(), seed=4).items()}, ckpt)
    videos = tmp_path / "videos"
    videos.mkdir()
    for name, seed, cut in (("a", 3, (9.0,)), ("b", 4, (5.0,))):
        tsynth.write_synthetic_video(str(videos / f"{name}.mp4"), tsynth.SynthSpec(
            duration=14.0, fps=5.0, width=160, height=120, scene_changes=cut,
            silence_regions=((8.5, 9.5),), seed=seed))
    cfg = tmp_path / "config.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump({"api": {"mode": "stub"}, "models": {
            "imagebind_variant": "tiny", "imagebind_path": ckpt, "whisper_variant": "stub",
            "compute_dtype": "float32"}}, f)
    stores = {"jax": str(tmp_path / "jax"), "torch": str(tmp_path / "torch")}
    # the JAX engine builds ImageBind in bf16 whatever the config says: give
    # its CLI function an fp32 engine over the same checkpoint
    import jax.numpy as jnp

    from hippomm_tpu.config import load_config as jload_config
    from hippomm_tpu.memory.engine import HippocampalMemory as JMemory
    from hippomm_tpu.models.foundation import ImageBind as JImageBind

    jcfg = jload_config(str(cfg))
    jcfg.storage.base_dir = stores["jax"]
    jmem = JMemory(jcfg, models={"imagebind": JImageBind(model_path=ckpt, variant="tiny", dtype=jnp.float32)})
    jstats = jbp.process_video_folder(str(videos), stores["jax"], config=jcfg, memory_system=jmem)
    tstats = tbp.main(["--path", str(videos), "--memory_store", stores["torch"], "--config", str(cfg)],
                      device="cpu")
    for stats in (jstats, tstats):
        assert (stats["processed"], stats["failed"]) == (2, 0), stats
    for vid in ("a", "b"):
        with open(os.path.join(stores["torch"], "frames", vid, "metadata.yaml")) as f:
            tmeta = yaml.safe_load(f)
        with open(os.path.join(stores["jax"], "frames", vid, "metadata.yaml")) as f:
            jmeta = yaml.safe_load(f)
        assert tmeta["frame_times"] == jmeta["frame_times"]
        assert_close(request, np.load(os.path.join(stores["torch"], "audio", vid, "audio.npy")),
                     np.load(os.path.join(stores["jax"], "audio", vid, "audio.npy")), 1e-6, f"audio_{vid}")
        evs = {}
        for name in stores:
            (fn,) = os.listdir(os.path.join(stores[name], "events", vid))
            with open(os.path.join(stores[name], "events", vid, fn)) as f:
                evs[name] = json.load(f)
        for mod in ("vision", "audio"):
            assert_close(request, evs["torch"]["features"][mod], evs["jax"]["features"][mod], 1e-5,
                         f"{mod}_{vid}")
        assert evs["torch"]["frame_times"] == evs["jax"]["frame_times"]
        assert evs["torch"]["summary"] == evs["jax"]["summary"]
