"""The port's host media readers and writers (media/io over
csrc/media_jpeg.cpp, media/synth.write_synthetic_video) against the JAX
package's: WAV at every bit depth, Y4M and MJPEG-AVI both ways, the JPEG
codec, and the files neither package reads. The libav containers have
their own file, test_torch_libav.py."""

import struct

import numpy as np
import pytest

from hippomm_tpu.media import io as jio
from hippomm_tpu.media import synth as jsynth
from hippomm_tpu_torch.media import io as tio
from hippomm_tpu_torch.media import synth as tsynth
from hippomm_tpu_torch.ops import _native


def _write_wav_raw(path, data: bytes, fmt: int, channels: int, rate: int, bits: int,
                   extensible: bool = False):
    """A WAV of raw sample bytes; `extensible` writes a WAVE_FORMAT_EXTENSIBLE
    header whose SubFormat GUID carries `fmt`."""
    block = channels * bits // 8
    if extensible:
        fmt_chunk = struct.pack("<HHIIHH", 0xFFFE, channels, rate, rate * block, block, bits)
        guid_tail = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt_chunk += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt) + guid_tail
    else:
        fmt_chunk = struct.pack("<HHIIHH", fmt, channels, rate, rate * block, block, bits)
    with open(path, "wb") as f:
        body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
        body += b"data" + struct.pack("<I", len(data)) + data
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _samples(bits: int, fmt: int, n: int, channels: int, rng) -> bytes:
    x = rng.uniform(-0.9, 0.9, (n, channels))
    if fmt == 3:
        return x.astype("<f4").tobytes()
    if bits == 16:
        return (x * 32767).astype("<i2").tobytes()
    if bits == 32:
        return (x * 2147483647).astype("<i4").tobytes()
    ints = (x * 8388607).astype(np.int32).reshape(-1)  # 24-bit little endian
    return np.stack([ints & 0xFF, (ints >> 8) & 0xFF, (ints >> 16) & 0xFF], 1).astype(np.uint8).tobytes()


@pytest.mark.parametrize("bits,fmt,extensible", [
    (16, 1, False), (24, 1, False), (32, 1, False), (32, 3, False), (32, 3, True), (24, 1, True),
])
def test_read_wav_matches_jax(tmp_path, bits, fmt, extensible):
    rng = np.random.default_rng(bits + fmt)
    p = str(tmp_path / "a.wav")
    _write_wav_raw(p, _samples(bits, fmt, 1000, 2, rng), fmt, 2, 22050, bits, extensible)
    got, rate = tio.read_wav(p)
    want, jrate = jio.read_wav(p)
    assert rate == jrate == 22050 and got.shape == want.shape == (1000, 2)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 0.5


def test_write_wav_round_trips_and_matches_jax(tmp_path):
    pcm = np.random.default_rng(0).uniform(-1, 1, (4000, 2)).astype(np.float32)
    tio.write_wav(str(tmp_path / "t.wav"), pcm, 16000)
    jio.write_wav(str(tmp_path / "j.wav"), pcm, 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, rate = tio.read_wav(str(tmp_path / "t.wav"))
    # written as round(x·32767), read as /32768: half a step plus 1/32768 of |x|
    assert rate == 16000 and np.abs(got - pcm).max() <= 0.5 / 32767 + 1.0 / 32768


def test_load_audio_mono16k_matches_jax(request, tmp_path):
    """A 44.1 kHz stereo file: downmix, low-pass, resample."""
    from torch_parity import assert_close

    rng = np.random.default_rng(3)
    t = np.arange(44100) / 44100.0
    left = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(len(t))
    stereo = np.stack([left, 0.3 * np.sin(2 * np.pi * 9000 * t)], 1)
    p = str(tmp_path / "hi.wav")
    jio.write_wav(p, stereo, 44100)
    got, want = tio.load_audio_mono16k(p), jio.load_audio_mono16k(p)
    assert got.dtype == np.float32 and got.shape == want.shape == (16000,)
    assert_close(request, got, want, 1e-6)


def test_y4m_written_by_each_package_is_byte_equal(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (5, 48, 64, 3), dtype=np.uint8)
    tio.write_y4m(str(tmp_path / "t.y4m"), frames, fps=7.5)
    jio.write_y4m(str(tmp_path / "j.y4m"), frames, fps=7.5)
    assert (tmp_path / "t.y4m").read_bytes() == (tmp_path / "j.y4m").read_bytes()
    for write, read in ((tmp_path / "t.y4m", jio.Y4MReader), (tmp_path / "j.y4m", tio.Y4MReader)):
        r = read(str(write))
        other = (tio if read is jio.Y4MReader else jio).Y4MReader(str(write))
        assert r.info.num_frames == other.info.num_frames == 5 and r.info.fps == 7.5
        np.testing.assert_array_equal(r.read_rgb([4, 0, 2]), other.read_rgb([4, 0, 2]))
        np.testing.assert_array_equal(r.read_gray_small([1, 3], 24, 32), other.read_gray_small([1, 3], 24, 32))
    r = tio.Y4MReader(str(tmp_path / "t.y4m"))
    blk = r.read_block([0, 2, 4], 24, 32)
    np.testing.assert_array_equal(blk.take_rgb([2]), r.read_rgb([4]))
    # a flat colour survives full-range BT.601 4:2:0 within a level or two
    flat = np.broadcast_to(np.array([200, 40, 90], np.uint8), (1, 48, 64, 3))
    tio.write_y4m(str(tmp_path / "flat.y4m"), flat)
    assert np.abs(tio.Y4MReader(str(tmp_path / "flat.y4m")).read_rgb([0]).astype(int) - flat).max() <= 2


def test_jpeg_codec_matches_jax_shim():
    assert tio.native_available() and jio.native_available()
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    data = tio.jpeg_encode(img, 85)
    assert data == jio.jpeg_encode(img, 85)
    np.testing.assert_array_equal(tio.jpeg_decode(data), jio.jpeg_decode(data))


def test_mjpeg_avi_both_ways(tmp_path):
    rng = np.random.default_rng(4)
    frames = np.repeat(rng.integers(0, 256, (4, 1, 1, 3), dtype=np.uint8), 32, 1).repeat(48, 2)
    frames = np.clip(frames + rng.integers(0, 20, frames.shape), 0, 255).astype(np.uint8)
    tio.write_avi(str(tmp_path / "t.avi"), frames, fps=5.0)
    jio.write_avi(str(tmp_path / "j.avi"), frames, fps=5.0)
    assert (tmp_path / "t.avi").read_bytes() == (tmp_path / "j.avi").read_bytes()
    for path, reader, other in ((tmp_path / "t.avi", jio.AviReader, tio.AviReader),
                                (tmp_path / "j.avi", tio.AviReader, jio.AviReader)):
        a, b = reader(str(path)), other(str(path))
        assert (a.info.num_frames, a.info.width, a.info.height) == (4, 48, 32)
        assert a.info.fps == pytest.approx(b.info.fps)
        np.testing.assert_array_equal(a.read_rgb([3, 1]), b.read_rgb([3, 1]))
        np.testing.assert_array_equal(a.read_gray_small([0, 2], 16, 24), b.read_gray_small([0, 2], 16, 24))
        a.close()
        b.close()


def test_synthetic_videos_match_jax(tmp_path):
    spec = dict(duration=3.0, fps=4.0, width=64, height=48, scene_changes=(1.5,), seed=2)
    for ext in ("y4m", "avi"):
        tr = tsynth.write_synthetic_video(str(tmp_path / f"t.{ext}"), tsynth.SynthSpec(**spec),
                                          audio_path=str(tmp_path / f"t_{ext}.wav"))
        jsynth.write_synthetic_video(str(tmp_path / f"j.{ext}"), jsynth.SynthSpec(**spec),
                                     audio_path=str(tmp_path / f"j_{ext}.wav"))
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
        assert (tmp_path / f"t_{ext}.wav").read_bytes() == (tmp_path / f"j_{ext}.wav").read_bytes()
        assert tr.frames.shape == (12, 48, 64, 3)
        info = tio.probe_video(str(tmp_path / f"t.{ext}"))
        assert (info.num_frames, info.width, info.height) == (12, 64, 48)
        np.testing.assert_array_equal(tio.read_frames_at_times(str(tmp_path / f"t.{ext}"), [0.0, 2.0]),
                                      jio.read_frames_at_times(str(tmp_path / f"j.{ext}"), [0.0, 2.0]))
    assert tio.sample_indices_at_fps(info, 2.0) == jio.sample_indices_at_fps(info, 2.0)
    # .mp4 goes through the libav writer in both packages, audio embedded
    if _native.media_libav_lib() is not None:
        assert tsynth.write_synthetic_video(str(tmp_path / "t.mp4"), tsynth.SynthSpec(**spec)) is None
        jsynth.write_synthetic_video(str(tmp_path / "j.mp4"), jsynth.SynthSpec(**spec))
        assert (tmp_path / "t.mp4").read_bytes() == (tmp_path / "j.mp4").read_bytes()
    with pytest.raises(ValueError, match="unsupported container"):
        tsynth.write_synthetic_video(str(tmp_path / "t.gif"), tsynth.SynthSpec(**spec))


def test_containers_the_port_does_not_read_yet(tmp_path):
    """What neither package reads fails alike: libav containers and AVIs
    that are not media raise ValueError ("cannot open video"), an unknown
    extension ValueError, a missing file OSError, and the audio demux of a
    file libav cannot open returns None."""
    if _native.media_libav_lib() is None:
        pytest.skip("the port's libav shim did not build or load on this host")
    for name in ("v.mp4", "v.mkv", "v.webm"):
        (tmp_path / name).write_bytes(b"\x00" * 64)
        for io_mod in (tio, jio):
            with pytest.raises(ValueError, match="cannot open video"):
                io_mod.open_video(str(tmp_path / name))
    (tmp_path / "v.avi").write_bytes(b"RIFF\x04\x00\x00\x00AVI " + b"\x00" * 32)
    for io_mod in (tio, jio):
        with pytest.raises(ValueError, match="cannot open video"):
            io_mod.open_video(str(tmp_path / "v.avi"))
    (tmp_path / "v.gif").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="unsupported video container"):
        tio.open_video(str(tmp_path / "v.gif"))
    with pytest.raises(ValueError, match="unsupported video container"):
        jio.open_video(str(tmp_path / "v.gif"))
    with pytest.raises(OSError):
        tio.probe_video(str(tmp_path / "missing.y4m"))
    assert tio.demux_audio(str(tmp_path / "v.mp4")) is None
    assert jio.demux_audio(str(tmp_path / "v.mp4")) is None


def test_without_the_shim_jpeg_uses_pil_and_avi_raises(tmp_path, monkeypatch):
    """What a host without a compiler or libjpeg gets, as the JAX package
    does without its shim: PIL for JPEG, RuntimeError for AVI."""
    monkeypatch.setattr(_native, "media_lib", lambda: None)
    assert not tio.native_available()
    img = np.broadcast_to(np.array([30, 160, 220], np.uint8), (24, 32, 3))
    back = tio.jpeg_decode(tio.jpeg_encode(img))
    assert back.shape == img.shape and np.abs(back.astype(int) - img).max() <= 3
    with pytest.raises(RuntimeError, match="AVI encode"):
        tio.write_avi(str(tmp_path / "x.avi"), img[None])
    jio.write_avi(str(tmp_path / "j.avi"), img[None])
    with pytest.raises(RuntimeError, match="AVI decode"):
        tio.open_video(str(tmp_path / "j.avi"))


def test_media_shim_source_ships_with_the_package():
    """csrc/media_jpeg.cpp is covered by the package data glob that ships the
    kernels, and _native builds exactly that file."""
    import glob
    import os
    import tomllib

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]["hippomm_tpu_torch"]
    shipped = {os.path.relpath(p, os.path.join(repo, "hippomm_tpu_torch"))
               for pat in data for p in glob.glob(os.path.join(repo, "hippomm_tpu_torch", pat))}
    assert "csrc/media_jpeg.cpp" in shipped
    assert os.path.exists(os.path.join(_native._CSRC, "media_jpeg.cpp"))


def test_a_shim_that_does_not_load_falls_back(monkeypatch):
    """A shim that builds but whose libjpeg the loader cannot find counts as
    absent: media_lib() is None (PIL for JPEG, AVI raises)."""
    def refuse(path, *a, **k):
        raise OSError(f"{path}: libjpeg.so.62: cannot open shared object file")

    monkeypatch.setattr(_native, "_media", None)
    monkeypatch.setattr(_native, "_media_tried", False)
    monkeypatch.setattr(_native.ctypes, "CDLL", refuse)
    assert _native.media_lib() is None
    assert _native.media_lib() is None  # tried once, not again
