"""The PyTorch port's ingest slice as a whole against the JAX engine: the
same synthetic clip through both HippocampalMemory engines, with tiny fp32
ImageBind towers and a tiny fp32 Whisper carrying the same weights, and stub
clients. The persisted ThetaEvents must agree, transcripts included — in the
default configuration, and with the fused-block flags (HIPPOMM_FUSED_BLOCK=1,
HIPPOMM_FLASH_BTHD=1) on in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.config import Config as JConfig
from hippomm_tpu.media.synth import SynthSpec as JSynthSpec
from hippomm_tpu.media.synth import generate as jgenerate
from hippomm_tpu.memory.engine import HippocampalMemory as JMemory
from hippomm_tpu.models.foundation import ImageBind as JImageBind
from hippomm_tpu.models.foundation import Whisper as JWhisper
from hippomm_tpu.models.imagebind import model as jib_model
from hippomm_tpu.ops import flash_attention as jfa
from hippomm_tpu.ops import fused_mlp as jfm
from hippomm_tpu_torch.config import Config as TConfig
from hippomm_tpu_torch.media.synth import SynthSpec, generate
from hippomm_tpu_torch.memory.engine import HippocampalMemory as TMemory
from hippomm_tpu_torch.models.foundation import ImageBind as TImageBind
from hippomm_tpu_torch.models.foundation import Whisper as TWhisper
from hippomm_tpu_torch.models.imagebind import model as tib_model
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
from hippomm_tpu_torch.models.whisper.carry import params_from_jax as whisper_from_jax
from hippomm_tpu_torch.ops import flash_attention as tfa
from hippomm_tpu_torch.ops import fused_mlp as tfm
from torch_parity import assert_close

_SPEC = dict(duration=50.0, fps=2.0, width=160, height=120, scene_changes=(18.0, 36.0),
             silence_regions=((35.5, 36.5),), seed=5)
_FLAGS = ("HIPPOMM_FUSED_BLOCK", "HIPPOMM_FLASH_BTHD", "HIPPOMM_FLASH_ATTN")


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


def _clear_flag_caches():
    for f in (jfa.flash_default, jfa.bthd_default, jfm.fused_block_default, tfa.flash_default,
              tfa.bthd_default, tfm.fused_mlp_default, tfm.fused_block_default):
        f.cache_clear()
    jax.clear_caches()  # jitted JAX towers re-trace under the current routes


def _tiny_width_128(mod):
    """The tiny ImageBind config with both towers 128 wide: the narrowest
    width the K2/K3 gate (D % 128 == 0) admits."""
    c = mod.tiny_config()
    return dataclasses.replace(c, vision=dataclasses.replace(c.vision, width=128),
                               audio=dataclasses.replace(c.audio, width=128))


def _run_engines(tmp_path_factory, tag):
    res = generate(SynthSpec(**_SPEC))
    jres = jgenerate(JSynthSpec(**_SPEC))
    np.testing.assert_array_equal(res.frames, jres.frames)
    np.testing.assert_array_equal(res.audio, jres.audio)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jib_model, "get_config", lambda variant: _tiny_width_128(jib_model))
        mp.setattr(tib_model, "get_config", lambda variant: _tiny_width_128(tib_model))
        jib = JImageBind(variant="tiny", dtype=jnp.float32, seed=0)
        tib = TImageBind(variant="tiny", dtype=torch.float32, device="cpu",
                         params=params_from_jax(jax.tree.map(np.asarray, jib.params),
                                                jib.cfg, "cpu", torch.float32))
    assert tib.cfg.vision.width == tib.cfg.audio.width == 128
    jwh = JWhisper(variant="tiny", dtype=jnp.float32, seed=0, beam_size=1)
    twh = TWhisper(variant="tiny", dtype=torch.float32, beam_size=1, device="cpu",
                   params=whisper_from_jax(jax.tree.map(np.asarray, jwh._impl.params),
                                           jwh.cfg, "cpu", torch.float32))
    for w in (jwh, twh):
        w._impl.tokenizer = IdTokenizer()
    paths = [f"frames/clip/f_{i}.jpg" for i in range(len(res.frames))]
    out = {}
    for pkg, mem in (
        ("jax", JMemory(_config(JConfig, tmp_path_factory.mktemp(f"jax_{tag}")),
                        models={"imagebind": jib, "whisper": jwh})),
        ("torch", TMemory(_config(TConfig, tmp_path_factory.mktemp(f"torch_{tag}")), device="cpu",
                          models={"imagebind": tib, "whisper": twh})),
    ):
        mem.add_video("clip", "clip.y4m")
        stms = mem.process_sequence("clip", frame_paths=paths, frame_times=res.frame_times,
                                    frames_rgb=res.frames, audio_data=res.audio)
        assert len(mem.long_term_store) == 1
        ev = mem.long_term_store[0]
        out[pkg] = (stms, ev, mem.store.load_theta_event(ev.event_id))
    return out


@pytest.fixture(scope="module")
def events(tmp_path_factory):
    return _run_engines(tmp_path_factory, "default")


@pytest.fixture(scope="module")
def fused_events(tmp_path_factory):
    """Both engines with the fused-block flags on; the JAX Pallas kernels in
    interpret mode. Also returns the kernel calls each package made."""
    calls = {"jax": [], "torch": []}
    real = {"jfa": jfa.flash_mha, "jbthd": jfa.flash_mha_bthd, "jblk": jfm.fused_ln_mlp_residual,
            "tbthd": tfa.flash_mha_bthd, "tblk": tfm.fused_ln_mlp_residual}

    def jax_bthd(q, k, v, scale, interpret=False):
        calls["jax"].append("K4")
        return real["jbthd"](q, k, v, scale, True)

    def jax_block(x, g, b, w1, b1, w2, b2, eps=1e-6, interpret=False):
        calls["jax"].append("K3")
        return real["jblk"](x, g, b, w1, b1, w2, b2, eps, True)

    with pytest.MonkeyPatch.context() as mp:
        for flag in _FLAGS:
            mp.setenv(flag, "1")
        mp.setattr(jfa, "flash_mha", lambda q, k, v, s, interpret=False, opt=False:
                   real["jfa"](q, k, v, s, True, opt))
        mp.setattr(jfa, "flash_mha_bthd", jax_bthd)
        mp.setattr(jfm, "fused_ln_mlp_residual_vjp", jax_block)
        mp.setattr(tfa, "flash_mha_bthd",
                   lambda *a: calls["torch"].append("K4") or real["tbthd"](*a))
        mp.setattr(tfm, "fused_ln_mlp_residual",
                   lambda *a: calls["torch"].append("K3") or real["tblk"](*a))
        _clear_flag_caches()
        try:
            out = _run_engines(tmp_path_factory, "fused")
        finally:
            _clear_flag_caches()
    return out, calls


def test_segments_agree(events):
    js, ts = events["jax"][0], events["torch"][0]
    assert len(ts) == len(js) >= 2
    for a, b in zip(js, ts):
        assert a.segment_info == b.segment_info
        assert a.modalities == b.modalities
        assert a.transcription == b.transcription


def test_theta_event_agrees(request, events):
    _, je, _ = events["jax"]
    _, te, _ = events["torch"]
    assert te.frames == je.frames  # the kept key frames
    assert te.frame_times == je.frame_times
    assert te.feature_times == je.feature_times
    assert te.audio_times == je.audio_times
    assert te.audio_transcription == je.audio_transcription
    assert te.holistic_audio_transcription == je.holistic_audio_transcription
    assert te.frame_captions == je.frame_captions
    assert te.summary == je.summary
    assert (te.start_time, te.end_time, te.modalities) == (je.start_time, je.end_time, je.modalities)
    # features to 1e-5 on the unit-norm embeddings (audio rows are 20·unit)
    for k, norm in (("vision", 1.0), ("audio", 20.0)):
        assert_close(request, te.features[k], je.features[k], 1e-5, f"max_abs_err_{k}", scale=norm)


def test_persisted_event_round_trips(events):
    _, te, loaded = events["torch"]
    np.testing.assert_allclose(loaded.features["vision"], te.features["vision"], rtol=1e-6)
    assert loaded.summary == te.summary
    assert te.features["vision"].shape[1] == 1024
    np.testing.assert_allclose(np.linalg.norm(te.features["vision"], axis=1), 1.0, atol=1e-5)


def test_transcripts_come_from_the_whisper_tower(events):
    """The tiny Whisper's transcripts reach the STMs and the event: text
    decoded from token ids, in 30 s windows with global times."""
    _, te, _ = events["torch"]
    assert te.holistic_audio_transcription and te.audio_transcription
    for entry in te.holistic_audio_transcription:
        assert entry["text"] and 0.0 <= entry["start"] < entry["end"] <= _SPEC["duration"]


def test_theta_event_agrees_with_fused_routes(request, fused_events):
    """With the flags on, every tiny encoder block of both towers and of
    Whisper (H = 4 passes the K4 gate) takes K4 and every ImageBind block K3
    in both packages (JAX records its calls when it traces, the port at
    every call), and the events agree."""
    out, calls = fused_events
    assert set(calls["torch"]) == set(calls["jax"]) == {"K3", "K4"}
    # the port: per tower chunk, one K3 and one K4 per ImageBind block; one
    # K4 per Whisper encoder block on top
    assert calls["torch"].count("K4") > calls["torch"].count("K3") > 0
    _, je, _ = out["jax"]
    _, te, _ = out["torch"]
    assert te.frames == je.frames and te.feature_times == je.feature_times
    assert te.audio_transcription == je.audio_transcription
    assert te.holistic_audio_transcription == je.holistic_audio_transcription
    for k, norm in (("vision", 1.0), ("audio", 20.0)):
        assert_close(request, te.features[k], je.features[k], 1e-5, f"max_abs_err_{k}", scale=norm)


def test_fused_routes_agree_with_default_routes(request, events, fused_events):
    """The port's fused configuration against its default one: the same
    event up to the kernels' fp32 rounding, the same transcripts."""
    _, td, _ = events["torch"]
    _, tf, _ = fused_events[0]["torch"]
    assert tf.frames == td.frames
    assert tf.holistic_audio_transcription == td.holistic_audio_transcription
    for k, norm in (("vision", 1.0), ("audio", 20.0)):
        assert_close(request, tf.features[k], td.features[k], 1e-5, f"max_abs_err_{k}", scale=norm)


@pytest.mark.parametrize("t", [20, 70])
def test_adjacent_similarity_gray_matches_jax(request, t):
    """Both sides of the ≤33-frame size rule: host fp32 below it, the
    chunked device pass above it."""
    from hippomm_tpu.memory.segmentation import adjacent_similarity_gray as jgray
    from hippomm_tpu_torch.memory.segmentation import adjacent_similarity_gray as tgray

    rng = np.random.default_rng(11)
    grays = np.clip(rng.integers(40, 200, (1, 45, 80)) + rng.normal(0, 6, (t, 45, 80)), 0, 255)
    grays = grays.astype(np.uint8)
    grays[t // 2:] = 255 - grays[t // 2:]
    want = jgray(grays)
    got = tgray(grays, device="cpu")
    assert got.shape == want.shape == (t - 1,)
    assert_close(request, got, want, 1e-4)
