"""The PyTorch port's ingest slice as a whole against the JAX engine: the
same synthetic clip through both HippocampalMemory engines, with tiny fp32
ImageBind towers carrying the same weights, the stub transcriber and stub
clients. The persisted ThetaEvents must agree."""

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
from hippomm_tpu_torch.config import Config as TConfig
from hippomm_tpu_torch.media.synth import SynthSpec, generate
from hippomm_tpu_torch.memory.engine import HippocampalMemory as TMemory
from hippomm_tpu_torch.models.foundation import ImageBind as TImageBind
from hippomm_tpu_torch.models.foundation import Whisper as TWhisper
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
from torch_parity import assert_close

_SPEC = dict(duration=50.0, fps=2.0, width=160, height=120, scene_changes=(18.0, 36.0),
             silence_regions=((35.5, 36.5),), seed=5)


def _config(cls, base_dir):
    cfg = cls()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = "tiny"
    cfg.models.whisper_variant = "stub"
    cfg.storage.base_dir = str(base_dir)
    return cfg


@pytest.fixture(scope="module")
def events(tmp_path_factory):
    res = generate(SynthSpec(**_SPEC))
    jres = jgenerate(JSynthSpec(**_SPEC))
    np.testing.assert_array_equal(res.frames, jres.frames)
    np.testing.assert_array_equal(res.audio, jres.audio)

    jib = JImageBind(variant="tiny", dtype=jnp.float32, seed=0)
    tib = TImageBind(variant="tiny", dtype=torch.float32, device="cpu",
                     params=params_from_jax(jax.tree.map(np.asarray, jib.params),
                                            jib.cfg, "cpu", torch.float32))
    paths = [f"frames/clip/f_{i}.jpg" for i in range(len(res.frames))]
    out = {}
    for tag, mem in (
        ("jax", JMemory(_config(JConfig, tmp_path_factory.mktemp("jax")),
                        models={"imagebind": jib, "whisper": JWhisper(variant="stub")})),
        ("torch", TMemory(_config(TConfig, tmp_path_factory.mktemp("torch")), device="cpu",
                          models={"imagebind": tib, "whisper": TWhisper(variant="stub")})),
    ):
        mem.add_video("clip", "clip.y4m")
        stms = mem.process_sequence("clip", frame_paths=paths, frame_times=res.frame_times,
                                    frames_rgb=res.frames, audio_data=res.audio)
        assert len(mem.long_term_store) == 1
        ev = mem.long_term_store[0]
        out[tag] = (stms, ev, mem.store.load_theta_event(ev.event_id))
    return out


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
