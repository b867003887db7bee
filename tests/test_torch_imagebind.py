"""Parity of the PyTorch port's ImageBind towers and preprocessing ops
against the JAX package, on the CPU, in fp32, with weights carried across
by carry.params_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.models.imagebind import model as jm
from hippomm_tpu.models.imagebind import preprocess as jpre
from hippomm_tpu.ops import mel as jmel
from hippomm_tpu.ops import resize as jres
from hippomm_tpu.ops import silence as jsil
from hippomm_tpu.ops import similarity as jsim
from hippomm_tpu.ops import ssim as jssim
from hippomm_tpu_torch.models.foundation import ImageBind, Whisper
from hippomm_tpu_torch.models.imagebind import model as tm
from hippomm_tpu_torch.models.imagebind import preprocess as tpre
from hippomm_tpu_torch.models.imagebind.carry import params_from_jax
from hippomm_tpu_torch.ops import mel as tmel
from hippomm_tpu_torch.ops import resize as tres
from hippomm_tpu_torch.ops import silence as tsil
from hippomm_tpu_torch.ops import similarity as tsim
from hippomm_tpu_torch.ops import ssim as tssim
from torch_parity import assert_close


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jm.tiny_config()
    params_j = jm.init_imagebind(jax.random.PRNGKey(0), cfg_j)
    # perturb the zero-initialised biases / cls tokens so every term counts
    # (numpy noise: per-leaf jax.random calls would compile once per shape)
    rng = np.random.default_rng(1)
    params_np = jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape)).astype(np.float32), params_j
    )
    params_j = jax.tree.map(jnp.asarray, params_np)
    cfg_t = tm.tiny_config()
    params_t = params_from_jax(params_np, cfg_t, "cpu", torch.float32)
    return cfg_j, params_j, cfg_t, params_t


def test_carry_unstacks_blocks(tiny):
    cfg_j, params_j, cfg_t, params_t = tiny
    assert len(params_t["vision"]["blocks"]) == cfg_t.vision.depth
    assert len(params_t["audio"]["blocks"]) == cfg_t.audio.depth
    w = params_t["vision"]["blocks"][1]["attn"]["in_proj"]["weight"]
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(params_j["vision"]["blocks"]["attn"]["in_proj"]["weight"][1])
    )
    bf = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, "cpu", torch.bfloat16)
    assert bf["vision"]["head_proj"]["weight"].dtype == torch.bfloat16
    assert bf["vision"]["pos_embed"].dtype == torch.float32
    assert bf["audio"]["blocks"][0]["attn"]["bias_k"].dtype == torch.float32


def test_vision_forward_matches_jax(request, tiny):
    cfg_j, params_j, cfg_t, params_t = tiny
    s = cfg_j.image_size
    x = np.random.default_rng(2).standard_normal((3, 3, s, s)).astype(np.float32)
    want = np.asarray(jm.vision_forward(params_j, jnp.asarray(x), cfg_j, jnp.float32))
    got = tm.vision_forward(params_t, torch.from_numpy(x), cfg_t, torch.float32).numpy()
    assert got.shape == (3, 1024)
    assert_close(request, got, want, 1e-5)


@pytest.mark.parametrize("multi_clip", [False, True])
def test_audio_forward_matches_jax(request, tiny, multi_clip):
    cfg_j, params_j, cfg_t, params_t = tiny
    shape = (2, 3, 1, 128, 204) if multi_clip else (2, 1, 128, 204)
    mel = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(jm.audio_forward(params_j, jnp.asarray(mel), cfg_j, jnp.float32))
    got = tm.audio_forward(params_t, torch.from_numpy(mel), cfg_t, torch.float32).numpy()
    assert got.shape == (2, 1024)
    # unit vectors scaled by 20: the ≤1e-5 bound holds on the normalised rows
    assert_close(request, got, want, 1e-5, scale=20.0)


def test_preprocess_audio_matches_jax(request):
    rng = np.random.default_rng(4)
    pcms = [rng.uniform(-0.5, 0.5, n).astype(np.float32) for n in (16000 * 7, 9000, 16000 * 3)]
    want = np.asarray(jpre.preprocess_audio_batch(pcms))
    got = tpre.preprocess_audio_batch(pcms, device="cpu").numpy()
    assert got.shape == want.shape == (3, 3, 1, 128, 204)
    assert_close(request, got, want, 1e-4)


def test_kaldi_fbank_matches_jax(request):
    pcm = np.random.default_rng(5).uniform(-1, 1, 16000 * 2).astype(np.float32)
    want = np.asarray(jmel.KaldiFbank(128)(jnp.asarray(pcm)))
    got = tmel.KaldiFbank(128, device="cpu")(torch.from_numpy(pcm)).numpy()
    assert_close(request, got, want, 1e-4)


def test_resize_frames_matches_jax(request):
    frames = np.random.default_rng(6).integers(0, 256, (4, 120, 200, 3), dtype=np.uint8)
    want = np.asarray(jres.resize_frames(jnp.asarray(frames), 45, 80)).astype(np.int32)
    got = tres.resize_frames(torch.from_numpy(frames), 45, 80).numpy().astype(np.int32)
    assert got.shape == want.shape == (4, 45, 80, 3)
    # rounding of an fp32 value that lands on .5 may fall either way
    assert_close(request, got, want, 1, "max_abs_err_levels")
    share = float((got != want).mean())
    request.node.user_properties.append(("share_differing", f"{share!r} < 0.001"))
    assert share < 1e-3


def test_resize_crop_and_normalize_match_jax(request):
    frames = np.random.default_rng(7).integers(0, 256, (2, 90, 160, 3), dtype=np.uint8)
    crops_j = jres.resize_crop_u8(frames, 56)
    crops_t = tres.resize_crop_u8(frames, 56)
    np.testing.assert_array_equal(crops_t, crops_j)
    want = np.asarray(jres.normalize_nchw(jnp.asarray(crops_j)))
    got = tres.normalize_nchw(torch.from_numpy(crops_t)).numpy()
    assert_close(request, got, want, 1e-6)


def test_adjacent_ssim_matches_jax(request):
    rng = np.random.default_rng(8)
    base = rng.integers(0, 256, (1, 45, 80), dtype=np.uint8).astype(np.float32)
    frames = np.clip(base + rng.normal(0, 8, (6, 45, 80)), 0, 255).astype(np.float32)
    frames[3:] = 255.0 - frames[3:]  # a cut
    want = np.asarray(jssim.adjacent_ssim(jnp.asarray(frames)))
    got = tssim.adjacent_ssim(torch.from_numpy(frames)).numpy()
    assert_close(request, got, want, 1e-4)
    rgb = rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    np.testing.assert_allclose(tssim.rgb_to_gray(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jssim.rgb_to_gray(jnp.asarray(rgb))), atol=1e-4)


def test_window_rms_db_matches_jax(request):
    pcm = np.random.default_rng(9).uniform(-0.3, 0.3, 16000 * 3).astype(np.float32)
    pcm[16000:20000] = 0.0
    for win, hop in [(8000, 1600), (800, 800), (1000, 300)]:
        want = np.asarray(jsil.window_rms_db(jnp.asarray(pcm), win, hop))
        got = tsil.window_rms_db(torch.from_numpy(pcm), win, hop).numpy()
        assert_close(request, got, want, 1e-3, f"max_abs_err_db[{win},{hop}]")
        np.testing.assert_allclose(tsil.window_rms_db_host(pcm, win, hop),
                                   jsil.window_rms_db_host(pcm, win, hop), atol=1e-5)
    assert tsil.detect_silence_regions(pcm) == jsil.detect_silence_regions(pcm)


@pytest.mark.parametrize("n", [40, 300])
def test_select_keyframes_matches_jax(n):
    rng = np.random.default_rng(10)
    centers = rng.standard_normal((6, 32)).astype(np.float32)
    feats = centers[rng.integers(0, 6, n)] + 0.3 * rng.standard_normal((n, 32)).astype(np.float32)
    want = jsim.select_keyframes(feats, threshold=0.9)
    got = tsim.select_keyframes(feats, threshold=0.9, device="cpu")
    np.testing.assert_array_equal(got, want)
    if n > 256:  # the device route: bucket-padded masked scan
        b = tsim.keyframe_bucket(n)
        padded = np.concatenate([feats, np.zeros((b - n, 32), np.float32)])
        mask_j = np.asarray(jsim.select_keyframes_mask(jnp.asarray(padded), threshold=0.9, n=n))
        mask_t = tsim.select_keyframes_mask(torch.from_numpy(padded), threshold=0.9, n=n)
        np.testing.assert_array_equal(mask_t.numpy(), mask_j)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImageBind(variant="tiny")
    ib = ImageBind(variant="tiny", device="cpu", dtype=torch.float32)
    assert ib.device.type == "cpu"


def test_whisper_variants_outside_the_stub_wait_for_their_slice():
    """Their slice has come: the default without a checkpoint is still the
    stub, "tiny" and `random_init` build the Whisper tower, and an explicit
    path that holds no checkpoint raises instead of stubbing."""
    assert Whisper().transcribe(np.zeros(1600, np.float32)) == []
    for kw in ({"variant": "tiny"}, {"variant": "tiny", "random_init": True}):
        w = Whisper(device="cpu", dtype=torch.float32, **kw)
        assert w.cfg is not None and w.cfg.d_model == 64
        segs = w.transcribe(np.zeros(1600, np.float32))
        assert [(s.start, s.end, s.text) for s in segs] == [(0.0, 0.1, "")]  # no tokenizer: no text
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Whisper(model_path="/nonexistent", device="cpu")


@pytest.mark.parametrize("towers", [("vision", "audio", "text"), ("vision",), ("audio", "text")])
def test_extract_features_matches_jax(request, tiny, towers):
    """extract_features over the towers given, on numpy inputs (each goes
    to the parameters' device): the keys JAX returns, each within 1e-5
    (fp32; audio on its unit rows ×20) and equal to its tower's forward."""
    cfg_j, params_j, cfg_t, params_t = tiny
    rng = np.random.default_rng(12)
    s = cfg_j.image_size
    tokens = rng.integers(1, cfg_j.vocab_size - 1, size=(3, cfg_j.context_length)).astype(np.int32)
    tokens[:, -1] = cfg_j.vocab_size - 1
    inputs = {"vision": rng.standard_normal((3, 3, s, s)).astype(np.float32),
              "audio": rng.standard_normal((2, 1, 128, 204)).astype(np.float32), "text": tokens}
    given = {k: inputs[k] for k in towers}
    want = jm.extract_features(params_j, cfg_j, **{k: jnp.asarray(v) for k, v in given.items()}, dtype=jnp.float32)
    got = tm.extract_features(params_t, cfg_t, **given, dtype=torch.float32)
    assert sorted(got) == sorted(want) == sorted(towers)
    forwards = {"vision": tm.vision_forward, "audio": tm.audio_forward, "text": tm.text_forward}
    for k in towers:
        assert got[k].shape == (inputs[k].shape[0], 1024)
        assert_close(request, got[k].numpy(), np.asarray(want[k]), 1e-5, f"max_abs_err_{k}",
                     scale=20.0 if k == "audio" else 1.0)
        assert torch.equal(got[k], forwards[k](params_t, torch.from_numpy(inputs[k]), cfg_t, torch.float32))


@pytest.mark.parametrize("hw", [(90, 160), (224, 300)])
def test_preprocess_vision_matches_jax(request, hw):
    """preprocess_vision on uint8 numpy frames: JAX's within 1e-5 of the
    normalized range (the resampling sums in another order), and bit-equal
    to resize_normalize's."""
    frames = np.random.default_rng(13).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(jpre.preprocess_vision(frames, image_size=56))
    got = tpre.preprocess_vision(frames, image_size=56, device="cpu")
    assert got.shape == want.shape == (2, 3, 56, 56)
    assert_close(request, got.numpy(), want, 1e-5)
    assert torch.equal(got, tres.resize_normalize(frames, size=56, device="cpu"))
