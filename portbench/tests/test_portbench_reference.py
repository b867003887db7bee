"""The plain reference agrees with the port's plain PyTorch path at tiny
widths on the CPU (same weights, same inputs), stage by stage."""


import numpy as np
import pytest
import torch

from portbench.harness import media
from portbench.harness.weights import imagebind_params, whisper_params
from portbench.reference import media as rm
from portbench.reference import models as M
from portbench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    from hippomm_tpu_torch.models.imagebind import model as ibm
    from hippomm_tpu_torch.models.whisper import model as whm

    cfg = tiny.tiny_config()
    return cfg, imagebind_params(cfg, 2**32 + 5, CPU), whisper_params(cfg, 9, CPU), \
        ibm.tiny_config(), whm.tiny_config()


def _close(a, b, tol):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    assert a.shape == b.shape
    assert (a - b).abs().max().item() <= tol * max(1.0, b.abs().max().item())


def test_towers(setup):
    from hippomm_tpu_torch.models.imagebind import model as ibm

    cfg, pib, _, icfg, _ = setup
    g = torch.Generator().manual_seed(0)
    img = torch.randn((3, 3, 56, 56), generator=g)
    _close(ibm.vision_forward(pib, img, icfg, torch.float32), M.vision_forward(pib, cfg, img), 1e-5)
    mel = torch.randn((2, 3, 1, 128, 204), generator=g)
    _close(ibm.audio_forward(pib, mel, icfg, torch.float32), M.audio_forward(pib, cfg, mel[:, :, 0]), 1e-5)


def test_whisper(setup):
    from hippomm_tpu_torch.models.whisper import model as whm

    cfg, _, pwh, _, wcfg = setup
    g = torch.Generator().manual_seed(1)
    mel = torch.randn((2, 80, 200), generator=g)
    enc_p = whm.encoder_forward(pwh, mel, wcfg, torch.float32)
    enc_r = M.whisper_encode(pwh, cfg, mel)
    _close(enc_p, enc_r, 1e-5)
    tok = torch.randint(0, 256, (2, 9), generator=g)
    _close(whm.decoder_forward(pwh, tok, enc_r, wcfg, torch.float32), M.whisper_logits(pwh, cfg, tok, enc_r), 1e-5)


def test_audio_and_image_transforms():
    from hippomm_tpu_torch.models.imagebind.preprocess import preprocess_audio_batch
    from hippomm_tpu_torch.ops.mel import WhisperMel
    from hippomm_tpu_torch.ops.resize import normalize_nchw, resize_crop_u8

    rng = np.random.default_rng(3)
    seg = (0.3 * np.sin(np.arange(41000) / 7.0) + 0.01 * rng.standard_normal(41000)).astype(np.float32)
    cfg = tiny.tiny_config()
    port = preprocess_audio_batch([seg / np.abs(seg).max()], device=CPU)[0, :, 0]
    _close(port, rm.audio_tensor(seg, cfg, CPU), 2e-4)
    chunks = np.stack([np.pad(seg, (0, 480000 - len(seg))), np.pad(seg[:9000], (0, 480000 - 9000))])
    _close(WhisperMel(80, device=CPU)(chunks), rm.whisper_mel(torch.from_numpy(chunks), 80), 2e-4)
    frame = rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)
    _close(normalize_nchw(resize_crop_u8(frame[None], 224), device=CPU)[0], rm.image_tensor(frame), 1e-5)


def test_readers_and_scores(tmp_path):
    from hippomm_tpu_torch.media.io import load_audio_mono16k, open_video
    from hippomm_tpu_torch.ops.ssim import ssim_pairs_host

    spec = media.VideoSpec(8.0, 2.0, 640, 360, (4.0,), ((2.0, 3.0),), 123)
    y, w = str(tmp_path / "v.y4m"), str(tmp_path / "v.wav")
    media.write_video(y, w, spec, CPU)
    r, ref = open_video(y), rm.Y4M(y)
    assert (r.info.num_frames, r.info.fps) == (ref.num_frames, ref.fps) == (16, 2.0)
    assert np.array_equal(r.read_rgb([5])[0], ref.rgb(5))
    assert np.array_equal(r.read_gray_small([5], 90, 160)[0], rm.box_luma(ref.luma(5), 90, 160))
    assert np.array_equal(load_audio_mono16k(w), rm.read_wav(w))
    a, b = rm.box_luma(ref.luma(0), 90, 160), rm.box_luma(ref.luma(9), 90, 160)
    assert rm.ssim(a, b) == pytest.approx(float(ssim_pairs_host(a[None], b[None])[0]), abs=1e-6)


def test_keyframe_walk_and_cuts():
    from hippomm_tpu_torch.memory.segmentation import find_boundaries
    from hippomm_tpu_torch.ops.keyframe import select_keyframes_device

    rng = np.random.default_rng(5)
    base = [rng.integers(0, 256, (90, 160), dtype=np.uint8) for _ in range(3)]
    grays, times = [], []
    for i in range(30):
        g = base[i // 10].astype(np.int16) + rng.integers(-3, 4, (90, 160))
        grays.append(np.clip(g, 0, 255).astype(np.uint8))
        times.append(float(i))
    kept = select_keyframes_device(np.stack(grays), times, device=CPU)
    assert rm.keyframe_faults(grays, times, kept) == 0
    assert rm.keyframe_faults(grays, times, [k for k in kept if k != 10]) > 0
    fs = [rm.ssim(grays[a], grays[b]) for a, b in zip(kept[:-1], kept[1:])]
    kt = [times[k] for k in kept]
    db = rm.window_db(np.ones(16000 * 70, np.float32) * 0.1, 8000, 1600)
    cuts = find_boundaries(kt, np.asarray(fs, np.float32), db, 70.0)
    assert rm.cut_faults(cuts, kt, fs, db, 70.0) == 0
    assert rm.cut_faults([c + 1.0 for c in cuts], kt, fs, db, 70.0) > 0


def test_controls_lower_the_precision():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(2))
    exact = M.FP32.mm(x, x)
    tf32 = (M.Prec("tf32").mm(x, x) - exact).abs().max().item()
    fp8 = (M.Prec("fp8").mm(x, x) - exact).abs().max().item()
    assert 0 < tf32 < fp8
    assert tf32 / exact.abs().max().item() < 5e-3
