"""The port's tensor ops given numpy arrays, as the JAX package's take them:
each one on seeded numpy input with device="cpu" against the JAX function on
the same array (the inputs of the JAX package's own resize, mel, ssim and
silence tests among them), the same call with no device raising on a host
without CUDA rather than staying on the CPU, and resize_normalize by every
method of jax.image.resize, with and without antialiasing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippomm_tpu.ops import mel as jmel
from hippomm_tpu.ops import resize as jres
from hippomm_tpu.ops import silence as jsil
from hippomm_tpu.ops import ssim as jssim
from hippomm_tpu_torch.ops import mel as tmel
from hippomm_tpu_torch.ops import resize as tres
from hippomm_tpu_torch.ops import silence as tsil
from hippomm_tpu_torch.ops import ssim as tssim
from torch_parity import assert_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores with
    JAX's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.uint8)


def _pcm(n, seed):
    return (np.random.default_rng(seed).normal(size=n) * 0.1).astype(np.float32)


def _tone_and_silence():
    """tests/test_silence.py's signal: 2 s tone, 1 s silence, 2 s tone, 0.5 s silence."""
    sr = 16000
    t = lambda d: np.arange(int(sr * d)) / sr  # noqa: E731
    tone = lambda d: 0.5 * np.sin(2 * np.pi * 440 * t(d)).astype(np.float32)  # noqa: E731
    sil = lambda d: np.zeros(int(sr * d), dtype=np.float32)  # noqa: E731
    return np.concatenate([tone(2), sil(1), tone(2), sil(0.5)])


def _pair(seed):
    a = _frames((3, 48, 64), seed)
    b = np.clip(a.astype(int) + np.random.default_rng(seed + 1).integers(-20, 20, a.shape), 0, 255).astype(np.uint8)
    return a, b


# name -> (inputs, JAX call, port call given **kw, tolerance of max abs
# error): one case per function, at the shapes of the JAX package's tests
# (test_resize, test_mel, test_ssim, test_silence) where one of them calls it
CASES = {
    "resize_frames": (lambda: (_frames((3, 720, 1280, 3), 0),),
                      lambda f: jres.resize_frames(f, 180, 320),
                      lambda f, **kw: tres.resize_frames(f, 180, 320, **kw), 1),
    "normalize_nchw": (lambda: (_frames((2, 56, 56, 3), 1),), jres.normalize_nchw, tres.normalize_nchw, 1e-6),
    "resize_normalize": (lambda: (_frames((2, 360, 640, 3), 2),),
                         lambda f: jres.resize_normalize(f, size=224),
                         lambda f, **kw: tres.resize_normalize(f, size=224, **kw), 1e-4),
    "whisper_mel_128": (lambda: (_pcm(16000 * 3, 3),), lambda p: jmel.WhisperMel(n_mels=128)(p),
                        lambda p, **kw: tmel.WhisperMel(n_mels=128, **kw)(p), 1e-4),
    "whisper_mel_80": (lambda: (_pcm(16000, 4),), lambda p: jmel.WhisperMel(n_mels=80)(p),
                       lambda p, **kw: tmel.WhisperMel(n_mels=80, **kw)(p), 1e-4),
    "kaldi_fbank": (lambda: (_pcm(16000, 5),), lambda p: jmel.KaldiFbank(num_mel_bins=128)(p),
                    lambda p, **kw: tmel.KaldiFbank(num_mel_bins=128, **kw)(p), 1e-4),
    "ssim_pairs": (lambda: _pair(6), jssim.ssim_pairs, tssim.ssim_pairs, 1e-4),
    "rgb_to_gray": (lambda: (_frames((2, 8, 8, 3), 8),), jssim.rgb_to_gray, tssim.rgb_to_gray, 1e-4),
    "frame_difference": (lambda: (_frames((2, 32, 32), 9),) * 2, jssim.frame_difference,
                         tssim.frame_difference, 1e-5),
    "window_rms_db": (lambda: (_tone_and_silence(),), lambda p: jsil.window_rms_db(p, window=800, hop=800),
                      lambda p, **kw: tsil.window_rms_db(p, window=800, hop=800, **kw), 1e-3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_numpy_input_matches_jax(request, name):
    """The numpy arrays themselves (no tensor made by the caller) with
    device="cpu": a CPU tensor of JAX's shape within the case's tolerance
    (resize_frames: ±1 level on < 0.1 % of the pixels, its fp32 rounding at
    .5)."""
    make, jfn, tfn, tol = CASES[name]
    args = make()
    want = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    got = tfn(*args, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert_close(request, got.astype(np.float64), want.astype(np.float64), tol)
    if name == "resize_frames":
        share = float((got != want).mean())
        request.node.user_properties.append(("share_differing", f"{share!r} < 0.001"))
        assert share < 1e-3


@pytest.mark.parametrize("name", sorted(CASES))
def test_numpy_input_goes_to_cuda(monkeypatch, name):
    """The same call with no device: an array goes to CUDA, so a host
    without it raises resolve_device's error; a CPU tensor stays where it
    is."""
    make, _, tfn, _ = CASES[name]
    args = make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfn(*args)
    if not name.startswith(("whisper", "kaldi")):  # the frontends' matrices live on their own device
        assert tfn(*(torch.from_numpy(a) for a in args)).device.type == "cpu"


METHODS = ["nearest", "linear", "bilinear", "triangle", "cubic", "bicubic", "lanczos3", "lanczos5"]


@pytest.mark.parametrize("hw", [(90, 160), (120, 96), (224, 224)])
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_resize_normalize_methods_match_jax(request, method, antialias, hw):
    """Every jax.image.resize method, antialiased or not: within 1e-4 of
    JAX's resize_normalize (fp32 resampling sums in another order)."""
    frames = _frames((2, *hw, 3), 10)
    want = np.asarray(jres.resize_normalize(jnp.asarray(frames), size=56, method=method, antialias=antialias))
    got = tres.resize_normalize(frames, size=56, method=method, antialias=antialias, device="cpu").numpy()
    assert got.shape == want.shape == (2, 3, 56, 56)
    assert_close(request, got, want, 1e-4, f"resize_normalize_{method}_{antialias}_{hw[0]}x{hw[1]}")


def test_resize_normalize_refuses_an_unknown_method():
    frames = _frames((1, 20, 30, 3), 11)
    with pytest.raises(ValueError, match="Unknown resize method"):
        jres.resize_normalize(jnp.asarray(frames), size=8, method="area")
    with pytest.raises(ValueError, match="Unknown resize method"):
        tres.resize_normalize(frames, size=8, method="area", device="cpu")
