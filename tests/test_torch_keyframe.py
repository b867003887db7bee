"""The port's greedy key-frame scan (ops/keyframe) against the JAX
package's: `select_keyframes_device` / `KeyframeScanner` of both packages,
and the JAX host statement of the walk (`select_keyframes_greedy`), on the
same seeded candidate luma. The masks must be equal."""

import numpy as np
import pytest
import torch

from hippomm_tpu.core.batch_process import select_keyframes_greedy
from hippomm_tpu.ops import keyframe as jkf
from hippomm_tpu.ops.ssim import ssim_pairs_host
from hippomm_tpu_torch.ops import keyframe as tkf

H, W = 90, 160


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The CPU scan is ~20 small ops a candidate: one intra-op thread runs
    them 2-4× faster than a pool contending with JAX's and other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _luma(kind: str, n: int, seed: int) -> np.ndarray:
    """(n, 90, 160) uint8 candidate luma: `cuts` changes scene every few
    candidates (plus noise), `static` is one frame with sensor noise, `fade`
    drifts its brightness and texture so only the cumulative diff fires."""
    rng = np.random.default_rng(seed)
    if kind == "cuts":
        scenes = rng.integers(20, 235, size=(1 + n // 3, H, W)).astype(np.float32)
        which = np.cumsum(rng.random(n) < 0.15)
        g = scenes[which % len(scenes)] + rng.normal(0, 4, (n, H, W))
    elif kind == "static":
        base = rng.integers(40, 200, size=(H, W)).astype(np.float32)
        g = base[None] + rng.normal(0, 1.0, (n, H, W))
    else:  # fade
        base = rng.integers(60, 200, size=(H, W)).astype(np.float32)
        drift = rng.normal(0, 1, size=(H, W))
        i = np.arange(n, dtype=np.float32)[:, None, None]
        g = base[None] * (1.0 - 0.004 * i) + drift[None] * i * 1.2 + 6 * np.sin(i / 5.0)
    return np.clip(g, 0, 255).astype(np.uint8)


def _times(n: int, spacing: float) -> list:
    return [float(t) for t in np.arange(n) * spacing]


def _jax_device(grays, times, block, monkeypatch):
    monkeypatch.setenv("HIPPOMM_SCAN_ROUTE", "device")  # no host routing on the JAX side
    return jkf.select_keyframes_device(grays, times, 0.3, 1.0, block=block, router=jkf._ScanRouter())


def _jax_host(grays, times):
    def score_fn(ref, block):  # the JAX package's host SSIM (fp64)
        return ssim_pairs_host(np.broadcast_to(ref, block.shape), block)

    return select_keyframes_greedy(grays, times, score_fn, 0.3, 1.0)


@pytest.mark.parametrize("kind", ["cuts", "static", "fade"])
@pytest.mark.parametrize("block", [64, 256])
def test_select_keyframes_matches_jax(kind, block, monkeypatch):
    """200 candidates: four blocks of 64 (the carry crosses three block
    boundaries) or one of 256 (a ragged single block); times 0.5 s apart,
    so the minimum-interval gate skips candidates too."""
    n = 200
    grays, times = _luma(kind, n, seed=7), _times(n, 0.5)
    got = tkf.select_keyframes_device(grays, times, 0.3, 1.0, block=block, device="cpu")
    assert got == _jax_device(grays, times, block, monkeypatch)
    # the walk is causal, so the host statement (O(saves × block) SSIMs in
    # fp64) is held to the first 64 candidates' selection
    assert [i for i in got if i < 64] == _jax_host(grays[:64], times[:64])
    if kind == "static":
        assert got == [0]
    else:
        assert len(got) > 3


@pytest.mark.parametrize("kind", ["cuts", "fade"])
def test_scanner_fed_in_ragged_blocks_matches_jax(kind, monkeypatch):
    """The streaming scanner fed blocks of 64 with a short last one, masks
    read one at a time, in one batched read, or polled first: the
    concatenated masks equal the JAX scanner's."""
    n, block = 150, 64
    grays, times = _luma(kind, n, seed=11), _times(n, 1.0)
    monkeypatch.setenv("HIPPOMM_SCAN_ROUTE", "device")
    jsc = jkf.KeyframeScanner(H, W, 0.3, 1.0, block=block, router=jkf._ScanRouter())
    jh = [jsc.feed(grays[b:b + block], times[b:b + block]) for b in range(0, n, block)]
    want = np.concatenate([h.get() for h in jh])
    jsc.close()
    for read in ("serial", "prefetch", "poll"):
        sc = tkf.KeyframeScanner(H, W, 0.3, 1.0, block=block, device="cpu")
        hs = [sc.feed(grays[b:b + block], times[b:b + block]) for b in range(0, n, block)]
        if read == "prefetch":
            sc.prefetch_masks(hs)
        if read == "poll":
            assert all(h.is_ready() for h in hs)
        got = np.concatenate([h.get() for h in hs])
        sc.close()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and got.shape == (n,)
    assert want.sum() > 3


def test_scanner_refuses_an_oversized_block():
    sc = tkf.KeyframeScanner(H, W, block=8, device="cpu")
    with pytest.raises(ValueError, match="8-candidate"):
        sc.feed(np.zeros((9, H, W), np.uint8), np.arange(9.0))


def test_select_keyframes_of_nothing():
    assert tkf.select_keyframes_device(np.zeros((0, H, W), np.uint8), [], device="cpu") == []
