"""The Y4M reader's YUV420→RGB: the native `hmm_yuv420_to_rgb_batch`
(csrc/media_resize.cpp) bit for bit against the numpy reference
`media/io._yuv420_to_rgb_np`, on every (Y, U, V) triple and on random
planes, in full and limited range; `Y4MReader.read_rgb` and
`read_block(...).take_rgb` on the native path, on the numpy path and in the
JAX package's reader; and the span and counters each read leaves in the
port's ring."""

import time

import numpy as np
import pytest

from hippomm_tpu.media import io as jio
from hippomm_tpu_torch.media import io as tio
from hippomm_tpu_torch.ops import _native
from hippomm_tpu_torch.utils import timers


def _lib():
    lib = _native.resize_lib()
    assert lib is not None, "the host conversion library must build where g++ is"
    return lib


def _native_rgb(y, u, v, limited):
    n, h, w = y.shape
    y, u, v = (np.ascontiguousarray(p) for p in (y, u, v))
    out = np.empty((n, h, w, 3), np.uint8)
    rc = _lib().hmm_yuv420_to_rgb_batch(y.ctypes.data, u.ctypes.data, v.ctypes.data, n, h, w,
                                        h * w, h * w // 4, int(limited), out.ctypes.data)
    assert rc == 0
    return out


def _every_triple(first, count):
    """Frames `first`..`first + count - 1` of 64 frames of 512x512 that hold
    every (Y, U, V) triple: each frame's chroma is every (U, V) pair, and the
    four luma samples of each 2x2 block take 4k .. 4k + 3 in frame k."""
    cu, cv = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                         indexing="ij")
    dy, dx = np.meshgrid(np.arange(512) % 2, np.arange(512) % 2, indexing="ij")
    ks = np.arange(first, first + count)
    y = (4 * ks[:, None, None] + 2 * dy + dx).astype(np.uint8)
    return y, np.broadcast_to(cu, (count, 256, 256)), np.broadcast_to(cv, (count, 256, 256))


def _pre_round(y, u, v, limited):
    """numpy's float32 channels before the rounding, as the reference computes them."""
    yf = y.astype(np.float32)
    uf = np.repeat(np.repeat(u.astype(np.float32), 2, axis=1), 2, axis=2) - 128.0
    vf = np.repeat(np.repeat(v.astype(np.float32), 2, axis=1), 2, axis=2) - 128.0
    if limited:
        yf, uf, vf = (yf - 16.0) * (255.0 / 219.0), uf * (255.0 / 224.0), vf * (255.0 / 224.0)
    return np.stack([yf + 1.402 * vf, yf - 0.344136 * uf - 0.714136 * vf, yf + 1.772 * uf])


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
def test_native_equals_numpy_on_every_yuv_triple(limited):
    """All 2^24 triples, so every .5 tie and both clamps the conversion can
    meet; the ties and the clamps are counted to show they are there."""
    ties = low = high = 0
    for first in range(0, 64, 8):
        y, u, v = _every_triple(first, 8)
        np.testing.assert_array_equal(_native_rgb(y, u, v, limited),
                                      tio._yuv420_to_rgb_np(y, u, v, limited=limited))
        x = _pre_round(y, u, v, limited)
        ties += int(np.count_nonzero(x - np.floor(x) == 0.5))
        low += int(np.count_nonzero(x < -0.5))
        high += int(np.count_nonzero(x > 255.5))
    assert ties > 0 and low > 0 and high > 0, (ties, low, high)


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
@pytest.mark.parametrize("h,w", [(360, 640), (2, 2), (120, 160), (6, 34), (480, 854)])
def test_native_equals_numpy_on_random_planes(h, w, limited):
    rng = np.random.default_rng(h * 1000 + w + limited)
    y = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    u = rng.integers(0, 256, (3, h // 2, w // 2), dtype=np.uint8)
    v = rng.integers(0, 256, (3, h // 2, w // 2), dtype=np.uint8)
    np.testing.assert_array_equal(_native_rgb(y, u, v, limited),
                                  tio._yuv420_to_rgb_np(y, u, v, limited=limited))


@pytest.mark.parametrize("h,w", [(3, 4), (4, 5), (0, 4)])
def test_native_refuses_a_size_that_is_not_positive_and_even(h, w):
    out = np.empty(max(1, h * w * 3), np.uint8)
    buf = np.zeros(max(1, h * w * 2), np.uint8)
    p = buf.ctypes.data
    assert _lib().hmm_yuv420_to_rgb_batch(p, p, p, 1, h, w, 0, 0, 0, out.ctypes.data) == -1


def _write_random_y4m(path, n, h, w, limited, seed):
    """A y4m of random planes (chroma that no RGB frame would give), as a
    camera or an encoder writes it; XCOLORRANGE=LIMITED where `limited`."""
    rng = np.random.default_rng(seed)
    head = f"YUV4MPEG2 W{w} H{h} F2:1 Ip A1:1 C420jpeg"
    head += " XCOLORRANGE=LIMITED\n" if limited else "\n"
    with open(path, "wb") as f:
        f.write(head.encode())
        for _ in range(n):
            f.write(b"FRAME\n" + rng.integers(0, 256, h * w * 3 // 2, dtype=np.uint8).tobytes())


def _ring_since(t0):
    return [r for r in timers.RING if r.end_ns >= t0]


def _read_all(path):
    """read_rgb of a few frames in any order and a block's take_rgb, through
    the port's reader, with the ring's records of those reads."""
    t0 = time.perf_counter_ns()
    r = tio.Y4MReader(str(path))
    rgb = r.read_rgb([6, 0, 3, 3])
    blk = r.read_block([1, 2, 4, 6], 18, 32)
    taken = blk.take_rgb(np.array([3, 0, 2]))
    return rgb, taken, _ring_since(t0)


@pytest.mark.parametrize("limited", [False, True], ids=["full", "limited"])
def test_read_rgb_and_take_rgb_equal_on_both_paths_and_in_the_jax_reader(tmp_path, monkeypatch, limited):
    path = tmp_path / "r.y4m"
    _write_random_y4m(path, 7, 36, 64, limited, seed=7 + limited)
    assert tio.Y4MReader(str(path)).limited_range is limited
    rgb, taken, recs = _read_all(path)
    assert recs  # the native path left its span and counters
    j = jio.Y4MReader(str(path))
    np.testing.assert_array_equal(rgb, j.read_rgb([6, 0, 3, 3]))
    np.testing.assert_array_equal(taken, j.read_rgb([6, 1, 4]))
    monkeypatch.setattr(_native, "resize_lib", lambda: None)
    rgb_np, taken_np, _ = _read_all(path)
    np.testing.assert_array_equal(rgb, rgb_np)
    np.testing.assert_array_equal(taken, taken_np)


def _counts(recs):
    spans = [r for r in recs if r.name == "media.y4m_rgb" and r.n is None]
    total = {name: sum(r.n for r in recs if r.name == name)
             for name in ("media.y4m_rgb_frames", "media.y4m_rgb_native_frames")}
    return len(spans), total["media.y4m_rgb_frames"], total["media.y4m_rgb_native_frames"]


def test_each_read_is_one_span_and_counts_its_frames(tmp_path, monkeypatch):
    """Two reads (read_rgb of 4 frames, take_rgb of 3): two spans, 7 frames,
    all native where the library built; the numpy path counts 0 native."""
    path = tmp_path / "c.y4m"
    _write_random_y4m(path, 7, 36, 64, False, seed=3)
    assert _counts(_read_all(path)[2]) == (2, 7, 7)
    monkeypatch.setattr(_native, "resize_lib", lambda: None)
    recs = _read_all(path)[2]
    assert _counts(recs) == (2, 7, 0)
    assert any(r.name == "media.y4m_rgb_native_frames" and r.n == 0 for r in recs)
