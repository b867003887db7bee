"""The operation and byte counts against hand counts at the published
ImageBind-Huge and Whisper distil-large-v3 shapes."""

import math

import pytest

from portbench.harness import work
from portbench.tests import tiny

CFG = tiny.load("configs", "ib_huge-distil_large_v3")


def test_peaks():
    assert work.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 495e12}
    assert work.HBM_BYTES_PER_S == 3.35e12


def test_attention_call_vision_layer():
    c = work.attn_call(32, 16, 257, 257, 80, "bfloat16")
    assert c["flops"] == 4 * 32 * 16 * 257 * 257 * 80  # q·kᵀ and p·v, 2 flops a MAC
    assert c["bytes"] == 2 * 32 * 16 * 80 * (2 * 257 + 2 * 257)
    assert c["bound_s"] == pytest.approx(max(c["flops"] / 989e12, c["bytes"] / 3.35e12))
    # PERF §6's phase-2 bound of this shape: 0.0251 ms, bytes-bound
    assert c["bound_s"] * 1e3 == pytest.approx(0.0251, abs=5e-5)


def test_attention_call_whisper_fp32_is_held_to_tf32():
    c = work.attn_call(4, 20, 1500, 1500, 64, "float32")
    assert c["bound_s"] == pytest.approx(c["flops"] / 495e12)
    assert c["flops"] == 4 * 4 * 20 * 1500 * 1500 * 64


def test_mlp_call_shapes():
    c = work.mlp_call(8224, 1280, 5120, "bfloat16")
    assert c["flops"] == 4 * 8224 * 1280 * 5120
    assert c["bytes"] == 2 * (2 * 8224 * 1280 + 2 * 1280 * 5120) + 4 * (1280 + 5120)
    assert c["bound_s"] * 1e3 == pytest.approx(0.2180, abs=5e-4)  # PERF §6 K2 vision
    t = work.mlp_call(77, 1024, 4096, "bfloat16")
    assert t["bound_s"] * 1e3 == pytest.approx(0.0051, abs=1e-4)  # bytes-bound text row


def test_vision_tower_hand_count():
    d, f, t, layers = 1280, 5120, 257, 32
    per_layer = 2 * t * d * 4 * d + 4 * t * t * d + 4 * t * d * f
    hand = 2 * 256 * d * 3 * 14 * 14 + layers * per_layer + 2 * d * 1024
    assert work.vision_flops(CFG) == hand
    assert hand == pytest.approx(3.33e11, rel=0.02)  # ~0.33 TFLOP an image


def test_audio_clip_hand_count():
    assert work.audio_tokens(CFG) == 12 * 19 + 1
    d, f, t = 768, 3072, 229
    per_layer = 2 * t * d * 4 * d + 4 * t * (t + 1) * d + 4 * t * d * f
    assert work.audio_clip_flops(CFG) == 2 * 228 * d * 256 + 12 * per_layer + 2 * d * 1024


def test_whisper_hand_counts():
    d, s = 1280, 1500
    enc = 2 * 3000 * 128 * 3 * d + 2 * s * d * 3 * d + 32 * (2 * s * d * 4 * d + 4 * s * s * d + 4 * s * d * 5120)
    assert work.whisper_encoder_flops(CFG) == enc
    assert enc == pytest.approx(2.3e12, rel=0.05)  # ~2.3e13 for the 10 chunks of a 300 s track
    p = 200
    per_pos = 2 * (2 * d * 4 * d + 2 * d * 2 * d + 4 * s * d + 4 * d * 5120) + 2 * d * 51866
    dec = 2 * 2 * 2 * s * d * d + p * per_pos + 2 * 2 * d * p * (p + 1)
    assert work.whisper_decode_flops(CFG, p) == dec


def test_mfu_sums_each_precision_over_its_peak():
    assert work.mfu_pct({"bfloat16": 989e12, "float32": 495e12}, 4.0) == pytest.approx(50.0)
    assert math.isnan(work.mfu_pct({"bfloat16": 1.0}, 0.0))
