"""The arithmetic of the fp32 K2/K3 kernels (csrc/fused_mlp_f32.cu), emulated
in numpy: each fp32 operand v is split into hi = tf32(v) and lo = tf32(v −
hi) with the kernel's `cvt.rna.tf32.f32` (round to nearest, ties away from
zero: add 0x1000 to the bit pattern and clear its low 13 bits), and a·b is
taken as a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, accumulated in fp32 k8 groups
into a partial sum that is added to the tile's fp32 sum every 256 of K.
On the card the kernels are held to the plain fp32 version within 5e-5 of
max |out| (tests/test_torch_cuda.py, chip_smoke.py phase 2); here the
emulated products are held ten times inside that gate.
"""

import numpy as np
import pytest

CARD_GATE = 5e-5  # the card's gate, of max |out|
GATE = CARD_GATE / 10
K8, PROMOTE = 8, 256  # a wgmma's K, and the K a partial accumulator sums


def tf32_rna(v: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on fp32 values: bit arithmetic on the int32 view."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(v: np.ndarray):
    hi = tf32_rna(v)
    return hi, tf32_rna(np.float32(v) - hi)


def products_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (K,) · b (N, K)ᵀ as the kernel takes it: the three products of
    TF32 parts (exact in fp32: 11 × 11 significant bits), each k8 group's
    sum rounded to fp32 and added to an fp32 partial, the partial added to
    the fp32 result every PROMOTE of K."""
    (ah, al), (bh, bl) = split(a), split(b)
    terms = (ah.astype(np.float64) * bh + ah.astype(np.float64) * bl + al.astype(np.float64) * bh)
    k = a.shape[0]
    groups = terms.reshape(b.shape[0], k // K8, K8).sum(-1).astype(np.float32)  # (N, K / 8)
    out = np.zeros(b.shape[0], np.float32)
    for c0 in range(0, k // K8, PROMOTE // K8):
        part = np.zeros(b.shape[0], np.float32)
        for g in range(c0, c0 + PROMOTE // K8):
            part = part + groups[:, g]
        out = out + part
    return out


def _values(seed: int, n: int) -> np.ndarray:
    """Seeded fp32 values over many binades, both signs."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 10.0 ** rng.uniform(-20, 20, n)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hi_has_its_low_13_bits_clear(seed):
    v = _values(seed, 100_000)
    hi, lo = split(v)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (lo.view(np.uint32) & np.uint32(0x1FFF)).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hi_plus_lo_is_v_to_2_pow_minus_22(seed):
    v = _values(seed, 100_000)
    hi, lo = split(v)
    err = np.abs(v.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(v.astype(np.float64))).all()


def test_rna_rounds_ties_away_from_zero():
    one = np.float32(1.0).view(np.uint32)
    tie = np.array([one + 0x1000, one + 0x0FFF, one + 0x1001], np.uint32).view(np.float32)
    got = tf32_rna(np.concatenate([tie, -tie])).view(np.uint32) & np.uint32(0x7FFFFFFF)
    assert got.tolist() == [one + 0x2000, one, one + 0x2000] * 2


@pytest.mark.parametrize("seed", [0, 1])
def test_three_products_at_k_5120_are_fp32_grade(seed):
    """One row of the vision tower's fc2 (K 5120: a GELU hidden row against
    W2 (1280, 5120) at the init's scale): the emulated 3×TF32 result within
    GATE of max |out| of the float64 product, where the TF32 product alone
    is past the card's gate."""
    rng = np.random.default_rng(seed)
    pre = rng.standard_normal(5120)
    a = (0.5 * pre * (1.0 + np.tanh(0.7978845608 * (pre + 0.044715 * pre ** 3)))).astype(np.float32)
    b = (rng.standard_normal((1280, 5120)) / np.sqrt(5120)).astype(np.float32)
    want = b.astype(np.float64) @ a.astype(np.float64)
    scale = np.abs(want).max()
    got = products_3xtf32(a, b)
    assert np.abs(got - want).max() <= GATE * scale
    tf32_only = tf32_rna(b).astype(np.float64) @ tf32_rna(a).astype(np.float64)
    assert np.abs(tf32_only - want).max() > CARD_GATE * scale
