"""The arithmetic of the fp32 K1/K4 kernel (csrc/flash_mha_f32.cu), emulated
in numpy on the CPU.

The kernel takes both of attention's products on the tensor cores as
3×TF32: each fp32 operand v is split into hi = tf32(v) and lo = tf32(v − hi)
with cvt.rna (tests/test_torch_tf32_split.py holds the split), and a·b is
taken as a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, one wgmma k8 step each:
  * S = Q·Kᵀ per key tile (the plan's: 32 keys, 16 past hd 80): Q_hi·K_hi,
    Q_hi·K_lo
    and Q_lo·K_hi each into a fresh accumulator of its own (the first two
    are one product against K_hi and K_lo stacked), added on the CUDA cores
    (one accumulator for all three truncates each cross product's sum at the
    magnitude of S: at sharp logits that costs more than fp32 rounding
    does);
  * the online softmax in fp32 on the CUDA cores, in base 2: p = exp2(s·c −
    m·c) with c = scale·log2 e (one FFMA), the row max m and sum l carried
    across key tiles, the output rescaled by exp2((m_old − m_new)·c);
  * O += P·V with P split in registers, V split and written transposed (Vᵀ:
    tf32 wgmma has no transpose, so the keys must be contiguous) in the key
    order (0, 2, 4, 6, 1, 3, 5, 7) within each group of 8, so that the S
    accumulator's registers are the A fragment of the P·V product as they
    stand; one accumulator across all key tiles (no partial sum);
  * the output divided by l at the end (the TPU kernel's `defer_div`).
A wgmma k8 step is modelled pessimistically: the 8 exact products (TF32 ×
TF32 is exact in fp32) and the accumulator aligned to the largest of them,
each truncated to 24 bits there, summed, and the sum truncated to fp32.
On the card the kernel is held to the plain fp32 version within 5e-5 abs
(tests/test_torch_cuda.py, chip_smoke.py phase 2); here the emulation is
held to float64 attention ten times inside that gate, at the path shapes.
"""

import numpy as np
import pytest

from hippomm_tpu_torch.ops import flash_attention as tfa
from test_torch_tf32_split import split, tf32_rna

CARD_GATE = 5e-5  # max abs, as on the card
GATE = CARD_GATE / 10
LOG2E = 1.4426950408889634
# The A fragment of a tf32 wgmma k8 step holds, in lane l of a warp, the
# columns k = l % 4 (registers a0, a1) and k = l % 4 + 4 (a2, a3) of rows
# l / 4 (a0, a2) and l / 4 + 8 (a1, a3); the fp32 accumulator holds columns
# 2(l % 4) and 2(l % 4) + 1 of each 8-column group, rows l / 4 (d0, d1) and
# l / 4 + 8 (d2, d3). The kernel passes (d0, d2, d1, d3) as (a0, a1, a2, a3),
# so fragment column k carries key KEY_OF_K[k] of its group of 8 ...
KEY_OF_K = np.array([0, 2, 4, 6, 1, 3, 5, 7])
A_FROM_ACC = (0, 2, 1, 3)


def k_of_key(key):
    """... and the V split writes key κ of a group to Vᵀ column (κ >> 1) +
    4·(κ & 1), the kernel's formula."""
    return (key >> 1) + 4 * (key & 1)


def test_key_permutation_maps_the_accumulator_onto_the_a_fragment():
    """Index test: for every lane of a warp and every register of a k8
    step, the accumulator element the kernel passes as A-fragment register
    i sits at the fragment's row, and its key is the one that fragment
    column's Vᵀ row holds."""
    assert sorted(KEY_OF_K) == list(range(8))
    assert [k_of_key(KEY_OF_K[k]) for k in range(8)] == list(range(8))
    for j in range(4):  # k8 steps of a 32-key tile
        for lane in range(32):
            g, t = lane // 4, lane % 4
            # accumulator register 4j + 2h + e: row g + 8h, key 8j + 2t + e
            acc = {2 * h + e: (g + 8 * h, 8 * j + 2 * t + e) for h in (0, 1) for e in (0, 1)}
            # A-fragment register i: row, column k of the step
            frag = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
            for i, (row, k) in enumerate(frag):
                a_row, a_key = acc[A_FROM_ACC[i]]
                assert a_row == row
                assert a_key == 8 * j + KEY_OF_K[k]
                assert k_of_key(a_key % 8) == k  # where the V split put that key


def _rz32(x):
    """float64 → float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma_k8(acc, a, b):
    """acc (M, N) fp32 plus a (M, 8) · b (8, N) of TF32 values as one wgmma
    k8 step: the products exact, aligned with acc to the largest magnitude
    among them, each truncated to 24 bits there, summed; the sum truncated
    to fp32."""
    terms = np.concatenate(
        [acc[..., None].astype(np.float64), a.astype(np.float64)[:, None, :] * b.T.astype(np.float64)[None]], -1)
    big = np.abs(terms).max(-1, keepdims=True)
    quantum = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 23)
    return _rz32((np.trunc(terms / quantum) * quantum).sum(-1))


def _fma32(a, b, c):
    return (a.astype(np.float64) * np.float64(b) + c.astype(np.float64)).astype(np.float32)


def _emulated_head(q, k, v, scale, key_tiles):
    """One head, q (Tq, hd) against k/v (Tk, hd), fp32 in and out, as the
    kernel computes it over the plan's key tiles ((start, keys) each)."""
    tq, hd = q.shape
    tk = k.shape[0]
    hdp = 16 * -(-hd // 16)
    end = key_tiles[-1][0] + key_tiles[-1][1]

    def padded(x, rows):
        out = np.zeros((rows, hdp), np.float32)
        out[: x.shape[0], :hd] = x
        return out

    qh, ql = split(padded(q, tq))
    kp, vp = padded(k, end), padded(v, end)
    c = np.float32(scale * LOG2E)
    m = np.full(tq, -np.inf, np.float32)
    l = np.zeros(tq, np.float32)
    o = np.zeros((tq, hdp), np.float32)
    for k0, kt in key_tiles:
        kh, kl = split(kp[k0:k0 + kt])
        hh, hl, lh = (np.zeros((tq, kt), np.float32) for _ in range(3))
        for c8 in range(hdp // 8):
            cols = slice(8 * c8, 8 * c8 + 8)
            hh = _mma_k8(hh, qh[:, cols], kh[:, cols].T)
            hl = _mma_k8(hl, qh[:, cols], kl[:, cols].T)
            lh = _mma_k8(lh, ql[:, cols], kh[:, cols].T)
        s = np.where(k0 + np.arange(kt) < tk, hh + (hl + lh), np.float32(-np.inf))
        m_new = np.maximum(m, s.max(1))
        alpha = np.exp2((m - m_new) * c)
        p = np.exp2(_fma32(s, c, -(m_new * c)[:, None]))
        l = l * alpha + p.sum(1, dtype=np.float32)
        o = o * alpha[:, None]
        ph, pl = split(p)
        vh, vl = split(vp[k0:k0 + kt])
        for c8 in range(kt // 8):
            keys = 8 * c8 + KEY_OF_K  # fragment column k carries key KEY_OF_K[k]
            o = _mma_k8(o, ph[:, keys], vh[keys])
            o = _mma_k8(o, ph[:, keys], vl[keys])
            o = _mma_k8(o, pl[:, keys], vh[keys])
        m = m_new
    return (o * (np.float32(1) / l)[:, None])[:, :hd]


def _reference(q, k, v, scale):
    logits = q.astype(np.float64) @ k.astype(np.float64).T * scale
    w = np.exp(logits - logits.max(1, keepdims=True))
    return (w / w.sum(1, keepdims=True)) @ v.astype(np.float64)


@pytest.mark.parametrize(
    "tq,tk,hd,heads,rows",
    # vision (257 × 257, hd 80) and audio (229 × 230, hd 64), a few heads
    # each; the Whisper encoder's 1500 keys (hd 64, the longest sum into
    # one accumulator) on its first and last 64 query rows; hd 128 (key
    # tiles of 16)
    [(257, 257, 80, 3, None), (229, 230, 64, 3, None), (1500, 1500, 64, 1, 64), (70, 65, 128, 2, None)],
)
def test_emulated_kernel_is_fp32_grade(tq, tk, hd, heads, rows):
    rng = np.random.default_rng(tq + tk + hd)
    scale = hd ** -0.5
    tiles = tfa._attn_plan_f32(tq, tk, hd).key_tiles
    worst = 0.0
    for _ in range(heads):
        q, k, v = (rng.standard_normal((t, hd)).astype(np.float32) for t in (tq, tk, tk))
        if rows is not None:
            q = np.concatenate([q[:rows], q[-rows:]])
        got = _emulated_head(q, k, v, scale, tiles)
        worst = max(worst, float(np.abs(got - _reference(q, k, v, scale)).max()))
    assert worst <= GATE, worst


def test_sharp_softmax_is_as_close_as_fp32():
    """Inputs ×3 and keys sorted by their dot with the queries' common
    direction, so that each key tile raises the row max and the rescale of
    O carries the result. Logits reach |S| ~ 240, where fp32 attention itself
    (numpy's fp32 products) is ~6e-6 from float64: the emulation is held
    within twice that error (one S accumulator for all three products is
    ~2.5 times it)."""
    rng = np.random.default_rng(5)
    tq, tk, hd = 64, 257, 80
    base = rng.standard_normal(hd)
    q = (3 * (base + 0.1 * rng.standard_normal((tq, hd)))).astype(np.float32)
    k = 3 * rng.standard_normal((tk, hd))
    k = k[np.argsort(k @ base)].astype(np.float32)
    v = rng.standard_normal((tk, hd)).astype(np.float32)
    scale = hd ** -0.5
    want = _reference(q, k, v, scale)
    logits = (q @ k.T) * np.float32(scale)
    w = np.exp(logits - logits.max(1, keepdims=True))
    fp32_err = np.abs((w / w.sum(1, keepdims=True)) @ v - want).max()
    got = _emulated_head(q, k, v, scale, tfa._attn_plan_f32(tq, tk, hd).key_tiles)
    assert np.abs(got - want).max() <= 2 * fp32_err


def test_one_tf32_product_fails_the_card_gate():
    """The split is what the gate needs: S and P·V from TF32 operands alone
    are past it at the vision shape."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((257, 80)).astype(np.float32) for _ in range(3))
    scale = 80 ** -0.5
    logits = tf32_rna(q).astype(np.float64) @ tf32_rna(k).astype(np.float64).T * scale
    w = np.exp(logits - logits.max(1, keepdims=True))
    w = tf32_rna((w / w.sum(1, keepdims=True)).astype(np.float32)).astype(np.float64)
    tf32_only = w @ tf32_rna(v).astype(np.float64)
    assert np.abs(tf32_only - _reference(q, k, v, scale)).max() > CARD_GATE
