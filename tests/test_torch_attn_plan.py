"""The K1/K4 kernel's tile plan (ops/flash_attention._attn_plan), checked on
the CPU at the path shapes and the routing gate's edges: the kernel takes
its tiles from this plan, so a plan that leaves a key, a query row or an hd
column out would show only on the card."""

import pytest
import torch

from hippomm_tpu_torch.ops import flash_attention as tfa


def _cover(tiles, n):
    """The tiles' [start, start + length) clipped to [0, n): each index once."""
    seen = [0] * n
    for start, length in tiles:
        for i in range(start, min(start + length, n)):
            seen[i] += 1
    return seen == [1] * n and all(start < n for start, _ in tiles)


@pytest.mark.parametrize(
    "b,h,tq,tk,hd",
    # vision, audio, the Whisper encoder; a short ragged one and hd 40
    # (padded to 48); the smallest shape and the gate's largest
    [(32, 16, 257, 257, 80), (96, 12, 229, 230, 64), (4, 20, 1500, 1500, 64), (2, 3, 33, 40, 48),
     (2, 3, 33, 40, 40), (1, 1, 1, 1, 16), (1, 1, 2048, 2048, 128)],
)
def test_attn_plan_covers_the_shape(b, h, tq, tk, hd):
    assert tfa.flash_supported(tq, tk, hd)
    plan = tfa._attn_plan(tq, tk, hd)
    assert _cover(plan.key_tiles, tk)
    assert all(w % 16 == 0 and 16 <= w <= 256 for _, w in plan.key_tiles)
    # the C entry points' form: n_full tiles of 128, then one of 16 if tail
    assert [w for _, w in plan.key_tiles] == [128] * plan.n_full + [16] * plan.tail
    assert [s for s, _ in plan.key_tiles] == [128 * j for j in range(len(plan.key_tiles))]
    assert _cover(plan.q_tiles, tq)
    # hd panels: 64-column panels, then the rest; each stored at a swizzle
    # width (16, 32 or 64 columns) that holds its columns
    assert plan.hd_padded % 16 == 0 and hd <= plan.hd_padded < hd + 16
    assert _cover([(c, n) for c, n, _ in plan.panels], plan.hd_padded)
    assert all(n <= w and w in (16, 32, 64) for _, n, w in plan.panels)
    assert all(n == 64 for _, n, _ in plan.panels[:-1])


# the fp32 kernel's path shapes (B, H, Tq, Tk, hd): vision, audio, the
# Whisper encoder, the training step's vision tower, phase 11's and 12's
# shards (GPipe's q 258 against k/v 257), the text tower (77 tokens, hd 64)
# and the tiny towers' hd 16; hd 40 and the gate's largest; short key tiles
# (Tk 8, 9 at hd 80 and 128; 41)
_F32_SHAPES = [(32, 16, 257, 257, 80), (96, 12, 229, 230, 64), (4, 20, 1500, 1500, 64),
               (16, 16, 257, 257, 80), (8, 16, 257, 257, 80), (24, 12, 229, 230, 64),
               (1, 20, 1500, 1500, 64), (8, 8, 257, 257, 80), (8, 8, 258, 257, 80),
               (8, 16, 77, 77, 64), (2, 4, 50, 50, 16), (2, 3, 33, 40, 40), (1, 1, 1, 1, 1),
               (1, 1, 2048, 2048, 128), (1, 2, 5, 8, 80), (1, 2, 5, 9, 80), (1, 2, 5, 8, 128),
               (1, 2, 5, 9, 128), (1, 2, 5, 41, 64)]


@pytest.mark.parametrize("b,h,tq,tk,hd", _F32_SHAPES)
def test_attn_plan_f32_covers_the_shape(b, h, tq, tk, hd):
    """The fp32 kernel's plan (csrc/flash_mha_f32.cu): 128-row query tiles
    and key tiles of 32 keys (16 past hd 80, where shared memory holds
    fewer) that cover each row and key once, none starting past the end
    (what the C entry point checks), and hd within the template instance's
    16·nc columns."""
    assert tfa.flash_supported(tq, tk, hd)
    plan = tfa._attn_plan_f32(tq, tk, hd)
    assert _cover(plan.q_tiles, tq) and _cover(plan.key_tiles, tk)
    assert plan.key_tile == (32 if hd <= 80 else 16)
    assert all(n == 128 for _, n in plan.q_tiles)
    kt = plan.key_tile
    assert all(n == kt for _, n in plan.key_tiles)
    assert [s for s, _ in plan.key_tiles] == [kt * j for j in range(len(plan.key_tiles))]
    assert (len(plan.q_tiles) - 1) * 128 < tq <= len(plan.q_tiles) * 128
    assert (len(plan.key_tiles) - 1) * kt < tk <= len(plan.key_tiles) * kt
    assert 1 <= plan.nc <= 8 and 16 * (plan.nc - 1) < hd <= 16 * plan.nc


def _packed(b, t, h, hd, which):
    """q (0), k (1) or v (2) of one packed (B, T, 3·H·hd) projection, as the
    (B, T, H, hd) view K4 reads: row stride 3·H·hd, at which·H·hd elements."""
    d = h * hd
    return torch.zeros((b, t, 3 * d))[..., which * d:(which + 1) * d].reshape(b, t, h, hd)


@pytest.mark.parametrize(
    "make,ready",
    # K1's contiguous (B, H, T, hd) at the path's hd and at hd 40; K4's
    # packed slices (q, k and v at d·4-byte offsets); then what TMA cannot
    # read: a row or head stride of 30 floats, a start one element into the
    # buffer, an hd axis that is not contiguous
    [(lambda: torch.zeros((2, 3, 33, 80)), True), (lambda: torch.zeros((2, 3, 33, 40)), True),
     (lambda: _packed(2, 17, 16, 80, 0), True), (lambda: _packed(2, 17, 16, 80, 2), True),
     (lambda: _packed(2, 17, 4, 64, 1), True), (lambda: torch.zeros((2, 3, 33, 30)), False),
     (lambda: _packed(2, 17, 3, 30, 1), False), (lambda: torch.zeros(2 * 3 * 33 * 80 + 1)[1:].view(2, 3, 33, 80), False),
     (lambda: torch.zeros((2, 3, 80, 33)).transpose(2, 3), False)],
)
def test_f32_kernel_reads_tma_ready_operands_in_place(make, ready):
    """The fp32 wrapper hands the kernel q, k and v as they are where TMA
    takes their strides and start (every stride a multiple of 16 bytes, the
    hd axis contiguous, a 16-byte aligned start), and a padded copy
    otherwise (`_flash_f32`)."""
    assert tfa._tma_ready(make()) is ready
