"""The routed experts' dispatch and combine (ops/moe) on the CPU: each plain
twin (`moe_route_ref`, `moe_permute_ref`, `swiglu_ref`, `moe_combine_ref`,
which the wrappers run for CPU tensors and the card's kernels are held to)
against the inline torch composition that models/kimi_vl computed before
the kernels, at tiny shapes: 1, 7 and 64 rows, 8 experts, k 3, experts that
get no row, tied scores, and a `live` mask with dead and padding rows. The
indices, slots, group ends and counters exactly, the weights and the
combine to 1e-6 relative; the tiny Kimi-VL's MoE layer, with a zero and a
random residual, against portbench/reference/kimi_vl.py; the permute's
launch plan; and the counters of MoE layer passes a generate records."""

import pytest
import torch
import torch.nn.functional as F

from hippomm_tpu_torch.models.kimi_vl import model as km
from hippomm_tpu_torch.ops import moe
from hippomm_tpu_torch.utils import timers
from portbench.reference import kimi_vl as ref

E, K, D, FF = 8, 3, 16, 12
SCALE = 2.446
ROWS = [1, 7, 64]


def _logits(n, seed, tied=False):
    g = torch.Generator().manual_seed(seed)
    if tied:
        # two levels of logit only: σ + a zero bias ties in every row
        return torch.where(torch.rand(n, E, generator=g) < 0.5, -1.0, 1.0), torch.zeros(E)
    bias = 0.1 * torch.randn(E, generator=g)
    bias[E - 2:] = -10.0  # the last two experts never win: groups with no row
    return torch.randn(n, E, generator=g), bias


def _parent_route(logits, bias):
    """models/kimi_vl's `route` after its product, as it was inline."""
    scores = torch.sigmoid(logits)
    idx = torch.topk(scores + bias, K, dim=-1).indices
    wts = scores.gather(1, idx)
    return idx, wts / wts.sum(dim=-1, keepdim=True) * SCALE


def _parent_dispatch(idx, h, live, stats):
    """`KimiVL._moe`'s sort, gather, group ends and counters, as they were."""
    n = h.shape[0]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ranked = flat[order]
    xs = h[order // K]
    ends = torch.searchsorted(ranked, torch.arange(1, E + 1))
    ones = torch.ones_like(flat) if live is None else live[:, None].expand(n, K).reshape(-1).long()
    counts = torch.zeros((E,), dtype=torch.long).index_add_(0, flat, ones)
    stats += torch.stack([(counts > 0).sum(), counts.sum(), counts.max()])
    return order, xs, ends


def _live(n, seed):
    """Dead rows at random, and the last quarter padding."""
    live = torch.rand(n, generator=torch.Generator().manual_seed(seed)) < 0.7
    live[n - n // 4:] = False
    return live


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("n", ROWS)
def test_route_twin_is_the_parents_router(n, tied):
    logits, bias = _logits(n, 10 + n, tied)
    idx, wts = moe.moe_route(logits, bias, K, SCALE)
    want_idx, want_wts = _parent_route(logits, bias)
    assert idx.dtype == torch.int64 and torch.equal(idx, want_idx)
    torch.testing.assert_close(wts, want_wts, rtol=1e-6, atol=0)
    assert torch.allclose(wts.sum(-1), torch.full((n,), SCALE), rtol=1e-6)


@pytest.mark.parametrize("live_mask", [False, True])
@pytest.mark.parametrize("n", ROWS)
def test_permute_twin_is_the_parents_sort(n, live_mask):
    logits, bias = _logits(n, 20 + n)
    idx, _ = _parent_route(logits, bias)
    h = torch.randn(n, D, generator=torch.Generator().manual_seed(n))
    live = _live(n, n) if live_mask else None
    stats, want_stats = torch.full((3,), 5, dtype=torch.long), torch.full((3,), 5, dtype=torch.long)
    xs, slots, offs = moe.moe_permute(idx, h, E, live, stats)
    order, want_xs, ends = _parent_dispatch(idx, h, live, want_stats)
    assert torch.equal(xs, want_xs)
    assert offs.dtype == torch.int32 and torch.equal(offs.long(), ends)
    assert offs[-1] == n * K and offs[-2] == offs[-3]  # the last two experts get no row
    # slots invert the stable sort: route (r, j) sits where the sort put it
    assert slots.dtype == torch.int32 and torch.equal(slots.reshape(-1).long()[order], torch.arange(n * K))
    assert torch.equal(xs[slots.long()], h[:, None].expand(n, K, D))
    assert torch.equal(stats, want_stats)
    counted = n if live is None else int(live.sum())
    assert stats[1] == 5 + counted * K


@pytest.mark.parametrize("f", [FF, 1408 // 32, 7])
@pytest.mark.parametrize("m", [1, 18])
def test_swiglu_twin_is_the_parents_activation(m, f):
    gu = torch.randn(m, 2 * f, generator=torch.Generator().manual_seed(m + f)).to(torch.bfloat16)
    want = (F.silu(gu[:, :f].float()) * gu[:, f:].float()).to(torch.bfloat16)
    assert torch.equal(moe.swiglu(gu), want)
    g32 = gu.float()  # the fp32 model's product: the halves are views of it
    assert torch.equal(moe.swiglu(g32), (F.silu(g32[:, :f].float()) * g32[:, f:].float()).to(torch.float32))


@pytest.mark.parametrize("n", ROWS)
def test_combine_twin_is_the_parents_sum(n):
    g = torch.Generator().manual_seed(30 + n)
    logits, bias = _logits(n, 30 + n)
    idx, wts = _parent_route(logits, bias)
    h = torch.randn(n, D, generator=g)
    order, xs, _ = _parent_dispatch(idx, h, None, torch.zeros(3, dtype=torch.long))
    y = (xs * 0.5 + 0.25).to(torch.bfloat16)
    shared = torch.randn(n, D, generator=g).to(torch.bfloat16)
    x = torch.randn(n, D, generator=g).to(torch.bfloat16)
    _, slots, _ = moe.moe_permute(idx, h, E)
    back = torch.empty_like(y)
    back[order] = y
    routed = (back.reshape(n, K, -1).float() * wts[..., None]).sum(dim=1)
    want = (x.float() + (routed + shared.float())).to(torch.bfloat16)
    torch.testing.assert_close(moe.moe_combine_ref(y, slots, wts), routed, rtol=1e-6, atol=0)
    got = moe.moe_combine(y, slots, wts, shared, x)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-6, atol=0)


def test_permute_plan_adapts_to_the_rows():
    """A decode step is one tile spread over up to 256 blocks of one thread
    a row; a 32 768-token prefill 32 tiles of 1024 rows, 9 blocks each."""
    assert moe._permute_plan(1) == (1, 1, 64)
    assert moe._permute_plan(64) == (1, 64, 64)
    assert moe._permute_plan(256) == (1, 256, 256)
    assert moe._permute_plan(1024) == (1, 264, 1024)
    assert moe._permute_plan(1025) == (2, 132, 1024)
    assert moe._permute_plan(32768) == (32, 9, 1024)


@pytest.fixture(scope="module")
def tiny():
    params = km.init_params(km.get_config("tiny"), seed=3, std=0.1)
    return params, km.KimiVL("tiny", params=params, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("n", [1, 7, 40])
def test_tiny_moe_layer_matches_the_reference(tiny, n):
    """The tiny model's MoE layer through the twins, the residual taken in
    the layer, against the reference's layer plus the residual: a zero one
    (in float32 the layer's sum as it is) and a random one."""
    params, vlm = tiny
    cfg = km.hf_config(vlm.cfg)
    g = torch.Generator().manual_seed(n)
    h, x = torch.randn(n, vlm.cfg.text.hidden, generator=g), torch.randn(n, vlm.cfg.text.hidden, generator=g)
    lw = vlm._w["layers"][1]
    want = ref._moe(ref._mm, cfg, params["layers"][1]["moe"], h)
    tol = 2e-5 * want.abs().max().item()
    assert (vlm._mlp(lw, h, None, None, torch.zeros_like(h)) - want).abs().max().item() < tol
    assert (vlm._mlp(lw, h, None, None, x) - (x + want)).abs().max().item() < tol + 2e-5 * x.abs().max().item()


def test_generate_counts_the_moe_layer_passes(tiny):
    """Once per prefill forward and once per decode loop times its steps,
    times the MoE layers; none fused on the CPU, which runs the twins."""
    _, vlm = tiny
    start = len(timers.RING)
    vlm.generate_ids([list(range(5, 20)), list(range(7, 12))], [[], []], 6)
    recs = list(timers.RING)[start:]
    passes = sum(r.n for r in recs if r.name == "moe.layer_passes")
    loop = vlm.loops[-1]
    layers = vlm.cfg.text.layers - vlm.cfg.text.first_dense
    assert passes == (1 + loop["steps"]) * layers
    assert sum(r.n for r in recs if r.name == "moe.fused_passes") == 0
    assert any(r.name == "moe.fused_passes" for r in recs)


def test_fused_passes_are_the_layers_that_launched_the_combine_kernel(tiny, monkeypatch):
    """`moe.fused_passes` reads the combine kernel's launches: a stand-in
    that counts a launch per call makes every pass fused, in the prefill
    and in each decode step."""
    _, vlm = tiny

    def launching(*args):
        moe.moe_combine.launches += 1
        return moe.moe_combine_ref(*args)

    monkeypatch.setattr(km, "moe_combine", launching)
    start = len(timers.RING)
    vlm.generate_ids([list(range(5, 20))], [[]], 4)
    recs = list(timers.RING)[start:]
    passes = sum(r.n for r in recs if r.name == "moe.layer_passes")
    assert passes > 0 and sum(r.n for r in recs if r.name == "moe.fused_passes") == passes
