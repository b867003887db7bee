"""The Kimi-VL cell (`harness/ingest_vlm.py`) at tiny sizes on the CPU: the
check passes on the port as it is and comes out false with the VLM broken
underneath (an expert's output dropped, the router's correction bias
ignored, MoonViT's RoPE left out, the decode's cache position off by one);
the fp8 control fails the cell's limits; the VLM's metric readers read
exact numbers from a synthetic ring and each reads a traced run; a traced
window of the cell fills at most half the ring; the traffic is fast-cut's;
the benchmark's reference is the port's reference, file for file."""

import copy
import filecmp
import math
import os
from collections import deque
from types import SimpleNamespace

import pytest
import torch

from hippomm_tpu_torch.models.kimi_vl import model as km
from hippomm_tpu_torch.models.kimi_vl.config import get_config
from hippomm_tpu_torch.models.kimi_vl.tokenizer import StandInTokenizer
from hippomm_tpu_torch.utils import timers
from portbench.harness import ingest_vlm, work_vlm
from portbench.run import REPO, judge, read_metric
from portbench.tests import tiny

SEED = 2**31 + 29
CELL = "ingest-fastcut-kimivl-bf16"
METRICS = ("vlm_s_per_min.ingest", "vlm_step_ms.ingest", "vlm_decode_roofline_pct.ingest",
           "vlm_useful_rows_pct.ingest", "moe_balance_pct.ingest")


def tiny_vlm_config() -> dict:
    """The cell's configuration with the port's tiny ImageBind, Whisper and
    Kimi-VL. Weights at 0.5 (the file's 0.02 at width 2048): at width 64
    and three layers the published scale leaves attention near uniform and
    the layers' outputs small, so a dropped expert or a shifted position
    barely moves a logit; at 0.5 each fault moves the logits by as much as
    the fp8 control does (limits are in logits, as at full size)."""
    cfg = tiny.tiny_config("ib_huge-distil_large_v3-kimi_vl_a3b")
    pc = get_config("tiny")
    cfg.update(copy.deepcopy(km.hf_config(pc)))
    cfg.update(vlm_variant="tiny", vlm_dtype="float32", initializer_range=0.5)
    cfg["tokenizer"] = {"n_special": pc.n_special,
                        "special_ids": StandInTokenizer(pc.text.vocab_size, pc.n_special).special}
    cfg["vlm_generation"]["cache_slots"] = pc.cache_slots
    return cfg


def tiny_traffic() -> dict:
    t = tiny.load("traffic", "fastcut_kimivl")
    t.update(duration_s=20, cut_every_s=4, silence_first_s=10, silence_every_s=60)
    return t


def _run(control=False, trace=False):
    rec = ingest_vlm.run(tiny.ctx(tiny_vlm_config(), tiny_traffic(), SEED, 0.0, trace=trace, control=control))
    return rec


def _correct(checks, failed=0):
    rows = judge(checks, tiny.load("limits", CELL))
    return bool(rows) and all(ok for *_, ok in rows) and failed == 0


@pytest.fixture(scope="module")
def traced():
    """A traced run and the ring's records of its traced call."""
    rec = _run(trace=True)
    lo = round(rec["trace"]._t0 * 1e9)
    hi = lo + round(rec["trace"].window_s * 1e9)
    return rec, [r for r in timers.RING if lo <= r.end_ns <= hi]


def test_vlm_cell_is_correct(traced):
    rec = traced[0]
    c = rec["checks"]["counts"]
    assert rec["attempted"] == 2 and rec["failed"] == 0
    assert c["vlm_caption_rows"] > 0 and c["vlm_caption_positions"] > 0 and c["vlm_summary_positions"] > 0
    assert c["vlm_frames"] == c["vlm_caption_rows"]
    assert set(tiny.load("limits", CELL)) == set(rec["checks"]["program"])
    assert _correct(rec["checks"], rec["failed"])


def _expert_dropped(mp):
    orig = km.KimiVL._prepare

    def prep(self, p):
        w = orig(self, p)
        for lw in w["layers"]:
            if "moe" in lw:
                lw["moe"]["down"] = lw["moe"]["down"].clone()
                lw["moe"]["down"][0] = 0.0
        return w

    mp.setattr(km.KimiVL, "_prepare", prep)


def _bias_ignored(mp):
    orig = km.KimiVL._prepare

    def prep(self, p):
        w = orig(self, p)
        for lw in w["layers"]:
            if "moe" in lw:
                lw["moe"]["bias"] = torch.zeros_like(lw["moe"]["bias"])
        return w

    mp.setattr(km.KimiVL, "_prepare", prep)


def _vit_rope_off(mp):
    orig = km.KimiVL._vit

    def vit(self, pixels):
        rot = km._rotate_pairs
        km._rotate_pairs = lambda x, cis: x
        try:
            return orig(self, pixels)
        finally:
            km._rotate_pairs = rot

    mp.setattr(km.KimiVL, "_vit", vit)


def _cache_position_off(mp):
    orig = km.KimiVL.decode_logits
    mp.setattr(km.KimiVL, "decode_logits", lambda self, tokens, pos, *a, **k: orig(self, tokens, pos + 1, *a, **k))


@pytest.mark.parametrize("fault", [_expert_dropped, _bias_ignored, _vit_rope_off, _cache_position_off])
def test_vlm_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    rec = _run()
    assert not _correct(rec["checks"], rec["failed"])


def test_vlm_control_fails():
    rec = _run(control=True)
    vlm_only = {k: v for k, v in rec["checks"]["control"].items() if k.startswith("vlm_")}
    assert not _correct({"program": vlm_only})


def test_traced_vlm_run_reads_each_vlm_metric(traced):
    rec = traced[0]
    got = {name: read_metric(name, rec) for name in METRICS}
    assert got["vlm_s_per_min.ingest"] > 0 and got["vlm_step_ms.ingest"] > 0
    assert 0 < got["vlm_decode_roofline_pct.ingest"] < 100
    assert 0 < got["vlm_useful_rows_pct.ingest"] <= 100
    assert 0 < got["moe_balance_pct.ingest"] <= 100
    assert rec["layer"]["engine_s"] > 0 and rec["work"]["flops"]["bfloat16"] > 0


S = 1_000_000_000


def _span(name, a, b):
    return timers.Record(name, int(a * S), int(b * S), 1, None, "v")


def _count(name, t, n):
    return timers.Record(name, int(t * S), int(t * S), 1, None, "v", n)


def test_vlm_readers_exact(monkeypatch):
    ring = deque([
        _count("vlm.rows_launched", 99.0, 256),  # before the slice
        _span("vlm.decode_step", 100.0, 100.25), _span("vlm.decode_step", 100.25, 100.5),
        _span("vlm.decode", 100.0, 100.75), _count("vlm.rows_launched", 100.75, 512),
        _count("vlm.rows_real", 100.75, 480), _count("moe.rows_routed", 100.75, 6000),
        _count("moe.rows_busiest", 100.75, 250),
    ])
    monkeypatch.setattr(timers, "RING", ring)
    rec = {"trace": SimpleNamespace(_t0=100.0, window_s=2.0), "work": {"vlm_decode_bound_s": 0.25},
           "vlm": {"experts": 64}, "layer": {"vlm_s": 3.5}}
    assert read_metric("vlm_step_ms.ingest", rec) == 1000.0 * 0.75 / 2
    assert read_metric("vlm_decode_roofline_pct.ingest", rec) == 100.0 * 0.25 / 0.75
    assert read_metric("vlm_useful_rows_pct.ingest", rec) == 100.0 * 480 / 512
    assert read_metric("moe_balance_pct.ingest", rec) == 100.0 * 6000 / (64 * 250)
    assert read_metric("vlm_s_per_min.ingest", rec) == 3.5
    # an older program keeps none of these names: every reader gives None
    monkeypatch.setattr(timers, "RING", deque([_span("asr.decode_step", 100.0, 100.5)]))
    assert all(read_metric(n, {**rec, "layer": {}}) is None for n in METRICS)


def test_ring_holds_a_traced_window_of_the_vlm_cell(traced):
    """Records per VLM decode position (its span and what lies inside it)
    and the rest per second of video, from the tiny traced call; the cell's
    call decodes 127 caption and 127 summary positions a video (random
    weights never end a caption), and its window at four times the fastest
    it has run (PERF.md §5) must fill at most half the ring."""
    _, recs = traced
    steps = [r for r in recs if r.name == "vlm.decode_step" and r.n is None]
    in_steps = sum(1 for r in recs for s in steps
                   if r.thread == s.thread and s.start_ns <= r.start_ns and r.end_ns <= s.end_ns)
    per_step = in_steps / len(steps)
    small = tiny_traffic()
    per_second = (len(recs) - in_steps) / (small["videos_per_folder"] * small["duration_s"])
    traffic = tiny.load("traffic", "fastcut_kimivl")
    per_call = traffic["videos_per_folder"] * (per_step * 2 * 127 + per_second * traffic["duration_s"])
    media_s = traffic["videos_per_folder"] * traffic["duration_s"]
    fastest = 4 * 30.0
    calls = math.ceil(51 * fastest / media_s) + 1
    assert calls * per_call < timers.RING_SIZE / 2, (calls, per_call)


def test_dedup_gate_is_the_configurations():
    """The cell's engine runs the consolidation at the configuration's gate,
    and the check holds the dedup to that gate, not to the default 0.9."""
    from portbench.harness import check

    cfg = tiny.load("configs", "ib_huge-distil_large_v3-kimi_vl_a3b")
    assert ingest_vlm.vlm_port_config(cfg, "").processing.keyframe_dedup_threshold == cfg["keyframe_dedup_threshold"]
    ref = torch.tensor([[1.0, 0.0], [0.95, (1 - 0.95 ** 2) ** 0.5]])  # cosine 0.95
    assert check.dedup_faults(ref, [0, 1], 0.9, 0.0) == 1
    with ingest_vlm.dedup_gate(0.999):
        assert check.dedup_faults(ref, [0, 1], 0.9, 0.0) == 0
        assert check.dedup_faults(ref, [0], 0.9, 0.0) == 1
    assert check.dedup_faults(ref, [0, 1], 0.9, 0.0) == 1


def test_fastcut_kimivl_is_fastcuts_traffic():
    a, b = tiny.load("traffic", "fastcut"), tiny.load("traffic", "fastcut_kimivl")
    assert b.pop("driver") == "ingest_vlm" and a.pop("driver") == "ingest"
    a.pop("about"), b.pop("about")
    assert a == b


def test_benchmark_reference_is_the_ports():
    assert filecmp.cmp(os.path.join(REPO, "portbench", "reference", "kimi_vl.py"),
                       os.path.join(REPO, "hippomm_tpu_torch", "models", "kimi_vl", "reference.py"), shallow=False)


def test_config_file_matches_the_ports_variant():
    ingest_vlm.check_vlm_config(tiny.load("configs", "ib_huge-distil_large_v3-kimi_vl_a3b"))
    ingest_vlm.check_vlm_config(tiny_vlm_config())


def test_decode_step_bytes_at_full_size():
    """A 240-row caption step with every expert hit reads the whole model
    but the ViT and the token table (~30 GB) and the latent cache."""
    cfg = tiny.load("configs", "ib_huge-distil_large_v3-kimi_vl_a3b")
    experts = 26 * 64
    weights = work_vlm.step_weight_bytes(cfg) + experts * work_vlm.expert_bytes(cfg)
    assert 29e9 < weights < 32e9
    loop = {"rows": 256, "real": 240, "lengths": [317] * 240, "decoded": [2] * 240, "steps": 1,
            "experts_hit": experts}
    bound = work_vlm.decode_loop(cfg, loop)["bound_s"]
    cache = 240 * 318 * work_vlm.latent_bytes(cfg)
    assert bound == pytest.approx((weights + cache + 4.0 * 240 * cfg["vocab_size"]) / 3.35e12)
