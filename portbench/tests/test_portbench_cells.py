"""A whole run of an ingest cell at tiny sizes on the CPU: the check
passes on the port as it is, and `correct` comes out false with the timed
path broken underneath, once for each fault the cell can have: a token
altered where it is produced, half of the batch left out, and a step that
returns its state unchanged. (The cells run on one chip: there
is no exchange between chips to leave out.) The controls, the reference
in the next lower precision, fail the cell's limits too."""

import pytest

from portbench.harness import ingest
from portbench.run import judge, read_metric
from portbench.tests import tiny

SEED = 2**31 + 17


def _correct(record):
    rows = judge(record["checks"], tiny.load("limits", record["cell"]))
    return bool(rows) and all(ok for *_, ok in rows) and record["failed"] == 0


def _ingest(cell="ingest-vlog-bf16", base="ib_huge-distil_large_v3", control=False, trace=False):
    cfg = tiny.tiny_config(base)
    if base.startswith("ib_huge-"):
        cfg["imagebind_dtype"] = "bfloat16"  # the control's precision follows the stated one
    rec = ingest.run(tiny.ctx(cfg, tiny.tiny_ingest_traffic(), SEED, 0.5, trace=trace, control=control))
    rec["cell"] = cell
    return rec


def _token_altered(mp):
    from hippomm_tpu_torch.models.whisper import model as whm

    orig = whm._next_logits

    def worst(params, cfg, tokens, pos, *a, **k):
        logits = orig(params, cfg, tokens, pos, *a, **k)
        return -logits if pos == 4 else logits  # the least likely token is emitted

    mp.setattr(whm, "_next_logits", worst)


def _half_batch(mp):
    from hippomm_tpu_torch.models.imagebind import model as ibm

    orig = ibm.vision_forward

    def half(params, images, *a, **k):
        n = images.shape[0]
        out = orig(params, images[: max(1, n // 2)], *a, **k)
        return out.repeat((n + out.shape[0] - 1) // out.shape[0], 1)[:n]

    mp.setattr(ibm, "vision_forward", half)


def _state_unchanged(mp):
    from hippomm_tpu_torch.models import layers as L

    mp.setattr(L, "encoder_block", lambda p, x, *a, **k: x)


def test_ingest_run_is_correct():
    rec = _ingest()
    assert rec["attempted"] == 2 and rec["failed"] == 0
    assert rec["checks"]["counts"]["keyframes"] > 0 and rec["checks"]["counts"]["asr_positions"] > 0
    assert _correct(rec)


def test_traced_run_reads_each_host_layer():
    """Each layer's seconds, the towers' with their stream's worker, and the
    vision rows counted as the run launched them (the rooflines and the idle
    share need a card's trace)."""
    rec = _ingest(trace=True)
    for name in ("extract_s_per_min", "engine_s_per_min", "encode_s_per_min", "transcribe_s_per_min",
                 "mfu"):
        assert read_metric(name + ".ingest", rec) > 0, name
    assert rec["work"]["vision_rows"] >= rec["checks"]["counts"]["keyframes"] > 0
    assert _correct(rec)


@pytest.mark.parametrize("fault", [_token_altered, _half_batch, _state_unchanged])
def test_ingest_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    assert not _correct(_ingest())


@pytest.mark.parametrize("cell,base", [
    ("ingest-vlog-bf16", "ib_huge-distil_large_v3"),
    ("ingest-fastcut-fp32", "ib_huge_fp32-distil_large_v3"),
])
def test_ingest_control_fails(cell, base):
    rec = _ingest(cell, base, control=True)
    rec["checks"] = {"program": rec["checks"]["control"]}
    assert not _correct(rec)

