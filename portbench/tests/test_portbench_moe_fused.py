"""The reader of `moe_fused_pct.ingest`: Σ `moe.fused_passes` over Σ
`moe.layer_passes` (each counted once per prefill forward and once per
decode loop) in the traced slice. Exact from a synthetic ring and slice;
None where either counter is absent from the slice, where the ring begins
after the slice, or where the program keeps no ring; and 0 from a traced
run of the Kimi-VL cell on the CPU, which runs the kernels' plain twins."""

from collections import deque

import pytest

from hippomm_tpu_torch.utils import timers
from portbench.run import read_metric
from portbench.tests import test_portbench_spans as base

NAME = "moe_fused_pct.ingest"


def _ring():
    """The spans test's ring, with the MoE counters of a prefill forward and
    a decode loop inside the slice (one loop's fused passes short), and of a
    forward before and after it."""
    recs = list(base._ring()) + [
        base._count("moe.layer_passes", 99.5, 26), base._count("moe.fused_passes", 99.5, 0),
        base._count("moe.layer_passes", 100.5, 26), base._count("moe.fused_passes", 100.5, 26),
        base._count("moe.layer_passes", 101.5, 26 * 127), base._count("moe.fused_passes", 101.5, 26 * 126),
        base._count("moe.layer_passes", 102.5, 26), base._count("moe.fused_passes", 102.5, 0),
    ]
    return deque(sorted(recs, key=lambda r: r.end_ns))


def _read(monkeypatch, ring, trace=base.SLICE):
    monkeypatch.setattr(timers, "RING", ring)
    return read_metric(NAME, {"trace": trace})


def test_reader_exact(monkeypatch):
    assert _read(monkeypatch, _ring()) == 100.0 * (26 + 26 * 126) / (26 + 26 * 127)


@pytest.mark.parametrize("gone", ["moe.layer_passes", "moe.fused_passes"])
def test_reader_none_when_a_counter_is_absent(monkeypatch, gone):
    ring = deque(r for r in _ring() if r.name != gone)
    assert _read(monkeypatch, ring) is None


def test_reader_none_when_the_ring_begins_after_the_slice(monkeypatch):
    late = deque(r for r in _ring() if r.end_ns > int(base.SLICE._t0 * base.S))
    assert _read(monkeypatch, late) is None


def test_reader_none_without_a_ring_or_a_trace(monkeypatch):
    assert _read(monkeypatch, _ring(), trace=None) is None
    monkeypatch.delattr(timers, "RING")
    assert read_metric(NAME, {"trace": base.SLICE}) is None


def test_traced_vlm_run_on_the_cpu_reads_zero():
    """The CPU runs the twins: the tiny Kimi-VL cell's traced call counts
    its MoE layer passes and none fused."""
    from portbench.tests import test_portbench_kimi_vl as kimi

    assert read_metric(NAME, kimi._run(trace=True)) == 0.0
