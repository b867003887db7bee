"""The reader of `asr_graph_steps_pct.ingest`: Σ `asr.graph_steps` (counted
once per decode loop) over the `asr.decode_step` spans in the traced slice.
Exact from a synthetic ring and slice, None where the ring begins after the
slice, where either name is absent from it, or where the program keeps no
ring; and None from a traced ingest run on the CPU, which decodes eagerly
and counts no graph steps."""

from collections import deque

import pytest

from hippomm_tpu_torch.utils import timers
from portbench.run import read_metric
from portbench.tests import test_portbench_spans as base

NAME = "asr_graph_steps_pct.ingest"


def _ring():
    """The spans test's ring, with the graph steps of its decode loops: the
    two steps inside the slice replayed as one loop, the one after it
    counted after the slice."""
    recs = list(base._ring()) + [base._count("asr.graph_steps", 101.0, 2),
                                 base._count("asr.graph_steps", 103.0, 1)]
    return deque(sorted(recs, key=lambda r: r.end_ns))


def _read(monkeypatch, ring, trace=base.SLICE):
    monkeypatch.setattr(timers, "RING", ring)
    return read_metric(NAME, {"trace": trace})


def test_reader_exact(monkeypatch):
    assert _read(monkeypatch, _ring()) == 100.0 * 2 / 2


def test_reader_none_when_the_ring_begins_after_the_slice(monkeypatch):
    late = deque(r for r in _ring() if r.end_ns > int(base.SLICE._t0 * base.S))
    assert _read(monkeypatch, late) is None


@pytest.mark.parametrize("gone", ["asr.graph_steps", "asr.decode_step"])
def test_reader_none_when_its_name_is_absent(monkeypatch, gone):
    ring = deque(r for r in _ring() if r.name != gone or r.end_ns < int(base.SLICE._t0 * base.S))
    assert _read(monkeypatch, ring) is None


def test_reader_none_without_a_ring_or_a_trace(monkeypatch):
    assert _read(monkeypatch, _ring(), trace=None) is None
    monkeypatch.delattr(timers, "RING")
    assert read_metric(NAME, {"trace": base.SLICE}) is None


def test_traced_ingest_on_the_cpu_reads_none():
    """The CPU decodes eagerly: the traced tiny ingest records decode steps
    and no graph steps, so the metric is left out of the line."""
    from portbench.harness import ingest
    from portbench.tests import tiny

    rec = ingest.run(tiny.ctx(tiny.tiny_config(), tiny.tiny_ingest_traffic(), 2**31 + 29, 0.5, trace=True))
    assert read_metric("asr_step_ms.ingest", rec) > 0
    assert read_metric(NAME, rec) is None
