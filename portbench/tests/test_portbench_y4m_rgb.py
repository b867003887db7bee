"""The readers of `y4m_rgb_ms.ingest` (Σ `media.y4m_rgb` span seconds over
Σ `media.y4m_rgb_frames`, in ms) and `y4m_rgb_native_pct.ingest`
(`media.y4m_rgb_native_frames` over `media.y4m_rgb_frames`): exact from a
synthetic ring and slice, None where the ring begins after the slice, where
a name is absent from it, or where the program keeps no ring; and from a
traced ingest run on the CPU, whose Y4M frames the native call converts."""

from collections import deque

import pytest

from hippomm_tpu_torch.utils import timers
from portbench.run import read_metric
from portbench.tests import test_portbench_spans as base

MS, PCT = "y4m_rgb_ms.ingest", "y4m_rgb_native_pct.ingest"
FRAMES, NATIVE, SPAN = "media.y4m_rgb_frames", "media.y4m_rgb_native_frames", "media.y4m_rgb"


def _read_counted(a, b, n, native):
    return [base._span(SPAN, a, b), base._count(FRAMES, b, n), base._count(NATIVE, b, native)]


def _ring():
    """The spans test's ring, with four reads: one that overlaps the slice's
    start by 0.125 s, two inside it (the second on the numpy path) and one
    after it; and a count before the slice."""
    recs = list(base._ring()) + [base._count(FRAMES, 99.0, 5), base._count(NATIVE, 99.0, 5)]
    recs += _read_counted(99.875, 100.125, 4, 4)
    recs += _read_counted(100.5, 100.5625, 2, 2)
    recs += _read_counted(101.0, 101.25, 2, 0)
    recs += _read_counted(102.5, 102.75, 8, 8)
    return deque(sorted(recs, key=lambda r: r.end_ns))


def _read(monkeypatch, name, ring, trace=base.SLICE):
    monkeypatch.setattr(timers, "RING", ring)
    return read_metric(name, {"trace": trace})


@pytest.mark.parametrize("name,value", [
    (MS, 1000.0 * (0.125 + 0.0625 + 0.25) / 8),
    (PCT, 100.0 * 6 / 8),
])
def test_reader_exact(monkeypatch, name, value):
    assert _read(monkeypatch, name, _ring()) == value


@pytest.mark.parametrize("name", [MS, PCT])
def test_reader_none_when_the_ring_begins_after_the_slice(monkeypatch, name):
    late = deque(r for r in _ring() if r.end_ns > int(base.SLICE._t0 * base.S))
    assert _read(monkeypatch, name, late) is None


@pytest.mark.parametrize("name,gone", [(MS, SPAN), (MS, FRAMES), (PCT, NATIVE), (PCT, FRAMES)])
def test_reader_none_when_its_name_is_absent(monkeypatch, name, gone):
    ring = deque(r for r in _ring() if r.name != gone or r.end_ns < int(base.SLICE._t0 * base.S))
    assert _read(monkeypatch, name, ring) is None


@pytest.mark.parametrize("name", [MS, PCT])
def test_reader_none_without_a_ring_or_a_trace(monkeypatch, name):
    assert _read(monkeypatch, name, _ring(), trace=None) is None
    monkeypatch.delattr(timers, "RING")
    assert read_metric(name, {"trace": base.SLICE}) is None


def test_traced_ingest_on_the_cpu_reads_both():
    """The tiny traced ingest fetches its key frames from Y4M through the
    native call: a positive time a frame, and every frame native."""
    from portbench.harness import ingest
    from portbench.tests import tiny

    rec = ingest.run(tiny.ctx(tiny.tiny_config(), tiny.tiny_ingest_traffic(), 2**31 + 31, 0.5, trace=True))
    assert read_metric(MS, rec) > 0
    assert read_metric(PCT, rec) == 100.0
