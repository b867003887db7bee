"""The readers of the program's spans and counters (`harness/spans.py`,
`metrics/*` of source program_span): exact numbers from a synthetic ring
and traced slice, None where the ring begins after the slice, where a name
is absent from it, or where the program keeps no ring; each metric read
from a traced ingest run of the program at tiny sizes on the CPU; and the
ring's room for a traced window of each ingest cell."""

import json
import math
import os
from collections import deque
from types import SimpleNamespace

import pytest

from hippomm_tpu_torch.utils import timers
from portbench.run import REPO, read_metric

S = 1_000_000_000  # ns a second
SLICE = SimpleNamespace(_t0=100.0, window_s=2.0)  # [100 s, 102 s] on perf_counter
NEW = ("extract_wait_pct.ingest", "asr_step_ms.ingest", "asr_launch_ms.ingest",
       "asr_useful_rows_pct.ingest", "vision_useful_rows_pct.ingest", "audio_useful_rows_pct.ingest")


def _span(name, a, b):
    return timers.Record(name, int(a * S), int(b * S), 1, None, "v")


def _count(name, t, n):
    return timers.Record(name, int(t * S), int(t * S), 1, None, "v", n)


def _ring():
    recs = [
        _count("vision.rows_launched", 99.0, 32),  # before the slice
        _span("ingest.extract_wait", 99.5, 100.5),  # 0.5 s of it inside
        _span("asr.read_wait", 100.125, 100.25),
        _span("asr.decode_step", 100.0, 100.25),
        _count("asr.chunks_launched", 100.3, 16),
        _count("asr.chunks_real", 100.3, 10),
        _count("vision.rows_launched", 100.4, 32),
        _count("vision.rows_launched", 100.45, 32),
        _span("asr.read_wait", 100.75, 101.0),
        _span("asr.decode_step", 100.5, 101.0),
        _count("audio.rows_launched", 101.1, 32),
        _count("audio.rows_real", 101.1, 12),
        _span("ingest.extract_wait", 101.0, 101.25),
        _count("vision.rows_kept", 101.5, 24),
        _span("asr.decode_step", 102.5, 103.0),  # after the slice
        _count("asr.chunks_launched", 102.5, 16),
    ]
    return deque(sorted(recs, key=lambda r: r.end_ns))


def _read(monkeypatch, name, ring, trace=SLICE):
    monkeypatch.setattr(timers, "RING", ring)
    return read_metric(name, {"trace": trace})


@pytest.mark.parametrize("name,value", [
    ("extract_wait_pct.ingest", 100.0 * 0.75 / 2.0),
    ("asr_step_ms.ingest", 1000.0 * 0.75 / 2),
    ("asr_launch_ms.ingest", 1000.0 * (0.75 - 0.375) / 2),
    ("asr_useful_rows_pct.ingest", 100.0 * 10 / 16),
    ("vision_useful_rows_pct.ingest", 100.0 * 24 / 64),
    ("audio_useful_rows_pct.ingest", 100.0 * 12 / 32),
])
def test_reader_exact(monkeypatch, name, value):
    assert _read(monkeypatch, name, _ring()) == value


@pytest.mark.parametrize("name", NEW)
def test_reader_none_when_the_ring_begins_after_the_slice(monkeypatch, name):
    late = deque(r for r in _ring() if r.end_ns > int(SLICE._t0 * S))
    assert _read(monkeypatch, name, late) is None


@pytest.mark.parametrize("name,gone", [
    ("extract_wait_pct.ingest", "ingest.extract_wait"),
    ("asr_step_ms.ingest", "asr.decode_step"),
    ("asr_launch_ms.ingest", "asr.read_wait"),
    ("asr_useful_rows_pct.ingest", "asr.chunks_real"),
    ("vision_useful_rows_pct.ingest", "vision.rows_kept"),
    ("audio_useful_rows_pct.ingest", "audio.rows_launched"),
])
def test_reader_none_when_its_name_is_absent(monkeypatch, name, gone):
    ring = deque(r for r in _ring() if r.name != gone or r.end_ns < int(SLICE._t0 * S))
    assert _read(monkeypatch, name, ring) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_none_without_a_ring_or_a_trace(monkeypatch, name):
    assert _read(monkeypatch, name, _ring(), trace=None) is None
    monkeypatch.delattr(timers, "RING")
    assert read_metric(name, {"trace": SLICE}) is None


@pytest.fixture(scope="module")
def traced_tiny():
    """A traced run of the vlog cell at tiny sizes: its record, its traffic
    and the ring's records of the traced call."""
    from portbench.harness import ingest
    from portbench.tests import tiny

    traffic = tiny.tiny_ingest_traffic()
    rec = ingest.run(tiny.ctx(tiny.tiny_config(), traffic, 2**31 + 23, 0.5, trace=True))
    lo = round(rec["trace"]._t0 * 1e9)
    hi = lo + round(rec["trace"].window_s * 1e9)
    return rec, traffic, [r for r in timers.RING if lo <= r.end_ns <= hi]


def test_traced_ingest_reads_each_program_metric(traced_tiny):
    """The ring holds the traced call, each metric reads a number within its
    range, and the program still runs under the harness's captures
    (AsrCapture, TowerCapture)."""
    rec = traced_tiny[0]
    got = {name: read_metric(name, rec) for name in NEW}
    assert 0 < got["extract_wait_pct.ingest"] < 100
    assert 0 < got["asr_launch_ms.ingest"] < got["asr_step_ms.ingest"]
    # tiny traffic: a 40 s track is two 30 s windows, in a 4-row bucket
    assert got["asr_useful_rows_pct.ingest"] == 50.0
    assert 0 < got["vision_useful_rows_pct.ingest"] < 100
    assert 0 < got["audio_useful_rows_pct.ingest"] < 100
    assert rec["work"]["vision_rows"] > 0 and rec["layer"]["encode_s"] > 0


with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
#: ingest_realtime_x four times the fastest each traffic has run on an H100
#: at 700 W (vlog 135.24, fastcut 53.6, clip30fps 32.42)
X_CEILING = {"vlog": 4 * 135.24, "fastcut": 4 * 53.6, "clip30fps": 4 * 32.42}
INGEST_CELLS = [w for w in BENCH["workloads"] if w["traffic"] in X_CEILING]


@pytest.mark.parametrize("cell", INGEST_CELLS, ids=[w["name"] for w in INGEST_CELLS])
def test_ring_holds_a_traced_window_of_each_ingest_cell(traced_tiny, cell):
    """The readers see a traced call only while the ring still holds it
    when the window has closed. The tiny traced call gives the records a
    decode position makes (its span and everything inside it) and the rest
    per scan candidate (one a second of video); a cell's call decodes every
    224 positions of each 32-window batch (random weights never end a
    transcript), and its window, at four times the fastest it has run,
    must fill at most half the ring."""
    from portbench.harness import ingest
    from portbench.tests import tiny

    _, small, recs = traced_tiny
    steps = [r for r in recs if r.name == "asr.decode_step" and r.n is None]
    in_steps = sum(1 for r in recs for s in steps
                   if r.thread == s.thread and s.start_ns <= r.start_ns and r.end_ns <= s.end_ns)
    per_step = in_steps / len(steps)
    per_candidate = (len(recs) - in_steps) / (small["videos_per_folder"] * small["duration_s"])
    assert per_step >= 2 and per_candidate > 0

    cfg, traffic = tiny.load("configs", cell["config"]), tiny.load("traffic", cell["traffic"])
    windows = math.ceil(traffic["duration_s"] / cfg["whisper"]["chunk_s"])
    positions = math.ceil(windows / ingest.ASR_BATCH) * min(224, cfg["whisper"]["max_target_positions"])
    per_call = traffic["videos_per_folder"] * (per_step * positions + per_candidate * traffic["duration_s"])
    media_s = traffic["videos_per_folder"] * traffic["duration_s"]
    calls = math.ceil(BENCH["run_seconds"] * X_CEILING[cell["traffic"]] / media_s) + 1
    assert calls * per_call < timers.RING_SIZE / 2, (calls, per_call)
