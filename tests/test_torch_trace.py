"""The port's tracer (utils/timers): spans nest per thread and carry their
video, totals stay exact under threads, the process's ring is bounded,
counters sum exactly within a slice of time, profiler ranges are built only
while the profiler records; and a tiny folder ingest on the CPU records the
ingest's spans and counters where the work happens, with one profiler trace
a call under `system.profile_dir`."""

import glob
import json
import sys
import threading
import time
import uuid
from collections import defaultdict, deque

import numpy as np
import pytest
import torch

from hippomm_tpu_torch.config import Config
from hippomm_tpu_torch.core import batch_process as bp
from hippomm_tpu_torch.media.synth import SynthSpec, write_synthetic_video
from hippomm_tpu_torch.memory.engine import HippocampalMemory
from hippomm_tpu_torch.models.foundation import ImageBind, Whisper
from hippomm_tpu_torch.utils import timers
from hippomm_tpu_torch.utils.timers import StageTimer

#: the engine's stage names at the parent of the tracer: the four host
#: layer metrics of the benchmark sum among these, so no new span may join
#: them but the extraction wait
ENGINE_STAGES = {"extract_decode", "extract_decode_c", "extract_feed", "extract_flush", "extract_score",
                 "extract_seg_ssim", "extract_jpeg_save", "extract_vision_feed", "segmentation",
                 "encode_vision", "encode_audio", "transcribe", "checkpoint", "consolidate", "caption",
                 "summary"}


def _name() -> str:
    return "test." + uuid.uuid4().hex[:12]


def _records(*names):
    return [r for r in list(timers.RING) if r.name in names]


def test_spans_nest_per_thread_with_their_video():
    outer, inner, other, ctr, after = _name(), _name(), _name(), _name(), _name()
    t = StageTimer()

    def elsewhere():
        with timers.span(other):
            pass

    with timers.video("clip7"):
        with t.stage(outer):
            with timers.span(inner):
                timers.count(ctr, 3)
                th = threading.Thread(target=elsewhere)
                th.start()
                th.join(timeout=30)
    assert not th.is_alive()
    timers.count(after, 1)
    (o,), (i,), (x,), (c,), (a,) = (_records(n) for n in (outer, inner, other, ctr, after))
    assert (o.parent, o.video, o.n) == (None, "clip7", None)
    assert (i.parent, i.video) == (outer, "clip7")
    assert (c.parent, c.video, c.n, c.start_ns) == (inner, "clip7", 3, c.end_ns)
    assert i.start_ns >= o.start_ns and i.end_ns <= o.end_ns and i.start_ns <= c.end_ns <= i.end_ns
    # another thread has its own stack and video; the video ends with its block
    assert (x.parent, x.video) == (None, None)
    assert (a.parent, a.video) == (None, None)
    assert x.thread != i.thread == o.thread == threading.get_ident()
    # the engine's timer holds its own span; a span no timer owns is a
    # record in the ring alone
    assert dict(t.counts) == {outer: 1} and set(t.totals) == {outer}
    assert t.totals[outer] == pytest.approx((o.end_ns - o.start_ns) / 1e9, abs=0)


class _Yielding(defaultdict):
    """A dict that lets another thread run between the read and the write of
    `d[k] += x`, where the interpreter would seldom switch by itself."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_totals_exact_under_threads(monkeypatch):
    """8 threads × 10 000 stages into one timer, the interpreter switching
    threads every microsecond and inside each update: no update of a total
    or a count is lost."""
    monkeypatch.setattr(timers, "RING", deque(maxlen=1 << 17))
    t, name, n_threads, n_stages = StageTimer(), _name(), 8, 10_000
    t.totals, t.counts = _Yielding(float), _Yielding(int)

    def work():
        for _ in range(n_stages):
            with t.stage(name):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    recs = _records(name)
    assert len(recs) == t.counts[name] == n_threads * n_stages
    assert len({r.thread for r in recs}) == n_threads
    exact = sum(r.end_ns - r.start_ns for r in recs) / 1e9
    assert abs(t.totals[name] - exact) < 1e-9
    assert t.summary()[name]["count"] == n_threads * n_stages


def test_ring_is_bounded():
    assert timers.RING.maxlen == timers.RING_SIZE
    name = _name()
    for _ in range(timers.RING_SIZE + 100):
        timers.count(name, 1)
    assert len(timers.RING) == timers.RING_SIZE
    assert len(_records(name)) == timers.RING_SIZE  # the oldest 100 dropped


def test_counters_sum_exactly_within_a_slice():
    name = _name()
    timers.count(name, 1000)  # before the slice
    t0 = time.perf_counter_ns()

    def work(k):
        for i in range(500):
            timers.count(name, k + i)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    t1 = time.perf_counter_ns()
    timers.count(name, 1000)  # after it
    assert not any(th.is_alive() for th in threads)
    inside = [r.n for r in _records(name) if t0 <= r.end_ns <= t1]
    assert len(inside) == 2000
    assert sum(inside) == sum(k + i for k in range(4) for i in range(500))


def test_profiler_ranges_only_while_profiling(monkeypatch):
    built = []
    real = torch._C._profiler._RecordFunctionFast

    def spy(name, *a, **k):
        built.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", spy)
    name = _name()
    for _ in range(10):
        with timers.span(name):
            pass
    assert built == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.span(name):
            torch.ones(4).sum()
    assert built == [timers.RANGE_PREFIX + name]
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == timers.RANGE_PREFIX + name]
    assert len(events) == 1
    # a function-scope range: a user-scope one would also become a CUDA-typed
    # annotation over the kernels it launched in a trace of the card
    assert events[0].scope() != int(torch._C._profiler.RecordScope.USER_SCOPE)
    assert str(events[0].device_type()).endswith("CPU")


# ---- a tiny folder ingest on the CPU ----

_CLIPS = {"a": dict(duration=12.0, fps=2.0, width=160, height=120, scene_changes=(6.0,), seed=3),
          "b": dict(duration=8.0, fps=2.0, width=160, height=120, scene_changes=(4.0,), seed=4)}


@pytest.fixture(scope="module")
def ingest(tmp_path_factory):
    """Two clips with their audio through `process_video_folder` with tiny
    fp32 towers (random weights), under `system.profile_dir`; each batch's
    decode output kept."""
    folder = tmp_path_factory.mktemp("videos")
    for name, spec in _CLIPS.items():
        write_synthetic_video(str(folder / f"{name}.y4m"), SynthSpec(**spec),
                              audio_path=str(folder / f"{name}.wav"))
    store = str(tmp_path_factory.mktemp("store"))
    traces = str(tmp_path_factory.mktemp("traces"))
    cfg = Config()
    cfg.api.mode = "stub"
    cfg.models.imagebind_variant = cfg.models.whisper_variant = "tiny"
    cfg.storage.base_dir = store
    cfg.system.profile_dir = traces
    ib = ImageBind(variant="tiny", dtype=torch.float32, device="cpu")
    wh = Whisper(variant="tiny", dtype=torch.float32, beam_size=1, device="cpu")
    mem = HippocampalMemory(cfg, device="cpu", models={"imagebind": ib, "whisper": wh})
    decoded = []
    orig = wh._impl._decode

    def decode(shards, max_len):
        out = orig(shards, max_len)
        decoded.append(([ln.cpu().numpy() for _, ln in out], max_len))
        return out

    wh._impl._decode = decode
    t0 = time.perf_counter_ns()
    with torch.no_grad():
        stats = bp.process_video_folder(str(folder), store, config=cfg, memory_system=mem)
    t1 = time.perf_counter_ns()
    recs = [r for r in list(timers.RING) if t0 <= r.start_ns and r.end_ns <= t1]
    return {"stats": stats, "mem": mem, "recs": recs, "decoded": decoded, "traces": traces,
            "plen": wh._impl._prompt().shape[1]}


def _spans(ingest, name):
    return [r for r in ingest["recs"] if r.name == name and r.n is None]


def _sum(ingest, name):
    return sum(r.n for r in ingest["recs"] if r.name == name and r.n is not None)


def test_ingest_records_its_spans(ingest):
    assert ingest["stats"]["processed"] == 2 and ingest["stats"]["failed"] == 0
    # the engine thread's wait, the lookahead's extraction, the engine's ASR
    for name in ("ingest.extract_wait", "extract_decode", "transcribe"):
        spans = _spans(ingest, name)
        assert spans, name
        assert {r.video for r in spans} == {"a", "b"}, name
    # the ASR enqueue's counters, on the lookahead thread
    assert {r.video for r in ingest["recs"] if r.name == "asr.chunks_real"} == {"a", "b"}
    waits = _spans(ingest, "ingest.extract_wait")
    assert len(waits) == 2 and ingest["mem"].timers.counts["ingest.extract_wait"] == 2


def test_one_decode_step_a_position(ingest):
    steps = 0
    for lengths, max_len in ingest["decoded"]:
        last = int(max(ln.max() for ln in lengths))
        steps += (last if last < max_len else max_len - 1) - ingest["plen"] + 1
    decode, reads = _spans(ingest, "asr.decode_step"), _spans(ingest, "asr.read_wait")
    assert len(decode) == len(reads) == steps > 0
    assert {r.parent for r in decode} == {"transcribe"}
    assert {r.parent for r in reads} == {"asr.decode_step"}
    assert {r.video for r in decode} == {"a", "b"}


def test_row_counters(ingest):
    assert 0 < _sum(ingest, "audio.rows_real") <= _sum(ingest, "audio.rows_launched")
    assert 0 < _sum(ingest, "asr.chunks_real") <= _sum(ingest, "asr.chunks_launched")
    assert 0 < _sum(ingest, "vision.rows_kept") <= _sum(ingest, "vision.rows_launched")
    assert _sum(ingest, "asr.chunks_real") == 2  # one 30 s window a clip
    assert _sum(ingest, "vision.rows_launched") % 32 == 0 and _sum(ingest, "audio.rows_launched") % 32 == 0


def test_engine_stages_keep_their_names(ingest):
    assert set(ingest["mem"].timers.totals) == ENGINE_STAGES | {"ingest.extract_wait"}


def test_profile_dir_writes_one_trace_a_call(ingest):
    (path,) = glob.glob(f"{ingest['traces']}/*.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the calling thread's spans: the wait on the extraction, the engine's
    # stages, the decode loop
    for name in ("ingest.extract_wait", "transcribe", "asr.decode_step", "asr.read_wait"):
        assert timers.RANGE_PREFIX + name in names, name
    assert np.isfinite(ingest["stats"]["realtime_multiple"])
