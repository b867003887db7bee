"""Stage timers, the process's span ring, and throughput counters (the
reference has none — SURVEY.md §5).

`StageTimer.stage(name)` times a span. Its wall-clock goes into the timer's
`totals` and `counts`, and a `Record` of it (name, start and end on
`time.perf_counter_ns()`, thread, enclosing span, video) into `RING`: one
bounded in-memory ring for the process, read when a run ends; nothing is
written per span. `count(name, n)` puts a time-stamped increment into the
same ring, so any slice of time can sum it. Spans that no engine's timer
owns (a model's own steps) are `span(name)`: a record in the ring and
nothing else. `video(video_id)` names the video that this thread's spans
and counters belong to.

While torch's profiler records the calling thread, a span also opens a
profiler range `hippomm.<name>`, so the device trace's timeline shows the
program's stages. Ingest throughput is in video-hours/hour; `maybe_profile`
writes a torch.profiler Chrome trace of a block.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, NamedTuple, Optional

import torch

logger = logging.getLogger(__name__)

# ~220 bytes a record: ~55 MB once full; a traced 51 s window of the
# benchmark's busiest ingest cell stays under half of it (portbench's
# test_ring_holds_a_traced_window_of_each_ingest_cell)
RING_SIZE = 1 << 18
RANGE_PREFIX = "hippomm."


class Record(NamedTuple):
    """One span (`n` None) or one counter increment (`n`; start == end)."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[str]
    video: Optional[str]
    n: Optional[int] = None


RING: Deque[Record] = deque(maxlen=RING_SIZE)


class _Local(threading.local):
    """Per thread: the names of the open spans, innermost last, and the
    video the thread works on."""

    def __init__(self):
        self.stack: List[str] = []
        self.video: Optional[str] = None


_local = _Local()


@contextlib.contextmanager
def video(video_id: Optional[str]):
    """Spans and counters of this thread inside the block carry `video_id`."""
    prev = _local.video
    _local.video = video_id
    try:
        yield
    finally:
        _local.video = prev


_profiling = torch.autograd._profiler_enabled  # does the profiler record this thread?


def _open_range(name: str):
    """An open profiler range named hippomm.<name>, for a thread the
    profiler records. A FUNCTION-scope record function: the profiler keeps
    it on the CPU side, where a user-scope one (`record_function`) also
    becomes a CUDA-typed `gpu_user_annotation` over the kernels it
    launched, which a device trace would count as device time."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        return None
    rng = fast(RANGE_PREFIX + name)
    rng.__enter__()
    return rng


class _Span:
    __slots__ = ("_timer", "_name", "_parent", "_range", "_t0")

    def __init__(self, timer: Optional["StageTimer"], name: str):
        self._timer, self._name = timer, name

    def __enter__(self):
        stack = _local.stack
        self._parent = stack[-1] if stack else None
        stack.append(self._name)
        self._range = _open_range(self._name) if _profiling() else None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _local.stack.pop()
        rec = Record(self._name, self._t0, t1, threading.get_ident(), self._parent, _local.video)
        if self._timer is None:
            RING.append(rec)
        else:
            self._timer._add(rec)
        return False


class StageTimer:
    """Accumulates wall-clock per named stage; nestable via context manager.
    Safe to share between threads (the engine thread and the lookahead's
    or streaming producer's extraction time into the engine's)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def stage(self, name: str) -> _Span:
        return _Span(self, name)

    def _add(self, rec: Record) -> None:
        with self._lock:
            self.totals[rec.name] += (rec.end_ns - rec.start_ns) / 1e9
            self.counts[rec.name] += 1
            RING.append(rec)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
        return {
            name: {
                "total_s": round(totals[name], 4),
                "count": counts[name],
                "mean_s": round(totals[name] / max(1, counts[name]), 4),
            }
            for name in sorted(totals)
        }

    def log_summary(self, prefix: str = "stage timings"):
        logger.info("%s: %s", prefix, json.dumps(self.summary()))


def span(name: str) -> _Span:
    """A span that no timer owns: its record goes to the ring alone."""
    return _Span(None, name)


def count(name: str, n: int) -> None:
    """Put an increment of `n` to counter `name` into the ring, stamped now."""
    stack = _local.stack
    t = time.perf_counter_ns()
    RING.append(Record(name, t, t, threading.get_ident(), stack[-1] if stack else None,
                       _local.video, int(n)))


class Throughput:
    """Tracks media-seconds processed vs wall-clock → realtime multiple."""

    def __init__(self):
        self.media_seconds = 0.0
        self._t0: Optional[float] = None
        self.wall_seconds = 0.0

    def start(self):
        if self._t0 is not None:
            # already running: bank the elapsed interval instead of silently
            # discarding it (a per-item start() misuse would otherwise
            # inflate realtime_multiple)
            self.stop()
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.wall_seconds += time.perf_counter() - self._t0
            self._t0 = None

    def add_media(self, seconds: float):
        self.media_seconds += seconds

    @property
    def realtime_multiple(self) -> float:
        wall = self.wall_seconds
        if self._t0 is not None:
            wall += time.perf_counter() - self._t0
        return self.media_seconds / wall if wall > 0 else 0.0

    @property
    def video_hours_per_hour(self) -> float:
        return self.realtime_multiple


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str] = None):
    """Optionally wrap a block in a torch.profiler trace (CPU + CUDA
    activities), exported as one Chrome trace into `trace_dir`: the
    program's `hippomm.*` ranges of the calling thread beside every
    kernel."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json")
    )
