"""Stage timers + throughput counters (the reference has none — SURVEY.md §5).

Per-stage wall-clock accumulation, ingest throughput in video-hours/hour, and
an optional torch.profiler trace hook.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class StageTimer:
    """Accumulates wall-clock per named stage; nestable via context manager."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name] / max(1, self.counts[name]), 4),
            }
            for name in sorted(self.totals)
        }

    def log_summary(self, prefix: str = "stage timings"):
        logger.info("%s: %s", prefix, json.dumps(self.summary()))


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
    activities), exported as a Chrome trace into `trace_dir`."""
    if not trace_dir:
        yield
        return
    import torch
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
