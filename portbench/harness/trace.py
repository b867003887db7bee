"""Reading a torch.profiler trace (CPU and CUDA activity) of a slice of the
window: device busy time, kernel time by name, and the idle gaps of the
device named by what the host was doing."""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

WINDOW_MARK = "portbench.traced_slice"
MAX_NAMED_GAPS = 500
TOP = 10


def short_name(name: str) -> str:
    """A kernel's or op's name without its return type and argument list,
    at most 80 characters."""
    name = re.sub(r"^void ", "", name.strip())
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name.strip()[:80]


class Traced:
    """Context manager: profiles its body, then holds the slice's numbers."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels: Dict[str, float] = {}
        self.gaps: List[Tuple[str, float]] = []
        self.read_s = 0.0

    def __enter__(self):
        if not self.enabled:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function(WINDOW_MARK)
        self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        t = time.perf_counter()
        self._read(self._prof.profiler.kineto_results.events())
        self.read_s = time.perf_counter() - t
        self._prof = None
        return False

    def _read(self, events: Iterable) -> None:
        dev, cpu = [], []
        w0 = w1 = None
        for e in events:
            name = e.name()
            s = e.start_ns()
            d = e.duration_ns()
            if name == WINDOW_MARK:
                w0, w1 = s, s + d
            elif str(e.device_type()).endswith("CUDA"):
                dev.append((s, s + d, name))
            elif 0 < d < 1_000_000_000 and not name.startswith("ProfilerStep"):
                cpu.append((s, s + d, name))
        if w0 is None:
            starts = [s for s, _, _ in dev + cpu]
            w0, w1 = (min(starts), max(e for _, e, _ in dev + cpu)) if starts else (0, 0)
        dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
        k = defaultdict(float)
        for s, e, n in dev:
            k[n] += (e - s) / 1e9
        self.kernels = dict(k)
        # busy: the union of device intervals; gaps: what is left
        busy, gaps, cur = 0, [], w0
        for s, e, _ in sorted(dev):
            if s > cur:
                gaps.append((cur, s))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if w1 > cur:
            gaps.append((cur, w1))
        self.busy_s = busy / 1e9
        self.gaps = self._name_gaps(gaps, sorted(cpu))

    @staticmethod
    def _name_gaps(gaps, cpu) -> List[Tuple[str, float]]:
        """Each of the longest gaps is named by the CPU event that covers
        most of it (more than half; the shorter on a tie), or "host outside
        torch ops"; the rest are summed as one entry."""
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])
        named, rest = gaps[:MAX_NAMED_GAPS], gaps[MAX_NAMED_GAPS:]
        levels = defaultdict(list)  # events by duration, in powers of two
        for s, e, n in cpu:
            levels[(e - s).bit_length()].append((s, e, n))
        index = {lv: ([ev[0] for ev in evs], evs) for lv, evs in levels.items()}
        tot = defaultdict(float)
        for a, b in named:
            length = b - a
            best, best_ov, best_len = "host outside torch ops", 0.5 * length, None
            for lv, (starts, evs) in index.items():
                if (1 << lv) <= best_ov:  # every event here is shorter than needed
                    continue
                lo = bisect.bisect_left(starts, a - (1 << lv))
                hi = bisect.bisect_left(starts, b)
                for s, e, n in evs[lo:hi]:
                    ov = min(e, b) - max(s, a)
                    if ov > best_ov or (ov == best_ov and best_len is not None and e - s < best_len):
                        best, best_ov, best_len = short_name(n), ov, e - s
            tot[best] += length / 1e9
        if rest:
            cap = (rest[0][1] - rest[0][0]) / 1e6
            tot[f"gaps under {cap:.3f} ms"] += sum(b - a for a, b in rest) / 1e9
        return sorted(tot.items(), key=lambda kv: -kv[1])

    def kernel_s(self, patterns: Iterable[str]) -> float:
        pats = tuple(patterns)
        return sum(t for n, t in self.kernels.items() if any(p in n for p in pats))

    def breakdown(self) -> Dict[str, List]:
        ops = defaultdict(float)
        for n, t in self.kernels.items():
            ops[short_name(n)] += t
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, t] for n, t in top],
                "idle_gaps": [[n, t] for n, t in self.gaps[:TOP]]}
