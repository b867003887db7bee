"""The program's spans and counters inside the traced slice.

The port keeps one bounded ring of records for the process
(`hippomm_tpu_torch.utils.timers.RING`): each span's name, start and end on
`time.perf_counter_ns()`, and each counter's increment `n` at its time. The
traced slice runs from `record["trace"]._t0` for `window_s` seconds on the
same clock. Spans are clipped to the slice; a counter counts where its time
lies inside it. Nothing is read, and None is returned, where the program
keeps no ring (an older program), where the ring's oldest record ends after
the slice began (records were dropped), or where a name is absent from the
slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def _ring():
    try:
        from hippomm_tpu_torch.utils import timers
    except ImportError:
        return None
    return getattr(timers, "RING", None)


def in_slice(record: Dict) -> Optional[Tuple[Dict[str, Tuple[float, int]], Dict[str, int]]]:
    """({span: (seconds inside the slice, spans that overlap it)},
    {counter: sum of its increments inside the slice}), or None."""
    tr = record.get("trace")
    t0 = getattr(tr, "_t0", None)
    ring = _ring()
    if t0 is None or not tr.window_s > 0 or ring is None:
        return None
    recs = list(ring)
    lo = round(t0 * 1e9)
    hi = lo + round(tr.window_s * 1e9)
    if not recs or recs[0].end_ns > lo:
        return None
    spans: Dict[str, Tuple[float, int]] = {}
    counters: Dict[str, int] = {}
    for r in recs:
        if r.n is not None:
            if lo <= r.end_ns <= hi:
                counters[r.name] = counters.get(r.name, 0) + r.n
            continue
        inside = min(r.end_ns, hi) - max(r.start_ns, lo)
        if inside > 0:
            s, k = spans.get(r.name, (0.0, 0))
            spans[r.name] = (s + inside / 1e9, k + 1)
    return spans, counters
