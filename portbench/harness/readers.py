"""Shared arithmetic of the per-layer metric readers under `metrics/`.
A reader that finds nothing to read returns None, and the metric is left
out of the result line; a share is never reported as 0 for want of time."""

from __future__ import annotations

from typing import Dict, Optional

from portbench.harness import work


def layer_s_per_min(record: Dict, key: str) -> Optional[float]:
    """A stage group's host seconds per minute of media (StageTimer totals)."""
    return record.get("layer", {}).get(key)


def roofline_pct(record: Dict, kind: str) -> Optional[float]:
    """Σ bound of the work the inputs need ÷ Σ device time of the kernels."""
    w = record.get("work")
    if not w or not w.get(f"{kind}_kernel_s") or not w.get(f"{kind}_bound_s"):
        return None
    return 100.0 * w[f"{kind}_bound_s"] / w[f"{kind}_kernel_s"]


def mfu_pct(record: Dict) -> Optional[float]:
    """Model FLOPs of the traced slice, each precision over its peak, ÷ its seconds."""
    w, tr = record.get("work"), record.get("trace")
    if not w or tr is None or tr.window_s <= 0 or not any(w["flops"].values()):
        return None
    return work.mfu_pct(w["flops"], tr.window_s)


def idle_pct(record: Dict) -> Optional[float]:
    """Share of the traced slice in which no device operation ran."""
    tr = record.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
