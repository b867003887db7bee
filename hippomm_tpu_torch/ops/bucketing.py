"""Shape bucketing: pad data-dependent batch dims to a small set of sizes so
XLA compiles each program a bounded number of times (SURVEY.md §7 hard part 3:
"variable-length everything"). Essential both for steady-state throughput and
for remote-compile environments where every new shape costs seconds.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

QUANTUM = 32


def bucket_size(n: int, quantum: int = QUANTUM) -> int:
    """Smallest multiple of `quantum` ≥ n (min one quantum).

    ONE compiled shape per 32 rows: padding a 4-row call to 32 wastes trivial
    compute, while a ladder of small buckets costs one multi-second XLA compile
    per rung — compiles dominate on remote/tunneled devices and pollute
    measured throughput windows."""
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def pad_leading(arr: np.ndarray, n: int | None = None, mode: str = "edge") -> Tuple[np.ndarray, int]:
    """Pad arr's leading axis to a bucket (or to n). Returns (padded, original_len)."""
    if mode not in ("edge", "zero"):
        raise ValueError(f"pad_leading mode must be 'edge' or 'zero', got {mode!r}")
    orig = arr.shape[0]
    target = n if n is not None else bucket_size(orig)
    if orig > target:
        raise ValueError(f"cannot pad {orig} rows DOWN to {target}")
    if orig == target:
        return arr, orig
    pad = target - orig
    if mode == "edge" and orig > 0:
        tail = np.repeat(arr[-1:], pad, axis=0)
    else:
        tail = np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, tail]), orig
