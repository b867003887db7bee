"""Token budgeting for reasoning prompts (counterpart of
hippomm_tpu/retrieval/budget.py; reference: hippocampal_memory.py:2064-2153,
2574-2621 — even-spaced subsampling into a 120k context).

Keeps first/middle/last items, evenly spaced, and appends a
"[Note: Showing X of Y]" marker when subsampled.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from hippomm_tpu_torch.utils.tokens import count_tokens


def evenly_spaced_indices(n: int, k: int) -> List[int]:
    """k indices over range(n), always including 0 and n-1."""
    if k >= n:
        return list(range(n))
    if k <= 1:
        return [0]
    step = (n - 1) / (k - 1)
    idx = sorted({round(i * step) for i in range(k)})
    return [min(i, n - 1) for i in idx]


def evenly_distribute_items(
    items: Sequence[str], max_tokens: int, item_format: str = "{}"
) -> Tuple[List[str], bool]:
    """Subsample items until the formatted total fits max_tokens.
    Returns (kept_items, was_subsampled)."""
    items = list(items)
    if not items:
        return [], False
    total = sum(count_tokens(item_format.format(s)) for s in items)
    if total <= max_tokens:
        return items, False
    avg = max(1, total // len(items))
    k = max(1, max_tokens // avg)
    idx = evenly_spaced_indices(len(items), k)
    kept = [items[i] for i in idx]
    # trim further if the estimate undershot
    while len(kept) > 1 and sum(count_tokens(item_format.format(s)) for s in kept) > max_tokens:
        idx = evenly_spaced_indices(len(kept), max(1, len(kept) // 2))
        kept = [kept[i] for i in idx]
    return kept, True


def truncate_text_to_tokens(text: str, max_tokens: int) -> str:
    """Head+tail truncation of one long text."""
    if count_tokens(text) <= max_tokens:
        return text
    words = text.split()
    keep = max(2, int(len(words) * max_tokens / max(1, count_tokens(text))))
    head = words[: keep // 2]
    tail = words[-(keep - keep // 2) :]
    return " ".join(head) + " […] " + " ".join(tail)


def proportional_split(total: int, weights: Sequence[float]) -> List[int]:
    """Split a token budget proportionally (the VIDEO+AUDIO split)."""
    s = sum(weights) or 1.0
    return [max(1, int(total * w / s)) for w in weights]


def subsample_note(shown: int, total: int) -> str:
    return f"[Note: Showing {shown} of {total} items]" if shown < total else ""
