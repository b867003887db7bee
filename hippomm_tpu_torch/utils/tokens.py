"""Token counting for context budgeting (counterpart of hippomm_tpu/utils/tokens.py).

Uses the GPT-2 fast tokenizer from `transformers` when its local cache is
available, else a deterministic chars/4 heuristic, so budgeting never needs
network access.
"""

from __future__ import annotations

_TOKENIZER = None
_TOKENIZER_FAILED = False


def _get_tokenizer():
    global _TOKENIZER, _TOKENIZER_FAILED
    if _TOKENIZER is not None or _TOKENIZER_FAILED:
        return _TOKENIZER
    try:
        from transformers import AutoTokenizer

        _TOKENIZER = AutoTokenizer.from_pretrained("gpt2", local_files_only=True)
    except Exception:
        _TOKENIZER_FAILED = True
    return _TOKENIZER


def count_tokens(text: str) -> int:
    """Approximate LLM token count of `text`."""
    if not text:
        return 0
    tok = _get_tokenizer()
    if tok is not None:
        return len(tok.encode(text))
    # ~4 chars/token heuristic, word-aware lower bound
    return max(len(text) // 4, len(text.split()))
