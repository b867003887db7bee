"""Seeds: `--seed` is any whole number; numpy and torch want small parts."""

from __future__ import annotations

from typing import List


def seed_words(seed: int, *salt: int) -> List[int]:
    """The seed as non-negative 32-bit words, with a salt per use, for
    numpy's default_rng (equal seeds give equal words)."""
    s = int(seed)
    words = [(s >> (32 * i)) & 0xFFFFFFFF for i in range(3)]
    return words + [1 if s < 0 else 0] + [int(x) & 0xFFFFFFFF for x in salt]


def torch_seed(seed: int, salt: int) -> int:
    """A 63-bit torch.Generator seed from the run's seed and a salt."""
    import numpy as np

    return int(np.random.default_rng(seed_words(seed, salt)).integers(0, 2**63 - 1))
