"""A stand-in for Kimi-VL's tokenizer and its chat template.

The published tokenizer is a tiktoken BPE file that is not in the
repository, so text maps to ids by a rule of its own:
  * a word (a run of non-space characters) hashes to one id below the
    special-token range;
  * an id decodes to a fixed pseudo-word, "z" and its base-26 digits in
    letters, which maps back to the same id;
  * the template's special tokens take fixed ids at the top of the
    vocabulary (`SPECIALS`, counted down from the last id's block of
    `n_special`).
The chat template is Kimi-VL's: a user turn, the image between
<|media_start|>image<|media_content|> and <|media_end|> as one
<|media_pad|> per image token, then the assistant's turn.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Sequence

#: the template's special tokens, by offset into the top n_special ids
SPECIALS = ("[BOS]", "[EOS]", "<|im_end|>", "<|im_user|>", "<|im_assistant|>", "<|im_middle|>",
            "<|media_start|>", "<|media_content|>", "<|media_end|>", "<|media_pad|>")

_WORD = re.compile(r"z([a-z]+)")


class StandInTokenizer:
    def __init__(self, vocab_size: int, n_special: int = 256):
        self.vocab_size = vocab_size
        self.n_words = vocab_size - n_special
        self.special = {name: self.n_words + i for i, name in enumerate(SPECIALS)}
        self.im_end = self.special["<|im_end|>"]
        self.media_pad = self.special["<|media_pad|>"]

    def word_id(self, word: str) -> int:
        m = _WORD.fullmatch(word)
        if m:
            v = 0
            for ch in m.group(1):
                v = v * 26 + ord(ch) - 97
            if v < self.n_words and self.word(v) == word:
                return v
        return int.from_bytes(hashlib.blake2b(word.encode(), digest_size=8).digest(), "little") % self.n_words

    def word(self, i: int) -> str:
        digits = []
        while True:
            i, r = divmod(i, 26)
            digits.append(chr(97 + r))
            if i == 0:
                break
        return "z" + "".join(reversed(digits))

    def encode(self, text: str) -> List[int]:
        return [self.word_id(w) for w in text.split()]

    def decode(self, ids: Sequence[int]) -> str:
        """The words of the ids below the special range, space-separated."""
        return " ".join(self.word(int(i)) for i in ids if 0 <= int(i) < self.n_words)

    def chat_ids(self, prompt: str, image_tokens: Sequence[int] = ()) -> List[int]:
        """The template's ids for one user turn: each image as its
        `image_tokens[i]` <|media_pad|> positions, the prompt, and the
        assistant's turn opened."""
        s = self.special
        ids = [s["<|im_user|>"], *self.encode("user"), s["<|im_middle|>"]]
        for n in image_tokens:
            ids += [s["<|media_start|>"], *self.encode("image"), s["<|media_content|>"],
                    *[self.media_pad] * n, s["<|media_end|>"]]
        ids += [*self.encode(prompt), s["<|im_end|>"], s["<|im_assistant|>"], *self.encode("assistant"),
                s["<|im_middle|>"]]
        return ids
