"""ImageBind input preprocessing and text tokenizers.

Counterpart of hippomm_tpu/models/imagebind/preprocess.py:
  * vision, on the device: `preprocess_vision`, the antialiased bicubic
    resize + center crop + CLIP normalization of ops/resize.resize_normalize
  * audio, batched on the device: 2 s clip sampling (3 clips per segment,
    pytorchvideo's ConstantClipsPerVideoSampler offsets), Kaldi fbank
    (ops/mel.KaldiFbank), AST normalisation (mean −4.268, std 9.138, ÷2)
  * text, on the host: the CLIP BPE tokenizer when the standard
    `bpe_simple_vocab_16e6.txt.gz` merges file is found, else a
    deterministic hashing tokenizer (`load_tokenizer`)
Arrays go to `device`, CUDA unless the caller asks for another.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hippomm_tpu_torch.ops.bucketing import pad_leading
from hippomm_tpu_torch.ops.mel import KaldiFbank
from hippomm_tpu_torch.ops.resize import resize_normalize
from hippomm_tpu_torch.utils.device import resolve_device

AUDIO_MEAN = -4.268
AUDIO_STD = 9.138
CLIP_DURATION_S = 2.0
CLIPS_PER_VIDEO = 3
SAMPLE_RATE = 16000


def preprocess_vision(frames_uint8, image_size: int = 224, device=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> (B, 3, S, S) normalized fp32 on `device`
    (None: CUDA; a tensor stays on its own)."""
    return resize_normalize(frames_uint8, size=image_size, device=device)


_FBANKS: Dict[Tuple[int, str], KaldiFbank] = {}


def _fbank(bins: int, device: torch.device) -> KaldiFbank:
    key = (bins, str(device))
    if key not in _FBANKS:
        _FBANKS[key] = KaldiFbank(num_mel_bins=bins, device=device)
    return _FBANKS[key]


def _clip_starts(n_samples: int, clips_per_video: int, clip_samples: int) -> np.ndarray:
    """Clip start offsets of pytorchvideo's ConstantClipsPerVideoSampler:
    start_i = span·i/clips (not linspace, whose last clip starts at the end)."""
    span = max(0, n_samples - clip_samples)
    return (span * np.arange(clips_per_video) / max(1, clips_per_video)).astype(int)


def _fbank_clips(clips: torch.Tensor, fbank: KaldiFbank, target_len: int) -> torch.Tensor:
    """(N, S) clips -> (N, bins, target_len) normalized fbank."""
    feats = fbank(clips).transpose(1, 2)  # (N, bins, T)
    t = feats.shape[2]
    if t < target_len:
        feats = torch.nn.functional.pad(feats, (0, target_len - t))
    feats = feats[:, :, :target_len]
    return (feats - AUDIO_MEAN) / (AUDIO_STD * 2.0)


def preprocess_audio_batch(
    pcms,
    mel_bins: int = 128,
    target_len: int = 204,
    clips_per_video: int = CLIPS_PER_VIDEO,
    device=None,
) -> torch.Tensor:
    """Many 16 kHz clips -> (B, clips, 1, mel_bins, target_len) on `device`
    (None: CUDA): clip slicing on the host, fbank + normalize on the device
    in fixed 32-window chunks (zero-padded, as the JAX program)."""
    device = resolve_device(device)
    clip_samples = int(CLIP_DURATION_S * SAMPLE_RATE)
    if not len(pcms):
        return torch.zeros((0, clips_per_video, 1, mel_bins, target_len), device=device)
    windows = []
    for pcm in pcms:
        pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
        if len(pcm) < clip_samples:
            pcm = np.pad(pcm, (0, clip_samples - len(pcm)))
        for s in _clip_starts(len(pcm), clips_per_video, clip_samples):
            windows.append(pcm[s : s + clip_samples])
    fbank = _fbank(mel_bins, device)
    outs = []
    for lo in range(0, len(windows), 32):
        chunk, n_real = pad_leading(np.stack(windows[lo : lo + 32]), n=32, mode="zero")
        outs.append(_fbank_clips(torch.from_numpy(chunk).to(device), fbank, target_len)[:n_real])
    feats = torch.cat(outs)
    return feats.reshape(len(pcms), clips_per_video, 1, mel_bins, target_len)


def preprocess_audio(
    pcm: np.ndarray,
    mel_bins: int = 128,
    target_len: int = 204,
    clips_per_video: int = CLIPS_PER_VIDEO,
    device=None,
) -> torch.Tensor:
    """16 kHz mono float32 -> (1, clips, 1, mel_bins, target_len) fbank clips
    on `device` (None: CUDA)."""
    return preprocess_audio_batch(
        [pcm], mel_bins=mel_bins, target_len=target_len, clips_per_video=clips_per_video,
        device=device,
    )


# ---------------------------------------------------------------------------
# CLIP BPE tokenizer (self-contained; vocab file optional)
# ---------------------------------------------------------------------------


@lru_cache()
def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _tokenize_matrix(encode, sot, eot, context_length, texts):
    """sot + truncated encode + eot into a zero-padded int32 matrix — shared
    by both tokenizers so truncation and padding cannot drift between them."""
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, t in enumerate(texts):
        ids = [sot] + encode(t)[: context_length - 2] + [eot]
        out[i, : len(ids)] = ids
    return out


class ClipTokenizer:
    """Byte-pair-encoding tokenizer matching CLIP/ImageBind when given the
    standard `bpe_simple_vocab_16e6.txt.gz` merges file."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # CLIP's word split needs unicode classes (\p{L}/\p{N}) from the
        # `regex` module; imported here, so a host without it can still run
        # the hashing tokenizer
        import regex

        self.pat = regex.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            regex.IGNORECASE,
        )
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for tok in self.pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return _tokenize_matrix(self.encode, self.sot, self.eot, self.context_length, texts)


class HashTokenizer:
    """Deterministic tokenizer for hermetic runs (no vocab file).

    Not BPE-compatible, but stable: equal strings give equal token ids, so
    retrieval over a consistent store works end to end without downloads.
    EOS is the largest id, so CLIP-style argmax pooling still lands on it."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        words = _whitespace_clean(_basic_clean(text)).lower().split(" ")
        ids = []
        for w in words:
            if not w:
                continue
            h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return _tokenize_matrix(self.encode, self.sot, self.eot, self.context_length, texts)


def load_tokenizer(
    model_dir: Optional[str] = None, vocab_size: int = 49408, context_length: int = 77
):
    """CLIP BPE if the merges file is found, else HashTokenizer.

    Search order: model_dir (and model_dir/bpe), the HIPPOMM_BPE_PATH
    variable, then a copy next to this module."""
    candidates = []
    if model_dir:
        candidates += [
            os.path.join(model_dir, "bpe_simple_vocab_16e6.txt.gz"),
            os.path.join(model_dir, "bpe", "bpe_simple_vocab_16e6.txt.gz"),
        ]
    env = os.environ.get("HIPPOMM_BPE_PATH")
    if env:
        candidates.append(env)
    candidates.append(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz")
    )
    for c in candidates:
        if c and os.path.exists(c):
            return ClipTokenizer(c, context_length)
    return HashTokenizer(vocab_size, context_length)
