"""Long-form transcription on top of the PyTorch Whisper core.

Counterpart of hippomm_tpu/models/whisper/transcribe.py on one device: audio
is cut into 30 s windows, all windows of all inputs run as bucketed chunk
batches (4 / 16 / max), each batch runs mel → encoder → KV-cached greedy or
beam decode, and timestamp tokens give sub-chunk segment times when present.
`transcribe_many_async` queues every batch's mel and encoder work on the
device at once and returns a finisher that decodes and parses; the decode
loops read one flag per token to stop early, so they run in the finisher.
The greedy decode runs through the transcriber's model.DecodeGraphs, which
keeps one set of decode buffers per bucket shape across calls and, on CUDA,
a CUDA graph of the step that each position replays.

With a `mesh` (parallel/mesh.py) the weights are copied to each device of
the batch shards and a chunk batch that divides by data_axis_size splits
into one slab per shard (JAX's `_shard_chunks`): each shard runs its mel and
encoder on its device, the shards decode in lockstep with one read per
token for all of them, and the tokens come back to the first device. Beam
state is chunk-local, so the shards exchange nothing inside the loop.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

# greedy_decode and beam_decode_batch are importable from here, as from the JAX module
from hippomm_tpu_torch.models.whisper.model import (  # noqa: F401
    DecodeGraphs,
    WhisperConfig,
    beam_decode_batch,
    beam_decode_shards,
    encoder_forward,
    greedy_decode,
    greedy_decode_shards,
)
from hippomm_tpu_torch.ops.mel import WhisperMel
from hippomm_tpu_torch.parallel import mesh as pmesh
from hippomm_tpu_torch.utils import timers as tracing

logger = logging.getLogger(__name__)

CHUNK_SECONDS = 30.0
SAMPLE_RATE = 16000
TIME_PRECISION = 0.02  # seconds per timestamp token
_DECODE_WARNED = False  # one-shot tokenizer-failure warning


@dataclasses.dataclass
class Segment:
    start: float
    end: float
    text: str


class WhisperTranscriber:
    """Chunked, bucketed, batched transcription with the Whisper params on
    their device (on a mesh, the mesh's first device, and copied to the
    others). `tokenizer` None gives empty texts (segment times only)."""

    def __init__(
        self,
        params: Dict,
        cfg: WhisperConfig,
        tokenizer=None,
        dtype=torch.bfloat16,
        with_timestamps: bool = True,
        beam_size: int = 5,
        mesh=None,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.with_timestamps = with_timestamps
        self.beam_size = beam_size
        self.mesh = mesh
        if mesh is None:
            self.device = params["decoder"]["token_embedding"].device
            self._replicas = {self.device: params}
        else:
            self.device = pmesh.first_device(mesh)
            self._replicas = pmesh.replicate(params, mesh)
        self.params = self._replicas[self.device]
        self._mels = {dev: WhisperMel(n_mels=cfg.n_mels, device=dev) for dev in self._replicas}
        self.mel = self._mels[self.device]
        self._chunk_samples = int(CHUNK_SECONDS * SAMPLE_RATE)
        self._graphs = DecodeGraphs()  # the greedy decode's buffers and CUDA graphs, kept across calls

    def _shard_chunks(self, stacked: np.ndarray) -> List[torch.Tensor]:
        """The chunk batch as one slab per batch shard on its device, or
        whole on the first device without a mesh or when it does not
        divide."""
        parts = None if self.mesh is None else pmesh.shard_batch(stacked, self.mesh)
        return parts if parts is not None else [torch.from_numpy(stacked).to(self.device)]

    def _prompt(self) -> np.ndarray:
        c = self.cfg
        ids = [c.bos_token, c.lang_en_token, c.task_transcribe_token]
        if not self.with_timestamps:
            ids.append(c.no_timestamps_token)
        return np.asarray([ids], dtype=np.int32)

    def _decode_text(self, ids: List[int]) -> str:
        if self.tokenizer is None:
            return ""
        try:
            return self.tokenizer.decode(ids, skip_special_tokens=True).strip()
        except Exception:
            global _DECODE_WARNED
            if not _DECODE_WARNED:
                _DECODE_WARNED = True
                logger.exception(
                    "tokenizer decode failed — transcripts will be EMPTY "
                    "(mismatched vocab?); logged once"
                )
            return ""

    def _parse_segments(self, ids: List[int], offset: float) -> List[Segment]:
        """Split on timestamp tokens (ids > no_timestamps_token)."""
        c = self.cfg
        ts0 = c.no_timestamps_token
        segments: List[Segment] = []
        cur_start: Optional[float] = None
        cur: List[int] = []
        for tid in ids:
            if tid == c.eot_token:
                break
            if tid > ts0:
                t = (tid - ts0 - 1) * TIME_PRECISION
                if cur_start is None:
                    if cur:
                        # text decoded before the first timestamp (audio
                        # starting mid-utterance): seed it at the chunk start
                        segments.append(Segment(offset, offset + t, self._decode_text(cur)))
                        cur = []
                    cur_start = t
                else:
                    if cur:
                        segments.append(
                            Segment(offset + cur_start, offset + t, self._decode_text(cur))
                        )
                    cur_start, cur = t, []
            elif tid < ts0:
                cur.append(tid)
        if cur and cur_start is not None:
            segments.append(
                Segment(offset + cur_start, offset + CHUNK_SECONDS, self._decode_text(cur))
            )
        if not segments:
            text_ids = [i for i in ids if i < ts0 and i != c.eot_token]
            segments = [Segment(offset, offset + CHUNK_SECONDS, self._decode_text(text_ids))]
        return segments

    def transcribe(
        self, pcm: np.ndarray, sample_rate: int = SAMPLE_RATE, max_new_tokens: int = 224
    ) -> List[Segment]:
        """16 kHz mono float32 -> list of timestamped segments."""
        return self.transcribe_many([pcm], sample_rate, max_new_tokens)[0]

    def transcribe_many(
        self,
        pcms: List[np.ndarray],
        sample_rate: int = SAMPLE_RATE,
        max_new_tokens: int = 224,
        max_chunk_batch: int = 32,
    ) -> List[List[Segment]]:
        """Batched long-form transcription: all 30 s windows of all inputs in
        bucketed chunk batches — one batched mel, one encoder forward and one
        batched decode per bucket."""
        return self.transcribe_many_async(pcms, sample_rate, max_new_tokens, max_chunk_batch)()

    def transcribe_many_async(
        self,
        pcms: List[np.ndarray],
        sample_rate: int = SAMPLE_RATE,
        max_new_tokens: int = 224,
        max_chunk_batch: int = 32,
    ):
        """Queue every chunk batch's mel and encoder forward on the device
        now (the host returns as soon as they are queued) and return a
        zero-arg finisher that runs the decode loops and parses segments."""
        if sample_rate != SAMPLE_RATE:
            raise ValueError("resample to 16 kHz first")
        if self.beam_size > 1:
            # beam multiplies the decode rows (batch × beam) and their caches
            max_chunk_batch = min(max_chunk_batch, 16)
        # ---- split every input into 30 s windows ----
        chunks: List[np.ndarray] = []
        owners: List[int] = []  # input index per chunk
        offsets: List[float] = []  # chunk start time within its input
        durs: List[float] = []  # actual (unpadded) seconds in the chunk
        for oi, pcm in enumerate(pcms):
            pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
            for start in range(0, max(1, len(pcm)), self._chunk_samples):
                chunk = pcm[start : start + self._chunk_samples]
                durs.append(len(chunk) / SAMPLE_RATE)
                if len(chunk) < self._chunk_samples:
                    chunk = np.pad(chunk, (0, self._chunk_samples - len(chunk)))
                chunks.append(chunk)
                owners.append(oi)
                offsets.append(start / SAMPLE_RATE)

        prompt1 = self._prompt()
        plen = prompt1.shape[1]
        max_len = min(plen + max_new_tokens, self.cfg.max_target_positions)
        n_frames_target = 2 * self.cfg.max_source_positions  # 3000 for 30 s

        encoded = []  # (lo, n_real, [(params, encoder output, prompt) per shard])
        with torch.no_grad():
            for lo in range(0, len(chunks), max_chunk_batch):
                batch = chunks[lo : lo + max_chunk_batch]
                n = len(batch)
                # bucketed batch sizes (4 / 16 / max): one clip's 1-4 windows
                # do not pay for 32 encoder and decode rows
                b = next(t for t in (4, 16, max_chunk_batch) if n <= t or t == max_chunk_batch)
                b = min(b, max_chunk_batch)
                if b > n:
                    batch = batch + [batch[-1]] * (b - n)
                tracing.count("asr.chunks_launched", b)
                tracing.count("asr.chunks_real", n)
                shards = []
                for x in self._shard_chunks(np.stack(batch)):
                    params = self._replicas[x.device]
                    mels = self._mels[x.device](x)[:, :, :n_frames_target]
                    prompt = torch.from_numpy(np.repeat(prompt1, x.shape[0], axis=0)).to(x.device)
                    shards.append((params, encoder_forward(params, mels, self.cfg, self.dtype), prompt))
                encoded.append((lo, n, shards))

        def finish() -> List[List[Segment]]:
            results: List[List[Segment]] = [[] for _ in pcms]
            for lo, n, shards in encoded:
                out = self._decode(shards, max_len)
                # one read for the tokens and lengths of every shard
                both = pmesh.gather([torch.cat([t, ln[:, None]], 1) for t, ln in out], self.device)
                both = both.cpu().numpy()
                tokens, lengths = both[:, :-1], both[:, -1]
                for j in range(n):
                    ci = lo + j
                    ids = [int(t) for t in tokens[j][plen : int(lengths[j])]]
                    for s in self._parse_segments(ids, offsets[ci]):
                        s.end = min(s.end, offsets[ci] + durs[ci])  # clamp to real audio
                        if s.end > s.start:
                            results[owners[ci]].append(s)
            return results

        return finish

    def _decode(self, shards, max_len: int) -> List[tuple]:
        """Each shard's (tokens, lengths) of its best hypothesis, the shards
        decoded in lockstep (greedy, or beam)."""
        if self.beam_size > 1:
            out = beam_decode_shards(shards, self.cfg, max_len=max_len, beam=self.beam_size,
                                     dtype=self.dtype)
            return [(t[:, 0], ln[:, 0]) for t, ln, _ in out]  # best hypothesis
        return self._graphs.decode(shards, self.cfg, max_len=max_len, dtype=self.dtype)
