"""Foundation model wrappers — the reference-compatible model surface.

Counterpart of hippomm_tpu/models/foundation.py on top of the PyTorch
towers:

  * ImageBind.encode_vision / encode_audio — fixed-size chunked device
    forwards (a 128-wide bulk tier and a 32-wide tier for vision, as the JAX
    wrapper, so both packages batch frames the same way); vision_stream —
    the same tower fed incrementally during extraction; encode_text /
    encode_text_device — tokenizer (CLIP BPE or the hashing fallback) and
    the text tower, the second leaving the embedding on the device
  * Whisper.transcribe / transcribe_batch / transcribe_async — the Whisper
    transcriber (models/whisper) from a checkpoint, from random weights
    (`random_init`, or variant "tiny"), or the deterministic stub
  * QwenVL.generate — OpenAI-protocol HTTP client or stub
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from hippomm_tpu_torch.config import Config
from hippomm_tpu_torch.models.clients import ChatClient, make_client
from hippomm_tpu_torch.models.imagebind import model as ib_model
from hippomm_tpu_torch.models.imagebind.preprocess import load_tokenizer, preprocess_audio
from hippomm_tpu_torch.models.whisper import model as wh_model
from hippomm_tpu_torch.models.whisper.transcribe import Segment, WhisperTranscriber
from hippomm_tpu_torch.ops.resize import normalize_nchw, resize_crop_u8
from hippomm_tpu_torch.utils.device import fetch, resolve_device

logger = logging.getLogger(__name__)

CHUNK = 32
BIG_CHUNK = 128  # bulk tier for the vision tower (see encode_vision)


class ImageBind:
    """Joint-embedding model wrapper (reference surface: extract_features).

    Weights come from `params` (e.g. carry.params_from_jax), else from the
    checkpoint at `model_path` (the file, or a directory holding
    imagebind_huge.pth or model.safetensors; imagebind.convert), else a
    random init from `seed`. Runs on CUDA unless `device` says otherwise."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        variant: str = "huge",
        dtype=torch.bfloat16,
        seed: int = 0,
        device=None,
        params: Optional[Dict] = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and dtype != torch.bfloat16:
            # every encoder block runs K1/K2, whose CUDA kernels are bf16 only
            raise NotImplementedError(
                f"ImageBind on CUDA runs in bfloat16 (models.compute_dtype); got {dtype}"
            )
        self.cfg = ib_model.get_config(variant)
        self.dtype = dtype
        ckpt = None
        if params is None and model_path:
            for cand in (
                model_path,
                os.path.join(model_path, "imagebind_huge.pth"),
                os.path.join(model_path, "model.safetensors"),
            ):
                if os.path.isfile(cand):
                    ckpt = cand
                    break
        if params is not None:
            self.params = params
        elif ckpt:
            from hippomm_tpu_torch.models.imagebind.convert import load_imagebind

            logger.info("loading ImageBind checkpoint: %s", ckpt)
            self.params = load_imagebind(ckpt, self.cfg, self.device, dtype)
        else:
            if variant == "huge":
                logger.warning(
                    "no ImageBind checkpoint at %s — random-init weights "
                    "(embeddings are structurally valid but not semantic)",
                    model_path,
                )
            self.params = ib_model.init_imagebind(self.cfg, self.device, dtype, seed)
        # model_path may be the checkpoint file: the BPE vocab sits next to it
        tok_dir = model_path
        if tok_dir and os.path.isfile(tok_dir):
            tok_dir = os.path.dirname(tok_dir)
        self.tokenizer = load_tokenizer(
            tok_dir, vocab_size=self.cfg.vocab_size, context_length=self.cfg.context_length
        )

    @torch.no_grad()
    def _vision_chunk(self, crops_u8: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(crops_u8).to(self.device)
        return ib_model.vision_forward(self.params, normalize_nchw(x), self.cfg, self.dtype)

    def encode_vision(self, frames: Union[np.ndarray, Sequence[str]]) -> np.ndarray:
        """uint8 (N, H, W, 3) frames or JPEG paths -> (N, 1024) fp32, in
        fixed-size chunks (128-wide bulk tier + 32-wide remainder); frames
        are resized+cropped on the host so only S×S uint8 crops are
        uploaded."""
        if len(frames) == 0:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        if isinstance(frames[0], str):
            from hippomm_tpu_torch.media.io import read_jpeg

            frames = np.stack([read_jpeg(p) for p in frames])
        frames = resize_crop_u8(frames, self.cfg.image_size)
        n = frames.shape[0]
        outs = []
        lo = 0
        while lo < n:
            size = BIG_CHUNK if n - lo >= BIG_CHUNK else CHUNK
            chunk = frames[lo : lo + size]
            m = len(chunk)
            lo += m
            if m < size:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], size - m, axis=0)])
            outs.append(self._vision_chunk(chunk)[:m])
        return fetch(torch.cat(outs), dtype=np.float32)

    def vision_stream(self) -> "VisionEncodeStream":
        """Incremental encode_vision for producers that discover frames over
        time (the extractor's keyframe flushes): every full 32-frame chunk
        is queued on the device at once, so the vision tower runs while the
        host still decodes the rest of the video."""
        return VisionEncodeStream(self)

    @torch.no_grad()
    def encode_audio(self, pcm: np.ndarray, clips_per_video: int = 3) -> np.ndarray:
        """16 kHz mono float32 -> (1, 1024) fp32 (clip-ensembled)."""
        mel = preprocess_audio(
            pcm,
            mel_bins=self.cfg.audio_mel_bins,
            target_len=self.cfg.audio_target_len,
            clips_per_video=clips_per_video,
            device=self.device,
        )
        return fetch(ib_model.audio_forward(self.params, mel, self.cfg, self.dtype), dtype=np.float32)

    def encode_text(self, texts: Sequence[str]) -> np.ndarray:
        """list[str] -> (N, 1024) fp32 on the host."""
        if not texts:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        return fetch(self.encode_text_device(texts), dtype=np.float32)

    @torch.no_grad()
    def encode_text_device(self, texts: Sequence[str]) -> torch.Tensor:
        """list[str] -> (N, 1024) fp32 tensor left on the device: retrieval
        feeds it straight into the top-k, so a query reads back only the
        top-k result."""
        tokens = torch.from_numpy(self.tokenizer(list(texts))).to(self.device)
        return ib_model.text_forward(self.params, tokens, self.cfg, self.dtype)

    def extract_features(self, inputs: Dict[str, object]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        if "vision" in inputs:
            out["vision"] = self.encode_vision(inputs["vision"])
        if "audio" in inputs:
            out["audio"] = self.encode_audio(np.asarray(inputs["audio"]))
        if "text" in inputs:
            out["text"] = self.encode_text(inputs["text"])
        return out


class VisionEncodeStream:
    """Incremental form of `ImageBind.encode_vision`.

    The extractor feeds kept frames as their scan masks are read; a worker
    thread resizes and crops them on the host and queues the tower forward
    of every full 32-frame chunk, so the tower runs behind the decode and
    `result()` is mostly a read-back. `finalize()` queues the (<32-frame)
    remainder once the last frame is fed, ahead of whatever the next video
    queues.

    `result()` returns (N, 1024) fp32 in feed order. A forward is
    row-independent and pad rows are never returned, so rows equal
    `encode_vision` over the concatenation up to the rounding of a 32-wide
    batch against its 128-wide bulk tier.

    One worker keeps feed order. Grad mode is per thread, so the worker
    enters `torch.no_grad()` itself; it queues on its thread's current
    stream (the default stream)."""

    def __init__(self, ib: ImageBind):
        self._ib = ib
        self._buf: List[np.ndarray] = []  # worker thread only (until drain)
        self._buffered = 0  # worker thread only (until drain)
        self._handles: List[tuple] = []  # (n_real, device tensor); worker only
        self._val: Optional[np.ndarray] = None
        self._n_fed = 0
        self._pool = None
        self._jobs: List = []
        self._finalized = False

    def feed(self, frames_u8: np.ndarray) -> None:
        """Append uint8 (M, H, W, 3) frames; the worker thread resizes them
        and queues every full 32-chunk."""
        if self._val is not None or self._finalized:
            raise RuntimeError("VisionEncodeStream.feed() after result()/finalize()/close()")
        if frames_u8 is None or len(frames_u8) == 0:
            return
        frames_u8 = np.asarray(frames_u8)
        self._n_fed += len(frames_u8)
        if self._pool is None:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._jobs.append(self._pool.submit(self._ingest, frames_u8))

    def _ingest(self, frames_u8: np.ndarray) -> None:
        if self._val is not None:
            return  # closed while this job sat in the queue
        with torch.no_grad():
            self._buf.append(resize_crop_u8(frames_u8, self._ib.cfg.image_size))
            self._buffered += len(self._buf[-1])
            while self._buffered >= CHUNK:
                flat = np.concatenate(self._buf) if len(self._buf) > 1 else self._buf[0]
                self._dispatch(flat[:CHUNK])
                rest = flat[CHUNK:]
                self._buf = [rest] if len(rest) else []
                self._buffered = len(rest)

    def _drain_remainder(self) -> None:
        if self._buffered:
            flat = np.concatenate(self._buf) if len(self._buf) > 1 else self._buf[0]
            self._dispatch(flat)
            self._buf, self._buffered = [], 0

    def finalize(self) -> None:
        """Queue the (<32-frame) remainder now, without reading back.
        Idempotent; further feeds raise."""
        if self._val is not None or self._finalized:
            return
        self._finalized = True
        if self._pool is None:
            return  # nothing was ever fed

        def _drain():
            if self._val is None:  # not closed while queued
                self._drain_remainder()

        self._jobs.append(self._pool.submit(_drain))

    def _dispatch(self, chunk: np.ndarray) -> None:
        m = len(chunk)
        if m < CHUNK:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], CHUNK - m, axis=0)])
        self._handles.append((m, self._ib._vision_chunk(chunk)))

    @property
    def frames_fed(self) -> int:
        return self._n_fed

    def close(self) -> None:
        """Abandon the stream without joining the worker (error paths):
        buffered frames and queued outputs are dropped. Safe to call twice or
        after result(); feed() after close raises."""
        if self._val is None:
            self._val = np.zeros((0, self._ib.cfg.embed_dim), np.float32)
        self._jobs = []
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        self._buf, self._buffered = [], 0
        self._handles = []

    def result(self) -> np.ndarray:
        """Drain the worker, queue the remainder, read back, concatenate."""
        if self._val is None:
            for j in self._jobs:  # drain; re-raises a worker failure here
                j.result()
            self._jobs = []
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
            self._drain_remainder()
            fed = sum(m for m, _ in self._handles)
            assert fed == self._n_fed, (fed, self._n_fed)
            self._val = (
                fetch(torch.cat([h[:m] for m, h in self._handles]), dtype=np.float32)
                if self._handles
                else np.zeros((0, self._ib.cfg.embed_dim), np.float32)
            )
            self._handles = []
        return self._val


class StubWhisperSegments:
    """Deterministic transcription stub: emits per-5 s segments describing the
    audio's measured energy, so hermetic pipelines get stable non-empty text."""

    def transcribe(self, pcm: np.ndarray, sample_rate: int = 16000) -> List[Segment]:
        pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
        segs: List[Segment] = []
        step = 5 * sample_rate
        for i, start in enumerate(range(0, len(pcm), step)):
            chunk = pcm[start : start + step]
            rms = float(np.sqrt(np.mean(chunk**2))) if len(chunk) else 0.0
            if rms < 1e-4:
                text = ""
            else:
                text = f"Tone segment {i} with level {rms:.2f}."
            segs.append(
                Segment(start / sample_rate, min(len(pcm), start + step) / sample_rate, text)
            )
        return [s for s in segs if s.text]


class Whisper:
    """ASR wrapper (reference surface: transcribe with timestamps; feature
    extraction deliberately unsupported). The variant logic of the JAX
    wrapper: an explicit checkpoint path loads (or raises), variant "stub"
    is the stub, "tiny" or `random_init` builds random weights from `seed`
    at the variant's full width, and the default without a checkpoint falls
    back to the stub. `params` (e.g. from whisper.carry.params_from_jax)
    replaces the random init. The tower runs on CUDA unless `device` says
    otherwise; on CUDA in bfloat16 only (its encoder blocks run K1/K2)."""

    def __init__(
        self,
        model_name: str = "distil-large-v3",
        model_path: Optional[str] = None,
        variant: Optional[str] = None,
        dtype=torch.bfloat16,
        seed: int = 0,
        random_init: bool = False,
        beam_size: int = 5,
        device=None,
        params: Optional[Dict] = None,
    ):
        self.model_name = model_name
        variant = variant or model_name
        ckpt = None
        if model_path:
            for cand in (
                model_path,
                os.path.join(model_path, "pytorch_model.bin"),
                os.path.join(model_path, "model.safetensors"),
                os.path.join(model_path, "whisper.pth"),
            ):
                if os.path.isfile(cand):
                    ckpt = cand
                    break
            if ckpt is None:
                # an explicit checkpoint path that loads nothing fails loudly
                # instead of filling stores with stub transcripts
                raise FileNotFoundError(
                    f"models.whisper_path={model_path!r}: no checkpoint found "
                    "(looked for the path itself, pytorch_model.bin, "
                    "model.safetensors, whisper.pth)"
                )
        self.cfg = None
        if variant == "stub":
            self._impl = StubWhisperSegments()
        elif ckpt or params is not None or variant == "tiny" or random_init:
            self.device = resolve_device(device)
            if self.device.type == "cuda" and dtype != torch.bfloat16:
                raise NotImplementedError(f"Whisper on CUDA runs in bfloat16; got {dtype}")
            self.cfg = wh_model.get_config(variant)
            if ckpt:
                from hippomm_tpu_torch.models.whisper.convert import load_whisper

                params = load_whisper(ckpt, self.cfg, self.device, dtype)
                tokenizer = _try_whisper_tokenizer(model_path)
            else:
                # random weights: the real compute path at the variant's width
                if params is None:
                    params = wh_model.init_whisper(self.cfg, self.device, dtype, seed)
                tokenizer = None
            self._impl = WhisperTranscriber(params, self.cfg, tokenizer, dtype, beam_size=beam_size)
        else:
            logger.warning("no Whisper checkpoint — using deterministic stub transcriber")
            self._impl = StubWhisperSegments()

    def transcribe(self, audio: Union[str, np.ndarray], sample_rate: int = 16000) -> List[Segment]:
        """PCM at `sample_rate`, or the path of a WAV file (read as 16 kHz
        mono) -> timestamped segments."""
        if isinstance(audio, str):
            from hippomm_tpu_torch.media.io import load_audio_mono16k

            audio = load_audio_mono16k(audio)
            sample_rate = 16000
        return self._impl.transcribe(np.asarray(audio, dtype=np.float32), sample_rate)

    def transcribe_batch(
        self, audios: Sequence[np.ndarray], sample_rate: int = 16000
    ) -> List[List[Segment]]:
        """Many clips in bucketed chunk batches: one encoder forward and one
        batched decode per bucket."""
        pcms = [np.asarray(a, dtype=np.float32) for a in audios]
        if hasattr(self._impl, "transcribe_many"):
            return self._impl.transcribe_many(pcms, sample_rate)
        return [self._impl.transcribe(p, sample_rate) for p in pcms]

    def transcribe_async(self, audio: np.ndarray, sample_rate: int = 16000):
        """Queue the transcription's device work now; returns a zero-arg
        finisher (None for the stub — nothing to overlap)."""
        if hasattr(self._impl, "transcribe_many_async"):
            inner = self._impl.transcribe_many_async([np.asarray(audio, dtype=np.float32)], sample_rate)
            return lambda: inner()[0]
        return None

    def __call__(self, *a, **k):
        raise NotImplementedError(
            "Whisper is transcription-only; use ImageBind for audio features"
        )


def _try_whisper_tokenizer(model_path: Optional[str]):
    """The checkpoint directory's tokenizer, or None (empty texts) where
    `transformers` or the tokenizer files are absent."""
    if not model_path:
        return None
    try:
        from transformers import WhisperTokenizerFast

        return WhisperTokenizerFast.from_pretrained(model_path, local_files_only=True)
    except Exception:
        return None


class QwenVL:
    """VLM client wrapper (reference surface: generate). Base urls come from
    config; `mode: "stub"` runs without any endpoint."""

    def __init__(self, model_name: Optional[str] = None, config: Optional[Config] = None):
        cfg = config or Config()
        self.client: ChatClient = make_client(cfg.api.qwen, cfg.api.mode, purpose="qwen-vl")
        self.model_name = model_name or cfg.api.qwen.model_name

    def generate(
        self,
        prompt: Union[str, List[Dict]],
        images: Optional[Sequence[bytes]] = None,
        max_tokens: int = 512,
        max_new_tokens: Optional[int] = None,
    ) -> str:
        """Text (+ optional jpeg images) -> completion. Accepts the
        reference's generate(messages, max_new_tokens=...) convention for
        messages without video items (those need the media shim)."""
        if max_new_tokens is not None:
            max_tokens = max_new_tokens
        if isinstance(prompt, list):
            return self.client.chat(prompt, max_tokens=max_tokens)
        content: List[Dict] = [{"type": "text", "text": prompt}]
        import base64 as b64

        for data in images or []:
            content.append(
                {
                    "type": "image_url",
                    "image_url": {"url": "data:image/jpeg;base64," + b64.b64encode(data).decode()},
                }
            )
        return self.client.chat([{"role": "user", "content": content}], max_tokens=max_tokens)
