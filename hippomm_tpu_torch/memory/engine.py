"""HippocampalMemory — the memory engine (reference: hippocampal_memory.py:214-1612).

Counterpart of hippomm_tpu/memory/engine.py. Same stages, same store
format:

  * temporal pattern separation: device SSIM over all adjacent frame pairs
    plus host audio RMS, then the greedy walk (segmentation.py)
  * perceptual encoding: all segments' frames through the ImageBind vision
    tower in fixed chunks; all segments' audio clips through one fbank pass
    and the audio trunk in 32-segment chunks; the full track through
    Whisper once, its segments assigned to STMs by midpoint
  * consolidation: key-frame dedup (consolidation.py)
  * semantic replay: captions and a summary through the clients (or stub),
    persisted as a ThetaEvent

Per-video STM checkpoints are written after encoding and resumed at the top
of process_sequence, as in the JAX engine. A device fault raises.

Device mesh: as the JAX engine does over jax.devices(), the engine builds a
data-parallel mesh (parallel/mesh.py) over its local devices from
system.mesh_data / mesh_model / mesh_replicas — the caller's `devices`, or
every local CUDA device when the caller names no `device` — and both towers
encode data-parallel over it. One device gives no mesh: a caller who names
a `device` gets that device alone. A config that asks for more devices
than exist warns and runs on one device; a mesh that fails to build raises.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hippomm_tpu_torch.config import Config
from hippomm_tpu_torch.memory.consolidation import consolidate_short_term_memory
from hippomm_tpu_torch.memory.schema import SequenceSegment, ShortTermMemory, ThetaEvent
from hippomm_tpu_torch.memory.segmentation import segment_sequence
from hippomm_tpu_torch.memory.store import MemoryStore
from hippomm_tpu_torch.models.clients import make_client
from hippomm_tpu_torch.models.foundation import ImageBind, QwenVL, Whisper
from hippomm_tpu_torch.models.imagebind.preprocess import preprocess_audio_batch
from hippomm_tpu_torch.models.whisper.transcribe import Segment
from hippomm_tpu_torch.parallel import mesh as pmesh
from hippomm_tpu_torch.utils.device import fetch, resolve_device
from hippomm_tpu_torch.utils import timers as tracing
from hippomm_tpu_torch.utils.timers import StageTimer

logger = logging.getLogger(__name__)

CAPTION_PROMPT = "Describe this image in one concise sentence."
AUDIO_CHUNK = 32  # segments per audio-trunk forward


def process_frame_with_api(frame, index, model_name=None, config=None):
    """Caption one frame file through the configured frame-captioning
    endpoint: (index, "Frame {index+1}: <caption>"), or the reference's
    error placeholders, as hippomm_tpu.memory.engine.process_frame_with_api.
    `config` is a Config or a dict of its sections; `model_name` is accepted
    for the reference's signature (the endpoint's config names the model)."""
    try:
        if not os.path.exists(frame):
            return index, f"[Error: Image file not found: {frame}]"
        with open(frame, "rb") as f:
            jpeg = f.read()
        if isinstance(config, Config):
            cfg = config
        else:
            from hippomm_tpu_torch.config import _update_dataclass

            cfg = _update_dataclass(Config(), dict(config or {}))
        client = make_client(cfg.api.frame_processing, cfg.api.mode, purpose="frame-captioning")
        caption = client.caption_images([jpeg], CAPTION_PROMPT)[0]
        return index, f"Frame {index + 1}: {caption}"
    except Exception:
        logger.exception("Error processing image %s", frame)
        return index, f"[Error processing image {frame}]"


class HippocampalMemory:
    def __init__(
        self,
        config: Optional[Config] = None,
        imagebind_path: Optional[str] = None,
        whisper_model: Optional[str] = None,
        qwen_path: Optional[str] = None,
        models: Optional[Dict] = None,
        device=None,
        devices=None,
    ):
        """`device`: where the engine runs (CUDA unless the caller says
        otherwise; the first of `devices` when only those are given). A
        named `device` and no `devices` pins the engine to that device (no
        mesh). `devices`: the local devices a mesh may span (a device may
        repeat); with neither given, every CUDA device of the host, as
        jax.devices()."""
        self.config = config or Config()
        if device is None and devices is not None:
            device = devices[0]
        self.device = resolve_device(device)
        self.mesh = self._make_mesh(pmesh.local_devices(devices, device))
        if self.mesh is not None:
            self.device = resolve_device(pmesh.first_device(self.mesh))
        m = self.config.models
        p = self.config.processing

        # engine parameters (reference defaults, hippocampal_memory.py:253-266)
        self.max_short_term = self.config.memory.max_short_term
        self.max_long_term = self.config.memory.max_long_term
        self.frame_buffer_size = p.frame_buffer_size
        self.max_segment_duration = p.max_segment_duration
        self.min_segment_duration = p.min_segment_duration
        self.frame_similarity_threshold = p.frame_similarity_threshold
        self.audio_silence_threshold = p.audio_silence_threshold
        self.keyframe_dedup_threshold = p.keyframe_dedup_threshold
        self.evict_stm_after_replay = self.config.memory.evict_after_replay

        # foundation models (injectable for tests)
        models = models or {}
        self.imagebind: ImageBind = models.get("imagebind") or ImageBind(
            model_path=imagebind_path or m.imagebind_path,
            variant=m.imagebind_variant,
            dtype=getattr(torch, m.compute_dtype),
            device=self.device,
            mesh=self.mesh,
        )
        self.whisper: Whisper = models.get("whisper") or Whisper(
            model_name=whisper_model or m.whisper_model,
            variant=m.whisper_variant,
            model_path=getattr(m, "whisper_path", "") or None,
            random_init=m.whisper_random_init,
            beam_size=m.whisper_beam_size,
            device=self.device,
            mesh=self.mesh,
        )
        self.qwen: QwenVL = models.get("qwen") or QwenVL(
            model_name=qwen_path or m.qwen_path, config=self.config
        )
        self.frame_client = models.get("frame_client") or make_client(
            self.config.api.frame_processing, self.config.api.mode, purpose="frame-captioning"
        )

        # memory state
        self.short_term_buffer: Dict[str, List[ShortTermMemory]] = {}
        self.long_term_store: List[ThetaEvent] = []
        self.consolidated: Dict[str, Dict] = {}
        self._frame_buffer: Dict[str, List] = {}  # video_id -> [(path, time)]
        self._full_audio: Dict[str, np.ndarray] = {}
        self._full_transcript: Dict[str, List] = {}  # video_id -> [Segment]
        self._transcript_full_track: set = set()  # _full_transcript covers whole video
        self._asr_futures: Dict[str, object] = {}  # video_id -> full-track ASR finisher
        # videos whose process_sequence buffered STMs but never finished its
        # checkpoint — a FAILED attempt's leftovers, discarded on retry
        self._inflight_ingests: set = set()

        self.store = MemoryStore(
            self.config.storage.base_dir,
            features_format=getattr(self.config.storage, "features_format", "json"),
        )
        self.timers = StageTimer()

    def _make_mesh(self, devs: List[torch.device]) -> Optional[pmesh.Mesh]:
        """The data-parallel mesh of system.mesh_* over `devs` (JAX engine:
        mesh_data None = every device left after model × replicas); None on
        one device, or with a warning when the config needs more devices
        than there are. No fallback: a mesh that fails to build raises."""
        sys_cfg = self.config.system
        n_dev = len(devs)
        reps = max(1, sys_cfg.mesh_replicas)
        model = max(1, sys_cfg.mesh_model)
        denom = model * reps
        data = sys_cfg.mesh_data or (n_dev // denom)
        total = data * denom
        if data >= 1 and 1 < total <= n_dev:
            return pmesh.make_mesh(total, model_parallel=model, devices=devs, dcn_replicas=reps)
        if total > n_dev or data < 1:
            # data < 1: replicas × model alone exceed the device count
            logger.warning(
                "configured mesh replicas=%d x data=%d x model=%d needs %d devices but only "
                "%d are available — running single-device",
                reps, data, model, max(total, denom), n_dev,
            )
        return None

    # ------------------------------------------------------------------ ingest

    def add_video(self, video_id: str, video_path: str = "") -> None:
        """Register a video (reference: hippocampal_memory.py:1277-1288)."""
        self.store.add_video(video_id, video_path)
        self.short_term_buffer.setdefault(video_id, [])

    def process_sequence(
        self,
        video_id: str,
        frame_paths: Optional[Sequence[str]] = None,
        frame_times: Optional[Sequence[float]] = None,
        frames_rgb: Optional[np.ndarray] = None,
        audio_data: Optional[np.ndarray] = None,
        sample_rate: int = 16000,
        video_duration: Optional[float] = None,
        auto_consolidate: bool = True,
        base_time: float = 0.0,
        frame_ssim: Optional[np.ndarray] = None,
        resume: bool = True,
        vision_stream=None,
    ) -> List[ShortTermMemory]:
        """Segment + perceptually encode a video's frames/audio into STMs
        (reference: hippocampal_memory.py:1116-1275). Takes in-memory RGB
        frames, or decodes the `frame_paths` JPEGs when `frames_rgb` is None.
        `base_time` offsets every produced timestamp (chunked long videos).
        `vision_stream` carries tower forwards already queued during
        extraction (one row per frames_rgb row, in order); the vision encode
        is then a read-back."""
        with tracing.video(video_id):
            return self._process_sequence_impl(
                video_id, frame_paths, frame_times, frames_rgb, audio_data,
                sample_rate, video_duration, auto_consolidate, base_time,
                frame_ssim, resume, vision_stream,
            )

    def _process_sequence_impl(
        self, video_id, frame_paths, frame_times, frames_rgb, audio_data,
        sample_rate, video_duration, auto_consolidate, base_time, frame_ssim, resume,
        vision_stream=None,
    ) -> List[ShortTermMemory]:
        # checkpoint fast-path (reference :1136-1150)
        if resume and self.store.has_checkpoint(video_id):
            stms = self.store.load_checkpoint(video_id)
            if stms and video_duration:
                # a PARTIAL checkpoint must not fast-path into a truncated event
                covered = max(
                    float(s.segment_info.get("end_time", 0.0) or 0.0) for s in stms
                )
                if covered < float(video_duration) - max(30.0, 0.1 * float(video_duration)):
                    logger.warning(
                        "%s: checkpoint covers %.0fs of %.0fs — partial; re-encoding",
                        video_id, covered, video_duration,
                    )
                    stms = None
            if stms:
                logger.info("resumed %d STMs from checkpoint for %s", len(stms), video_id)
                self.short_term_buffer[video_id] = stms
                if audio_data is not None:
                    self._full_audio[video_id] = np.asarray(audio_data, np.float32)
                # a full-track ASR queued for this ingest is consumed here, so
                # replay reuses it instead of transcribing the track again
                fut = self._asr_futures.pop(video_id, None)
                if fut is not None:
                    with self.timers.stage("transcribe"):
                        self._full_transcript[video_id] = list(fut.result())
                    self._transcript_full_track.add(video_id)
                if auto_consolidate:
                    self.consolidate(video_id)
                    self.replay(video_id)
                return stms

        # a fresh ingest must not extend() onto STMs of a FAILED earlier attempt
        if (
            resume
            and base_time == 0
            and video_id in self._inflight_ingests
            and self.short_term_buffer.get(video_id)
        ):
            logger.warning(
                "%s: discarding %d stale STMs from a previous failed attempt",
                video_id, len(self.short_term_buffer[video_id]),
            )
            self.short_term_buffer[video_id] = []

        frame_paths = list(frame_paths) if frame_paths is not None else []
        frame_times = list(frame_times) if frame_times is not None else []
        if frames_rgb is None and frame_paths:
            from hippomm_tpu_torch.media.io import read_jpeg

            frames_rgb = np.stack([read_jpeg(fp) for fp in frame_paths])
        if audio_data is not None:
            audio_data = np.asarray(audio_data, dtype=np.float32)
            # keep the longest known track: a chunk must not replace the full
            # track dispatch_asr registered
            prev = self._full_audio.get(video_id)
            if prev is None or len(audio_data) > len(prev):
                self._full_audio[video_id] = audio_data

        with self.timers.stage("segmentation"):
            segments = segment_sequence(
                frame_paths,
                frame_times,
                frames_rgb,
                audio_data,
                sample_rate=sample_rate,
                max_segment=self.max_segment_duration,
                min_segment=self.min_segment_duration,
                ssim_threshold=self.frame_similarity_threshold,
                silence_db=self.audio_silence_threshold,
                duration=video_duration,
                precomputed_ssim=frame_ssim,
                device=self.device,
            )
        logger.info("%s: %d segments", video_id, len(segments))

        if base_time:
            for seg in segments:
                seg.start_time += base_time
                seg.end_time += base_time
                seg.frame_times = [t + base_time for t in seg.frame_times]
            frame_times = [t + base_time for t in frame_times]

        stms = self._encode_segments(
            video_id, segments, frames_rgb, frame_times, sample_rate,
            base_time=base_time, call_audio=audio_data, vision_stream=vision_stream,
        )
        self._inflight_ingests.add(video_id)
        self.short_term_buffer.setdefault(video_id, []).extend(stms)

        with self.timers.stage("checkpoint"):
            self.store.save_checkpoint(video_id, self.short_term_buffer[video_id])
        self._inflight_ingests.discard(video_id)

        if auto_consolidate:
            self.consolidate(video_id)
            self.replay(video_id)
        return stms

    @torch.no_grad()
    def _encode_audio(self, pcm_batch: List[np.ndarray]) -> torch.Tensor:
        """All segments' audio -> (n, 1024) on the device, not read back: one
        fbank pass, then the audio trunk in fixed 32-segment chunks (the last
        padded by repetition)."""
        ib = self.imagebind
        mels = preprocess_audio_batch(
            pcm_batch,
            mel_bins=ib.cfg.audio_mel_bins,
            target_len=ib.cfg.audio_target_len,
            device=ib.device,
        )
        outs = []
        for lo in range(0, mels.shape[0], AUDIO_CHUNK):
            part = mels[lo : lo + AUDIO_CHUNK]
            n_real = part.shape[0]
            if n_real < AUDIO_CHUNK:
                part = torch.cat([part, part[-1:].expand(AUDIO_CHUNK - n_real, *part.shape[1:])])
            tracing.count("audio.rows_launched", AUDIO_CHUNK)
            tracing.count("audio.rows_real", n_real)
            # sharded over the mesh's batch split, as the JAX engine's chunks
            outs.append(ib._run(ib._audio_forward, part)[:n_real])
        return torch.cat(outs)

    def _encode_segments(
        self,
        video_id: str,
        segments: List[SequenceSegment],
        frames_rgb: Optional[np.ndarray],
        frame_times: Sequence[float],
        sample_rate: int,
        base_time: float = 0.0,
        call_audio: Optional[np.ndarray] = None,
        vision_stream=None,
    ) -> List[ShortTermMemory]:
        """Perceptual encoding, batched across segments."""
        ft = np.asarray(list(frame_times), dtype=np.float64)
        seg_frame_idx: List[np.ndarray] = []
        for seg in segments:
            if len(ft):
                idx = np.nonzero((ft >= seg.start_time) & (ft < seg.end_time))[0]
            else:
                idx = np.zeros((0,), int)
            seg_frame_idx.append(idx)

        # ---- audio features: every segment with ≥ 100 ms of audio ----
        audio_embs: Dict[int, np.ndarray] = {}
        pcm_batch, mel_owner = [], []
        for si, seg in enumerate(segments):
            a = seg.audio_data
            if a is None or len(a) < sample_rate // 10:
                continue
            peak = float(np.max(np.abs(a))) or 1.0
            pcm_batch.append(a / peak)
            mel_owner.append(si)
        audio_dev = None
        if pcm_batch:
            with self.timers.stage("encode_audio"):
                audio_dev = self._encode_audio(pcm_batch)

        # ---- call_audio ASR: queue it now, collect it at the transcribe
        # stage below. After the audio trunk's work (whose read-back must not
        # wait behind the ASR) and before any read-back, so the device runs
        # the Whisper encoder while the host resizes and uploads frames. Not
        # when a full-track pass was dispatched (dispatch_asr), nor for a
        # later chunk after one.
        has_call_audio = call_audio is not None and len(call_audio) >= sample_rate // 10
        asr_finish = None
        if (video_id not in self._asr_futures
                and not (video_id in self._transcript_full_track and base_time)
                and has_call_audio):
            asr_finish = self.whisper.transcribe_async(call_audio, sample_rate)

        # ---- vision: one encode over the concatenation of all segments ----
        vision_feats: Optional[np.ndarray] = None
        if (frames_rgb is None or not len(frames_rgb)) and vision_stream is not None:
            # no vision track to index into: release what the stream queued
            vision_stream.close()
        if frames_rgb is not None and len(frames_rgb):
            all_idx = np.concatenate(seg_frame_idx) if seg_frame_idx else np.zeros((0,), int)
            # the tower rows whose features the engine keeps (of every row
            # the vision tower ran: vision.rows_launched)
            tracing.count("vision.rows_kept", len(all_idx))
            feats_all = None
            if vision_stream is not None:
                # forwards queued during extraction, one row per frames_rgb
                # row; a stream of another length is discarded, not indexed
                with self.timers.stage("encode_vision"):
                    feats_all = vision_stream.result()
                if feats_all.shape[0] != len(frames_rgb):
                    logger.warning(
                        "%s: vision prefetch has %d rows for %d frames — re-encoding",
                        video_id, feats_all.shape[0], len(frames_rgb),
                    )
                    feats_all = None
            if feats_all is not None:
                vision_feats = feats_all[all_idx]
            else:
                with self.timers.stage("encode_vision"):
                    vision_feats = self.imagebind.encode_vision(np.asarray(frames_rgb)[all_idx])

        if audio_dev is not None:
            with self.timers.stage("encode_audio"):
                embs = fetch(audio_dev, dtype=np.float32)
            for si, e in zip(mel_owner, embs):
                audio_embs[si] = e[None]

        # ---- transcription: ONE full-track ASR pass, assigned by midpoint ----
        transcripts: Dict[int, List[Dict]] = {}
        asr_segs = None
        fut = self._asr_futures.pop(video_id, None)
        if fut is not None:  # full-track pass dispatched earlier (global times)
            with self.timers.stage("transcribe"):
                asr_segs = fut.result()
            self._full_transcript[video_id] = list(asr_segs)
            self._transcript_full_track.add(video_id)
        elif video_id in self._transcript_full_track and base_time:
            # chunked flow after a full-track dispatch: reuse, don't re-run
            asr_segs = self._full_transcript[video_id]
        elif has_call_audio:
            with self.timers.stage("transcribe"):
                local = (asr_finish() if asr_finish is not None
                         else self.whisper.transcribe(call_audio, sample_rate))
            asr_segs = [
                Segment(s.start + base_time, s.end + base_time, s.text) for s in local
            ] if base_time else local
            if base_time:
                # chunked flow: accumulate chunks in global time
                self._full_transcript.setdefault(video_id, []).extend(asr_segs)
            else:
                # a fresh pass over the video's start: reset, so a retried
                # video's transcript does not stack on the failed attempt's
                self._full_transcript[video_id] = list(asr_segs)
                self._transcript_full_track.discard(video_id)
        if asr_segs is not None:
            for si, seg in enumerate(segments):
                lo, hi = seg.start_time, seg.end_time
                entries = [
                    {"text": s.text, "start": float(s.start), "end": float(s.end)}
                    for s in asr_segs
                    if s.text and lo <= (s.start + s.end) / 2 < hi
                ]
                if entries:
                    transcripts[si] = entries
        else:  # no track audio: per-segment ASR
            asr_owner = [
                si
                for si, seg in enumerate(segments)
                if seg.audio_data is not None and len(seg.audio_data) >= sample_rate // 10
            ]
            if asr_owner:
                with self.timers.stage("transcribe"):
                    seg_results = self.whisper.transcribe_batch(
                        [segments[si].audio_data for si in asr_owner], sample_rate
                    )
                for si, segs in zip(asr_owner, seg_results):
                    off = segments[si].start_time  # clip-local -> global times
                    transcripts[si] = [
                        {"text": s.text, "start": float(s.start + off), "end": float(s.end + off)}
                        for s in segs
                        if s.text
                    ]

        # ---- assemble STMs ----
        stms: List[ShortTermMemory] = []
        offset = 0
        for si, seg in enumerate(segments):
            idx = seg_frame_idx[si]
            feats: Dict[str, np.ndarray] = {}
            if vision_feats is not None and len(idx):
                feats["vision"] = vision_feats[offset : offset + len(idx)]
            offset += len(idx)
            if si in audio_embs:
                feats["audio"] = audio_embs[si]
            modalities = [m for m in ("vision", "audio") if m in feats]
            stms.append(
                ShortTermMemory(
                    features=feats,
                    content="",
                    timestamp=time.time(),
                    source_time=seg.start_time,
                    modalities=modalities,
                    segment_info={
                        "video_id": video_id,
                        "start_time": seg.start_time,
                        "end_time": seg.end_time,
                        "frames": list(seg.frames),
                        "frame_times": list(seg.frame_times),
                    },
                    transcription=transcripts.get(si, []),
                )
            )
        return stms

    def dispatch_asr(self, video_id: str, audio: np.ndarray, sample_rate: int = 16000):
        """Queue the full-track ASR's device work from this thread and keep
        its finisher; process_sequence collects it like a prefetch future.
        None for a track under 100 ms or the stub transcriber."""
        audio = np.asarray(audio, dtype=np.float32)
        if len(audio) < sample_rate // 10:
            return None
        self._full_audio[video_id] = audio
        with tracing.video(video_id):  # the enqueue's counters carry the video
            finish = self.whisper.transcribe_async(audio, sample_rate)
        if finish is None:
            return None

        class _Finisher:
            def result(self):
                return finish()

        fut = _Finisher()
        self._asr_futures[video_id] = fut
        return fut

    def prefetch_asr(self, video_id: str, audio: np.ndarray, sample_rate: int = 16000):
        """Run the full-track ASR on a background thread; process_sequence
        collects the future. Harmless if never consumed."""
        import concurrent.futures

        audio = np.asarray(audio, dtype=np.float32)
        if len(audio) < sample_rate // 10:
            return None
        self._full_audio[video_id] = audio
        ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(self.whisper.transcribe, audio, sample_rate)
        ex.shutdown(wait=False)
        self._asr_futures[video_id] = fut
        return fut

    def add_memory(
        self,
        video_id: str,
        video_frames: Optional[Sequence[str]] = None,
        audio_data: Optional[np.ndarray] = None,
        frame_times: Optional[Sequence[float]] = None,
        start_time: float = 0.0,
        end_time: float = 0.0,
    ) -> ShortTermMemory:
        """Encode one pre-segmented chunk directly (reference add_memory,
        hippocampal_memory.py:451-538, with the video_id explicit)."""
        seg = SequenceSegment(
            start_time=start_time,
            end_time=end_time,
            frames=list(video_frames or []),
            audio_data=audio_data,
            frame_times=list(frame_times or list(np.arange(len(video_frames or [])))),
        )
        frames_rgb = None
        if video_frames:
            from hippomm_tpu_torch.media.io import read_jpeg

            frames_rgb = np.stack([read_jpeg(p) for p in video_frames])
        stm = self._encode_segments(video_id, [seg], frames_rgb, seg.frame_times, 16000)[0]
        buf = self.short_term_buffer.setdefault(video_id, [])
        buf.append(stm)
        if len(buf) > self.max_short_term:
            self.consolidate(video_id)
        return stm

    # ------------------------------------------------------- frame micro-batch

    def add_single_frame(self, video_id: str, frame_path: str, frame_time: float) -> None:
        """Streaming ingest: buffer frames, encode in frame_buffer_size batches
        (reference: hippocampal_memory.py:1290-1365)."""
        buf = self._frame_buffer.setdefault(video_id, [])
        buf.append((frame_path, float(frame_time)))
        if len(buf) >= self.frame_buffer_size:
            self._process_frame_batch(video_id)

    def flush_frame_buffer(self, video_id: str) -> None:
        if self._frame_buffer.get(video_id):
            self._process_frame_batch(video_id)

    def _process_frame_batch(self, video_id: str) -> None:
        batch = self._frame_buffer.pop(video_id, [])
        if not batch:
            return
        paths = [p for p, _ in batch]
        times = [t for _, t in batch]
        feats = self.imagebind.encode_vision(paths)
        stm = ShortTermMemory(
            features={"vision": feats},
            timestamp=time.time(),
            source_time=times[0],
            modalities=["vision"],
            segment_info={
                "video_id": video_id,
                "start_time": times[0],
                "end_time": times[-1],
                "frames": paths,
                "frame_times": times,
            },
        )
        self.short_term_buffer.setdefault(video_id, []).append(stm)

    # ------------------------------------------------------------- consolidate

    def consolidate(self, video_id: Optional[str] = None) -> Optional[Dict]:
        """Merge a video's STMs into one consolidated record
        (reference: hippocampal_memory.py:540-586)."""
        if video_id is None:
            for vid in list(self.short_term_buffer):
                self.consolidate(vid)
            return None
        stms = self.short_term_buffer.get(video_id, [])
        with self.timers.stage("consolidate"):
            merged = consolidate_short_term_memory(
                stms, keyframe_threshold=self.keyframe_dedup_threshold, device=self.device
            )
        if merged is not None:
            merged["video_id"] = video_id
            self.consolidated[video_id] = merged
        return merged

    # ------------------------------------------------------------------ replay

    def replay(self, video_id: Optional[str] = None) -> Optional[ThetaEvent]:
        """Semantic replay: caption key frames, summarize, persist ThetaEvent
        (reference: hippocampal_memory.py:588-752)."""
        if video_id is None:
            if not self.consolidated:
                return None
            video_id = next(iter(self.consolidated))
        merged = self.consolidated.get(video_id)
        if merged is None:
            merged = self.consolidate(video_id)
            if merged is None:
                return None

        # one caption per frames[] slot, placeholders included
        captions: List[str] = []
        frame_paths = list(merged.get("frames", []))
        if any(frame_paths):
            jpegs = []
            for p in frame_paths:
                if not p:
                    jpegs.append(b"")
                    continue
                try:
                    with open(p, "rb") as f:
                        jpegs.append(f.read())
                except OSError:
                    jpegs.append(b"")
            with self.timers.stage("caption"):
                captions = self.frame_client.caption_images(jpegs, CAPTION_PROMPT)

        transcripts = merged.get("audio_transcription", [])
        with self.timers.stage("summary"):
            summary = self._summarize_event(captions, transcripts, merged["modalities"])

        event = ThetaEvent(
            video_id=video_id,
            features={k: v for k, v in merged["features"].items()},
            feature_times=merged["feature_times"],
            frames=merged.get("frames", []),
            frame_times=merged.get("frame_times", []),
            frame_captions=captions,
            audio_times=merged.get("audio_times", []),
            audio_transcription=transcripts,
            summary=summary,
            start_time=merged["start_time"],
            end_time=merged["end_time"],
            modalities=merged["modalities"],
        )
        # holistic transcription over the full audio track (reference :1367-1415);
        # reuses the single full-track ASR pass from perceptual encoding
        segs = self._full_transcript.get(video_id)
        if segs is None:
            full_audio = self._full_audio.get(video_id)
            if full_audio is not None and len(full_audio) > 1600:
                with self.timers.stage("holistic_transcribe"):
                    segs = self.whisper.transcribe(full_audio)
        if segs:
            event.holistic_audio_transcription = [
                {"text": s.text, "start": float(s.start), "end": float(s.end)}
                for s in segs
                if s.text
            ]

        self.store.save_theta_event(event)
        self.long_term_store.append(event)
        if len(self.long_term_store) > self.max_long_term:
            self.long_term_store = self.long_term_store[-self.max_long_term :]
        self.consolidated.pop(video_id, None)
        if self.evict_stm_after_replay:
            self.short_term_buffer.pop(video_id, None)
        # the cached track stays resident only while no audio.npy exists on disk
        if os.path.exists(os.path.join(self.store.audio_dir, video_id, "audio.npy")):
            self._full_audio.pop(video_id, None)
        self._full_transcript.pop(video_id, None)
        self._transcript_full_track.discard(video_id)
        return event

    def discard_pending(self, video_id: str) -> None:
        """Drop everything a FAILED ingest attempt left behind: the pending
        full-track ASR, the cached waveform and transcript, partial STM and
        consolidated state, and the failed-attempt marker."""
        self._asr_futures.pop(video_id, None)
        self._full_audio.pop(video_id, None)
        self._full_transcript.pop(video_id, None)
        self._transcript_full_track.discard(video_id)
        self.short_term_buffer.pop(video_id, None)
        self.consolidated.pop(video_id, None)
        self._inflight_ingests.discard(video_id)

    def _summarize_event(
        self, captions: List[str], transcripts: List[str], modalities: List[str]
    ) -> str:
        parts = []
        if captions:
            shown = captions if len(captions) <= 1000 else captions[:: max(1, len(captions) // 1000)]
            parts.append("Frame captions:\n" + "\n".join(f"- {c}" for c in shown))
        if transcripts:
            texts = [t.get("text", "") if isinstance(t, dict) else str(t) for t in transcripts]
            parts.append("Audio transcription:\n" + " ".join(texts))
        if not parts:
            return ""
        prompt = (
            "Summarize the following video content in one sentence.\n\n" + "\n\n".join(parts)
        )
        try:
            return self.qwen.generate(prompt, max_tokens=128).strip()
        except Exception:  # noqa: BLE001 — a failed VLM call must not lose the event
            logger.exception("summary generation failed")
            if captions:
                return captions[0]
            if transcripts:
                t0 = transcripts[0]
                return t0.get("text", "") if isinstance(t0, dict) else str(t0)
            return ""

    def update_holistic_audio_transcription(
        self, event: ThetaEvent, audio: Optional[np.ndarray] = None
    ) -> ThetaEvent:
        """Whole-track transcription onto an event (reference:
        hippocampal_memory.py:1367-1415), from the cached 16 kHz track or an
        explicit array."""
        if audio is None:
            audio = self._full_audio.get(event.video_id)
        if audio is None or len(audio) <= 1600:
            return event
        segs = self.whisper.transcribe(np.asarray(audio, np.float32))
        event.holistic_audio_transcription = [
            {"text": s.text, "start": float(s.start), "end": float(s.end)}
            for s in segs
            if s.text
        ]
        return event

    # ------------------------------------------------------------- persistence

    def save_theta_event(self, event: ThetaEvent) -> str:
        return self.store.save_theta_event(event)

    def load_theta_event(self, event_id: str) -> ThetaEvent:
        event = self.store.load_theta_event(event_id)
        if all(e.event_id != event.event_id for e in self.long_term_store):
            self.long_term_store.append(event)
        return event

    def load_all_events(self) -> List[ThetaEvent]:
        self.long_term_store = self.store.load_all_events()
        return self.long_term_store

    def _save_checkpoint(self, video_id: str) -> str:
        return self.store.save_checkpoint(video_id, self.short_term_buffer.get(video_id, []))

    def _check_for_checkpoint(self, video_id: str) -> bool:
        return self.store.has_checkpoint(video_id)

    def _load_checkpoint(self, video_id: str) -> bool:
        stms = self.store.load_checkpoint(video_id)
        if stms is None:
            return False
        self.short_term_buffer[video_id] = stms
        return True

    def save_short_term_buffer(self, tag: str = "buffer") -> str:
        return self.store.save_short_term_buffer(self.short_term_buffer, tag)

    def load_short_term_buffer(self, tag: str = "buffer") -> None:
        loaded = self.store.load_short_term_buffer(tag)
        if loaded:
            self.short_term_buffer.update(loaded)

    # ------------------------------------------------------------------- misc

    def get_stats(self) -> Dict:
        """Buffer sizes + config snapshot (reference: hippocampal_memory.py:969-978)."""
        return {
            "short_term_videos": len(self.short_term_buffer),
            "short_term_memories": sum(len(v) for v in self.short_term_buffer.values()),
            "long_term_events": len(self.long_term_store),
            "max_short_term": self.max_short_term,
            "max_long_term": self.max_long_term,
            "frame_buffer_size": self.frame_buffer_size,
            "timers": self.timers.summary(),
        }
