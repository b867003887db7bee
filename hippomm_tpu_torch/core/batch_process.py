"""Ingestion pipeline + batch CLI (counterpart of
hippomm_tpu/core/batch_process.py; reference: hippomm/core/batch_process.py).

Same flags, store layout and stage order as the JAX CLI:

  * video decode through the port's readers (media/io: .y4m, MJPEG .avi,
    and the libav containers .mp4/.mov/.mkv/.webm through the libav shim)
  * key-frame selection as a device scan over ~1 Hz candidate luma
    (ops/keyframe.KeyframeScanner, on its own CUDA stream), the kept frames
    fed to the vision tower as their masks are read (VisionEncodeStream)
  * silence detection as a host numpy RMS reduction
  * the full-track Whisper pass queued from the extraction thread as soon as
    the audio is read, collected by the engine later
  * the engine receives in-memory RGB + audio, so nothing is re-read from disk
  * process_memory_sync is the working form of the reference's queue
    consumer

Audio comes from a sibling `<stem>.wav` (the port reads no container audio
yet); a standalone .wav is an audio-only ingest. Entry points build their
engine on CUDA unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import yaml

from hippomm_tpu_torch.config import Config, load_config
from hippomm_tpu_torch.utils.timers import Throughput

logger = logging.getLogger(__name__)

# the reference's set plus the native fast-path containers
VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".y4m", ".webm", ".m4v")
# audio-only ingest: silence segmentation + Whisper + audio embeddings
AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".m4a", ".aac", ".ogg")


# ---------------------------------------------------------------------------
# Frame extraction
# ---------------------------------------------------------------------------


def compute_frame_difference(frame_a: np.ndarray, frame_b: np.ndarray, device=None) -> float:
    """1 - SSIM between two RGB frames (reference: batch_process.py:32-71)."""
    import torch

    from hippomm_tpu_torch.ops.ssim import frame_difference, rgb_to_gray
    from hippomm_tpu_torch.utils.device import fetch, resolve_device

    x = torch.from_numpy(np.stack([frame_a, frame_b])).to(resolve_device(device))
    g = rgb_to_gray(x)
    return float(fetch(frame_difference(g[:1], g[1:]))[0])


def save_frame(frame_rgb: np.ndarray, path: str, quality: int = 90) -> None:
    """(reference: batch_process.py:73-114)"""
    from hippomm_tpu_torch.media.io import write_jpeg

    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_jpeg(path, frame_rgb, quality)


def select_keyframes_greedy(
    grays: np.ndarray,
    times: Sequence[float],
    score_fn,
    max_diff_threshold: float = 0.3,
    min_interval_s: float = 1.0,
) -> List[int]:
    """Reference-exact greedy key-frame selection over candidate grayscale
    frames (reference: batch_process.py:170-230):

      * candidate 0 is always selected (the first frame)
      * each later candidate is gated by >= min_interval_s since the last SAVE
      * diff = 1 - SSIM(candidate, LAST-SAVED frame); a running cumulative sum
        of diffs (reset on save) also triggers at the same threshold
      * gated-out candidates do NOT accumulate

    `score_fn(ref_gray, grays_block) -> (B,) ssim` scores a block of
    candidates against one reference; it is re-invoked per block plus once
    per save (a save changes the reference frame). The host statement of
    the walk that ops/keyframe runs on the device.
    """
    n = len(grays)
    if n == 0:
        return []
    selected = [0]
    last_save_time = float(times[0])
    cumulative = 0.0
    block = 256
    for b0 in range(0, n, block):
        b1 = min(n, b0 + block)
        ref = selected[-1]
        sims = np.asarray(score_fn(grays[ref], grays[b0:b1]))
        for j in range(max(b0, 1), b1):
            if float(times[j]) - last_save_time < min_interval_s:
                continue
            if selected[-1] != ref:  # a save inside this block: re-reference
                ref = selected[-1]
                sims = np.asarray(score_fn(grays[ref], grays[b0:b1]))
            diff = 1.0 - float(sims[j - b0])
            cumulative += diff
            if diff > max_diff_threshold or cumulative > max_diff_threshold:
                selected.append(j)
                last_save_time = float(times[j])
                cumulative = 0.0
    return selected


def extract_frames_from_video(
    video_path: str,
    output_dir: str,
    video_id: Optional[str] = None,
    max_diff_threshold: float = 0.3,
    min_interval_s: float = 1.0,
    keep_rgb: bool = True,
    score_hw: Tuple[int, int] = (90, 160),
    timers=None,
    vision_stream=None,
    device=None,
) -> Dict:
    """Dynamic key-frame extraction (reference: batch_process.py:116-255).

    Selection semantics match the reference exactly (select_keyframes_greedy);
    candidates are time-based at min_interval_s spacing, and scoring runs on
    (90, 160) luma from the reader. Key-frame JPEGs are encoded on a
    background pool.

    `vision_stream` (a `VisionEncodeStream`) receives each kept frame's RGB
    as its scan mask is read, so the vision tower runs during the decode; it
    is attached to the returned meta as "vision_stream" only when this
    extraction fed it (a metadata.yaml resume reads JPEGs and feeds nothing).

    Idempotent: resumes from metadata.yaml when all frames exist.
    """
    from hippomm_tpu_torch.utils.timers import StageTimer

    timers = timers if timers is not None else StageTimer()
    video_id = video_id or os.path.splitext(os.path.basename(video_path))[0]
    frames_dir = os.path.join(output_dir, "frames", video_id)
    meta_path = os.path.join(frames_dir, "metadata.yaml")

    # idempotent resume
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                meta = yaml.safe_load(f)
            if meta and all(os.path.exists(p) for p in meta.get("frame_paths", [])):
                logger.info("frames already extracted for %s", video_id)
                meta["resumed"] = True
                if keep_rgb:
                    from hippomm_tpu_torch.media.io import read_jpeg

                    meta["frames_rgb"] = np.stack(
                        [read_jpeg(p) for p in meta["frame_paths"]]
                    ) if meta["frame_paths"] else None
                return meta
        except Exception:
            logger.exception("bad metadata for %s; re-extracting", video_id)

    chunks: List[Dict] = []
    meta: Dict = {}
    for item in extract_frames_streaming(
        video_path,
        output_dir,
        video_id,
        max_diff_threshold=max_diff_threshold,
        min_interval_s=min_interval_s,
        score_hw=score_hw,
        emit_seconds=float("inf"),
        timers=timers,
        _meta_out=meta,
        vision_stream=vision_stream,
        device=device,
    ):
        chunks.append(item)
    out = dict(meta)
    out["resumed"] = False
    if keep_rgb:
        rgbs = [c["frames_rgb"] for c in chunks if c["frames_rgb"] is not None]
        out["frames_rgb"] = np.concatenate(rgbs) if rgbs else None
    if vision_stream is not None:
        # the engine reads the queued features instead of running the tower:
        # one row per frames_rgb row, in order — either fed keyframes, or
        # (short clips) every candidate, indexed down to the kept rows here
        rows = out.pop("vision_candidate_rows", None)
        out["vision_stream"] = (
            _IndexedVisionStream(vision_stream, rows) if rows is not None else vision_stream
        )
        # every frame is fed: queue the (<32) remainder now, ahead of the
        # next video's full-track ASR on the device
        fin = getattr(out["vision_stream"], "finalize", None)
        if fin is not None:  # optional lifecycle on duck-typed streams
            fin()
    return out


class _IndexedVisionStream:
    """View of a per-CANDIDATE `VisionEncodeStream` reduced to the kept
    keyframe rows (the short-clip early dispatch — see encode_all_candidates
    in extract_frames_streaming). Same .result() surface the engine reads."""

    def __init__(self, stream, rows):
        self._stream = stream
        self._rows = np.asarray(rows, dtype=np.int64)

    def result(self) -> np.ndarray:
        return self._stream.result()[self._rows]

    def finalize(self) -> None:
        fin = getattr(self._stream, "finalize", None)
        if fin is not None:
            fin()

    def close(self) -> None:
        if hasattr(self._stream, "close"):
            self._stream.close()


def extract_frames_streaming(
    video_path: str,
    output_dir: str,
    video_id: Optional[str] = None,
    max_diff_threshold: float = 0.3,
    min_interval_s: float = 1.0,
    score_hw: Tuple[int, int] = (90, 160),
    emit_seconds: float = 300.0,
    timers=None,
    _meta_out: Optional[Dict] = None,
    vision_stream=None,
    device=None,
):
    """Streaming key-frame extraction: yields a chunk dict roughly every
    `emit_seconds` of media while decode continues, so a long video's engine
    stages can run on chunk N as the host decodes chunk N+1. The greedy
    walk's carry spans chunks: the selected key-frame set is identical to a
    whole-video pass.

    Chunk dict: {chunk_start, chunk_duration, frame_paths, frame_times
    (global), frames_rgb, frame_ssim (adjacent pairs within the chunk)}.
    metadata.yaml is written after the final chunk (into `_meta_out` too).

    Each candidate is decoded once (scoring luma eagerly, full RGB lazily
    for kept frames only). The device scan of block i runs while the host
    decodes block i+1; masks are read when `is_ready()` says the scan is
    done, or when too many blocks are held, and in one copy at each emit.
    `device` is where the scan and the chunk SSIM run (None: CUDA).
    """
    from collections import deque

    from hippomm_tpu_torch.media.io import open_video
    from hippomm_tpu_torch.memory.segmentation import adjacent_similarity_gray
    from hippomm_tpu_torch.ops.keyframe import BLOCK as SCAN_BLOCK
    from hippomm_tpu_torch.ops.keyframe import KeyframeScanner
    from hippomm_tpu_torch.utils.timers import StageTimer

    timers = timers if timers is not None else StageTimer()
    video_id = video_id or os.path.splitext(os.path.basename(video_path))[0]
    frames_dir = os.path.join(output_dir, "frames", video_id)
    meta_path = os.path.join(frames_dir, "metadata.yaml")

    sh, sw = score_hw
    reader = open_video(video_path)
    info = reader.info
    stride = max(1, int(round(info.fps * min_interval_s)))
    candidate_idx = list(range(0, info.num_frames, stride))
    times = [i / info.fps for i in candidate_idx]

    # Short clips (≤ 2 vision chunks of candidates): encode ALL candidates as
    # their block decodes instead of waiting for the scan mask. Keyframes ⊆
    # candidates, so the engine just indexes rows, and the vision tower no
    # longer waits on a mask read. HIPPOMM_ENCODE_ALL_MAX sets the gate
    # (default 64): a 33-64-candidate clip pays a second 32-wide tower
    # forward for it.
    encode_all_candidates = (
        vision_stream is not None
        and not np.isfinite(emit_seconds)  # whole-video mode: single emit
        and len(candidate_idx)
        <= int(os.environ.get("HIPPOMM_ENCODE_ALL_MAX", "64"))
    )

    # scan-block size: 256 candidates normally; 64 when the emit cadence is
    # finer than a block (chunks are cut at block boundaries, so a 300 s
    # cadence over 256 s blocks would round up to 512 s chunks)
    cand_per_emit = emit_seconds / max(min_interval_s, 1e-6)
    if not np.isfinite(cand_per_emit):  # whole-video mode: no emit cadence
        block = SCAN_BLOCK
    elif cand_per_emit >= SCAN_BLOCK:
        overshoot = (
            np.ceil(cand_per_emit / SCAN_BLOCK) * SCAN_BLOCK - cand_per_emit
        ) / cand_per_emit
        block = SCAN_BLOCK if overshoot <= 0.25 else 64
    else:
        block = 64
    scanner = KeyframeScanner(sh, sw, max_diff_threshold, min_interval_s, block=block,
                              device=device)
    pending: "deque" = deque()  # (cand_offset, mask handle, held block)
    held_frame_bytes = int(info.width * info.height * 1.6) * block
    max_hold = max(1, (512 << 20) // max(1, held_frame_bytes))

    all_gray_blocks: List[np.ndarray] = []  # tiny; reused for metadata ssim
    all_saved_cand: List[int] = []
    all_saved_paths: List[str] = []
    all_saved_times: List[float] = []
    # per-chunk accumulators (reset at each emit)
    cur_cand: List[int] = []
    cur_rgb: List[np.ndarray] = []
    cur_gray: List[np.ndarray] = []  # saved frames' scoring luma, this chunk
    chunk_start = 0.0
    jpeg_pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    jpeg_futs: List = []

    def _flush(entry):
        off, handle, blk = entry
        mask = handle.get()
        js = np.nonzero(mask)[0]
        if len(js):
            cur_cand.extend(off + int(j) for j in js)
            rgb = blk.take_rgb(js)
            cur_rgb.append(rgb)
            cur_gray.append(blk.gray[js])
            if vision_stream is not None and not encode_all_candidates:
                # the tower forward over the kept frames runs behind the
                # remaining decode instead of after it
                with timers.stage("extract_vision_feed"):
                    vision_stream.feed(rgb)
        blk.close()

    def _emit(chunk_end: float) -> Dict:
        nonlocal chunk_start, cur_cand, cur_rgb, cur_gray
        rgb = np.concatenate(cur_rgb) if cur_rgb else None
        c_times = [times[j] for j in cur_cand]
        paths: List[str] = []
        with timers.stage("extract_jpeg_save"):
            for k, t in enumerate(c_times):
                sec_dir = os.path.join(frames_dir, f"t_{int(t)}")
                path = os.path.join(sec_dir, f"frame_{len(all_saved_paths) + k}.jpg")
                paths.append(path)
                jpeg_futs.append(jpeg_pool.submit(save_frame, rgb[k], path))
        with timers.stage("extract_seg_ssim"):
            # only this chunk's saved-frame luma: re-concatenating the whole
            # video's per emit would be O(N²) over a long ingest
            ssim = (
                adjacent_similarity_gray(np.concatenate(cur_gray), device=scanner.device)
                if cur_cand else None
            )
        chunk = {
            "chunk_start": chunk_start,
            "chunk_duration": chunk_end - chunk_start,
            "frame_paths": paths,
            "frame_times": c_times,
            "frames_rgb": rgb,
            "frame_ssim": ssim,
        }
        all_saved_cand.extend(cur_cand)
        all_saved_paths.extend(paths)
        all_saved_times.extend(c_times)
        cur_cand, cur_rgb, cur_gray = [], [], []
        chunk_start = chunk_end
        return chunk

    completed = False
    try:
        with timers.stage("extract_decode"):
            for b0 in range(0, len(candidate_idx), block):
                batch = candidate_idx[b0 : b0 + block]
                with timers.stage("extract_decode_c"):
                    blk = reader.read_block(batch, sh, sw, skip_nonref=stride >= 8)
                all_gray_blocks.append(blk.gray)
                with timers.stage("extract_feed"):
                    handle = scanner.feed(blk.gray, times[b0 : b0 + block])
                if encode_all_candidates:
                    # after the scan is queued, so its mask does not wait
                    # behind the tower forward
                    with timers.stage("extract_vision_feed"):
                        vision_stream.feed(blk.take_rgb(np.arange(len(batch))))
                with timers.stage("extract_flush"):
                    pending.append((b0, handle, blk))
                    while pending and (len(pending) > max_hold or pending[0][1].is_ready()):
                        _flush(pending.popleft())
                block_end_t = times[min(b0 + block, len(times)) - 1]
                last_block = b0 + block >= len(candidate_idx)
                if not last_block and block_end_t - chunk_start >= emit_seconds:
                    with timers.stage("extract_score"):
                        # one mask read for every held block
                        scanner.prefetch_masks([h for _, h, _ in pending])
                        while pending:
                            _flush(pending.popleft())
                    yield _emit(block_end_t + min_interval_s / 2)
        with timers.stage("extract_score"):
            scanner.prefetch_masks([h for _, h, _ in pending])
            while pending:
                _flush(pending.popleft())
        completed = True
    finally:
        # abandoned mid-stream (consumer failed, generator .close()d): release
        # held blocks, the decoder and the JPEG pool
        for _, _, blk in pending:
            blk.close()
        pending.clear()
        scanner.close()
        reader.close()
        if not completed:
            jpeg_pool.shutdown(wait=False)
    final = _emit(info.duration if info.duration else (times[-1] + min_interval_s if times else 0.0))

    # metadata over the whole video (the resume path recomputes nothing)
    with timers.stage("extract_seg_ssim"):
        if not all_saved_cand:
            full_ssim = None
        elif not np.isfinite(emit_seconds):
            # whole-video mode emits once: the final chunk's adjacent pairs
            # are the whole video's
            full_ssim = np.asarray(final["frame_ssim"], np.float32)
        else:
            grays_all = np.concatenate(all_gray_blocks)
            full_ssim = adjacent_similarity_gray(grays_all[all_saved_cand], device=scanner.device)
    with timers.stage("extract_jpeg_save"):
        for f in jpeg_futs:
            f.result()
        jpeg_pool.shutdown(wait=True)
    meta = {
        "video_id": video_id,
        "video_path": video_path,
        "fps": info.fps,
        "duration": info.duration,
        "num_source_frames": info.num_frames,
        "frame_paths": all_saved_paths,
        "frame_times": [float(t) for t in all_saved_times],
        "frame_ssim": [float(s) for s in full_ssim] if full_ssim is not None else None,
    }
    os.makedirs(frames_dir, exist_ok=True)
    with open(meta_path, "w") as f:
        yaml.safe_dump(meta, f)
    if _meta_out is not None:
        _meta_out.update(meta)
        if encode_all_candidates:
            # stream rows are per candidate; the kept keyframes are these rows
            _meta_out["vision_candidate_rows"] = list(all_saved_cand)
    yield final


# ---------------------------------------------------------------------------
# Audio extraction
# ---------------------------------------------------------------------------


def extract_audio_from_video(
    video_path: str,
    output_dir: str,
    video_id: Optional[str] = None,
    silence_db: float = -50.0,
    skip_silent_fraction: float = 0.9,
) -> Dict:
    """Audio track → 16 kHz mono + silence analysis (reference:
    batch_process.py:257-378, an ffmpeg demux + silencedetect). Container
    audio (libav containers, compressed audio files, a non-MJPEG .avi) is
    demuxed in process by the libav shim; a track more than
    `skip_silent_fraction` silent is skipped. A sibling `<stem>.wav` is the
    track of a video-only container (.y4m, MJPEG .avi); a standalone .wav is
    its own track. Writes audio/<video_id>/audio.npy + metadata.yaml;
    idempotent."""
    from hippomm_tpu_torch.media.io import (
        LIBAV_EXTENSIONS,
        demux_audio,
        libav_available,
        load_audio_mono16k,
    )
    from hippomm_tpu_torch.ops.silence import detect_silence_regions, silence_fraction

    video_id = video_id or os.path.splitext(os.path.basename(video_path))[0]
    audio_dir = os.path.join(output_dir, "audio", video_id)
    meta_path = os.path.join(audio_dir, "metadata.yaml")
    npy_path = os.path.join(audio_dir, "audio.npy")

    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = yaml.safe_load(f) or {}
        if os.path.exists(npy_path):
            meta["resumed"] = True
            meta["audio"] = np.load(npy_path)
            return meta
        if meta.get("skipped_as_silent") or not meta.get("has_audio", True):
            # a silent or audio-less track writes no audio.npy: its metadata
            # alone is the resume state
            meta["resumed"] = True
            meta["audio"] = None
            return meta

    pcm = None
    ext = os.path.splitext(video_path)[1].lower()
    # an MJPEG .avi (the port's writer's) carries no audio: without the libav
    # shim its track is the sibling wav; any other .avi needs the shim to open
    if (ext in LIBAV_EXTENSIONS or (ext in AUDIO_EXTENSIONS and ext != ".wav")
            or (ext == ".avi" and libav_available())):
        pcm = demux_audio(video_path)
    if pcm is None:
        wav_path = os.path.splitext(video_path)[0] + ".wav"
        if not os.path.exists(wav_path):
            meta = {"video_id": video_id, "has_audio": False, "audio": None, "resumed": False}
            os.makedirs(audio_dir, exist_ok=True)
            with open(meta_path, "w") as f:
                yaml.safe_dump({k: v for k, v in meta.items() if k != "audio"}, f)
            return meta
        pcm = load_audio_mono16k(wav_path)
    regions = detect_silence_regions(pcm, 16000, silence_db)
    frac = silence_fraction(pcm, 16000, silence_db, regions=regions)
    skipped = frac > skip_silent_fraction
    meta = {
        "video_id": video_id,
        "has_audio": not skipped,
        "duration": len(pcm) / 16000.0,
        "sample_rate": 16000,
        "silence_fraction": float(frac),
        "silence_regions": [[float(s), float(e)] for s, e in regions],
        "skipped_as_silent": bool(skipped),
    }
    os.makedirs(audio_dir, exist_ok=True)
    if not skipped:
        np.save(npy_path, pcm)
    with open(meta_path, "w") as f:
        yaml.safe_dump(meta, f)
    meta["audio"] = None if skipped else pcm
    meta["resumed"] = False
    return meta


# ---------------------------------------------------------------------------
# Per-video + folder orchestration
# ---------------------------------------------------------------------------


def process_single_video(
    video_path: str,
    memory_store_dir: str,
    video_id: Optional[str] = None,
    timers=None,
    memory_system=None,
    device=None,
) -> Dict:
    """Frame + audio extraction, concurrently (reference: batch_process.py:380-435
    used a ProcessPoolExecutor(2); threads suffice, the decode and the
    device work release the GIL). With a memory_system, its device is the
    scan's, and the full-track ASR is queued as soon as the audio is read,
    so the Whisper encoder runs during the frame decode."""
    video_id = video_id or os.path.splitext(os.path.basename(video_path))[0]
    if os.path.splitext(video_path)[1].lower() in AUDIO_EXTENSIONS:
        # audio-only ingest: no frame track
        audio = extract_audio_from_video(video_path, memory_store_dir, video_id)
        frames = {
            "video_id": video_id,
            "frame_paths": [],
            "frame_times": [],
            "frames_rgb": None,
            "duration": audio.get("duration"),
        }
        return {"video_id": video_id, "video_path": video_path, "frames": frames, "audio": audio}
    vision_stream = None
    if memory_system is not None:
        device = memory_system.device
        if getattr(memory_system, "imagebind", None) is not None:
            # kept frames queue their tower forward as they are flushed; the
            # engine reads the features through process_sequence
            vision_stream = memory_system.imagebind.vision_stream()
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
            f_frames = ex.submit(
                extract_frames_from_video, video_path, memory_store_dir, video_id,
                timers=timers, vision_stream=vision_stream, device=device,
            )
            f_audio = ex.submit(extract_audio_from_video, video_path, memory_store_dir, video_id)
            audio = f_audio.result()
            # queue the ASR from this thread, while the frame decode runs;
            # process_sequence collects it
            if memory_system is not None and audio.get("audio") is not None:
                memory_system.dispatch_asr(video_id, audio["audio"])
            frames = f_frames.result()
    except BaseException:
        # join the stream's worker and drop its queued outputs, so a folder
        # run with failing videos does not accumulate device memory
        if vision_stream is not None and hasattr(vision_stream, "close"):
            vision_stream.close()
        raise
    return {"video_id": video_id, "video_path": video_path, "frames": frames, "audio": audio}


# Videos longer than this ingest chunk by chunk: the engine encodes chunk N
# while the host decodes chunk N+1.
STREAMING_THRESHOLD_S = 900.0
STREAM_CHUNK_S = 300.0


def process_single_video_streaming(
    video_path: str,
    memory_store_dir: str,
    video_id: Optional[str] = None,
    memory_system=None,
    chunk_seconds: float = STREAM_CHUNK_S,
    config: Optional[Config] = None,
    device=None,
) -> Dict:
    """Chunked ingest for long videos: extraction yields ~chunk_seconds
    chunks (extract_frames_streaming) and each chunk runs through
    process_sequence with base_time offsets while the next chunk decodes.
    The full-track ASR is queued once up front (global timestamps);
    consolidation + replay run once at the end, so the video still produces
    a single ThetaEvent, as the whole-video path does (reference base_time
    flow, hippocampal_memory.py:1134). Without a memory_system it builds an
    engine from `config` on `device`."""
    mem = memory_system
    if mem is None:
        from hippomm_tpu_torch.memory.engine import HippocampalMemory

        cfg = config or load_config(None)
        cfg.storage.base_dir = memory_store_dir
        mem = HippocampalMemory(config=cfg, device=device)
    video_id = video_id or os.path.splitext(os.path.basename(video_path))[0]
    audio_meta = extract_audio_from_video(video_path, memory_store_dir, video_id)
    audio = audio_meta.get("audio")
    sr = int(audio_meta.get("sample_rate", 16000) or 16000)
    mem.add_video(video_id, video_path)
    # a failed earlier streaming attempt leaves its STMs in the buffer and a
    # partial checkpoint on disk; chunk 0 runs with resume=False and would
    # extend() onto them, duplicating every segment in the final ThetaEvent
    mem.short_term_buffer[video_id] = []
    mem.store.delete_checkpoint(video_id)
    if audio is not None:
        mem.dispatch_asr(video_id, audio, sr)
    # The extractor runs on a producer thread pushing chunks through a
    # bounded queue: chunk N+1 decodes while this thread runs chunk N's
    # engine stages (a plain generator only advances when asked).
    meta: Dict = {}
    n_chunks = 0
    chunk_q: "queue.Queue" = queue.Queue(maxsize=1)
    stop = threading.Event()  # consumer died: producer must unwind, not block
    _DONE = object()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                chunk_q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _produce():
        gen = extract_frames_streaming(
            video_path,
            memory_store_dir,
            video_id,
            emit_seconds=chunk_seconds,
            timers=getattr(mem, "timers", None),
            _meta_out=meta,
            device=mem.device,
        )
        try:
            for c in gen:
                if not _put(c):  # consumer gone: run the generator's finally
                    gen.close()
                    return
            _put(_DONE)
        except BaseException as e:  # propagate into the consumer
            _put(e)

    producer = threading.Thread(target=_produce, daemon=True)
    producer.start()
    try:
        while True:
            chunk = chunk_q.get()
            if chunk is _DONE:
                break
            if isinstance(chunk, BaseException):
                raise chunk
            t0c = chunk["chunk_start"]
            dur = chunk["chunk_duration"]
            seg_audio = None
            if audio is not None:
                seg_audio = audio[int(t0c * sr) : int((t0c + dur) * sr)]
            fssim = chunk["frame_ssim"]
            mem.process_sequence(
                video_id,
                frame_paths=chunk["frame_paths"],
                frame_times=[t - t0c for t in chunk["frame_times"]],
                frames_rgb=chunk["frames_rgb"],
                audio_data=seg_audio,
                sample_rate=sr,
                video_duration=dur,
                auto_consolidate=False,
                base_time=t0c,
                frame_ssim=np.asarray(fssim, np.float32) if fssim is not None else None,
                resume=False,
            )
            n_chunks += 1
    finally:
        # consumer failed (or finished): release a producer blocked on put
        stop.set()
        try:
            while True:
                chunk_q.get_nowait()
        except queue.Empty:
            pass
    mem.consolidate(video_id)
    mem.replay(video_id)
    frames = dict(meta)
    frames["streamed_chunks"] = n_chunks
    return {
        "video_id": video_id,
        "video_path": video_path,
        "frames": frames,
        "audio": audio_meta,
        "streamed": True,
    }


def process_video_folder(
    folder: str,
    memory_store_dir: str,
    config: Optional[Config] = None,
    memory_system=None,
    sort_by: str = "name",
    checkpoint_every: int = 5,
    limit: Optional[int] = None,
    skip_existing: bool = True,
    pipeline_lookahead: bool = True,
    device=None,
) -> Dict:
    """Batch ingest of a folder (reference: batch_process.py:437-663). Builds an
    engine from `config` on `device` unless a memory_system is given.

    pipeline_lookahead=True overlaps video N+1's extraction with video N's
    engine stages (one extraction in flight)."""
    from hippomm_tpu_torch.memory.engine import HippocampalMemory

    config = config or load_config(None)
    config.storage.base_dir = memory_store_dir
    mem = memory_system or HippocampalMemory(config=config, device=device)

    listing = os.listdir(folder)
    video_stems = {
        os.path.splitext(f)[0]
        for f in listing
        if os.path.splitext(f)[1].lower() in VIDEO_EXTENSIONS
    }
    videos = [
        os.path.join(folder, f)
        for f in listing
        if os.path.splitext(f)[1].lower() in VIDEO_EXTENSIONS
        or (
            os.path.splitext(f)[1].lower() in AUDIO_EXTENSIONS
            # a .wav sharing a video's stem is that video's audio track, not
            # a standalone audio ingest
            and os.path.splitext(f)[0] not in video_stems
        )
    ]
    if sort_by == "name":
        videos.sort()
    elif sort_by == "time":
        videos.sort(key=os.path.getmtime)
    elif sort_by == "size":
        videos.sort(key=os.path.getsize)
    if limit:
        videos = videos[:limit]

    stats: Dict = {
        "total": len(videos),
        "processed": 0,
        "skipped": 0,
        "failed": 0,
        "errors": {},
        "wall_seconds": 0.0,
        "media_seconds": 0.0,
    }
    throughput = Throughput()
    throughput.start()

    # Cross-video pipeline: while video N runs its engine stages on this
    # thread, video N+1's extraction (decode, scan, ASR dispatch) runs on a
    # worker.
    todo: List[Tuple[str, str, bool]] = []
    for path in videos:
        video_id = os.path.splitext(os.path.basename(path))[0]
        # skip-existing via video_index + existing events (reference :489-531)
        if skip_existing and mem.store.has_video(video_id) and mem.store.events_for_video(video_id):
            logger.info("skipping %s (already ingested)", video_id)
            stats["skipped"] += 1
            continue
        # long videos ingest chunk by chunk on the main thread; already
        # extracted ones (metadata.yaml) resume through the standard path
        is_long = False
        if os.path.splitext(path)[1].lower() in VIDEO_EXTENSIONS and not os.path.exists(
            os.path.join(memory_store_dir, "frames", video_id, "metadata.yaml")
        ):
            try:
                from hippomm_tpu_torch.media.io import open_video

                probe = open_video(path)
                is_long = (probe.info.duration or 0.0) > STREAMING_THRESHOLD_S
                probe.close()
            except Exception:  # noqa: BLE001 — the video fails, and is counted, below
                pass
        todo.append((path, video_id, is_long))

    def _extract(path: str, video_id: str) -> Dict:
        return process_single_video(
            path, memory_store_dir, video_id,
            timers=getattr(mem, "timers", None), memory_system=mem,
        )

    lookahead_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def _submit(pos: int):
        if not pipeline_lookahead or todo[pos][2]:  # long videos stream inline
            return None
        return lookahead_pool.submit(_extract, todo[pos][0], todo[pos][1])

    next_fut = _submit(0) if todo else None

    for pos, (path, video_id, is_long) in enumerate(todo):
        t0 = time.perf_counter()
        frames = None  # re-bound per video: the except block below inspects it
        try:
            fut, next_fut = next_fut, None
            if is_long:
                result = process_single_video_streaming(
                    path, memory_store_dir, video_id, memory_system=mem
                )
                if pos + 1 < len(todo):
                    next_fut = _submit(pos + 1)
                frames = result["frames"]
            else:
                try:
                    extracted = fut.result() if fut is not None else _extract(path, video_id)
                finally:
                    # keep the lookahead going even when this video's
                    # extraction failed
                    if pos + 1 < len(todo):
                        next_fut = _submit(pos + 1)
                mem.add_video(video_id, path)
                frames = extracted["frames"]
                audio = extracted["audio"]
                fssim = frames.get("frame_ssim")
                mem.process_sequence(
                    video_id,
                    frame_paths=frames.get("frame_paths", []),
                    frame_times=frames.get("frame_times", []),
                    frames_rgb=frames.get("frames_rgb"),
                    audio_data=audio.get("audio"),
                    video_duration=frames.get("duration"),
                    auto_consolidate=True,
                    frame_ssim=np.asarray(fssim, np.float32) if fssim is not None else None,
                    vision_stream=frames.get("vision_stream"),
                )
            stats["processed"] += 1
            stats["media_seconds"] += float(frames.get("duration") or 0.0)
            throughput.add_media(float(frames.get("duration") or 0.0))
            logger.info("%s done in %.2fs", video_id, time.perf_counter() - t0)
        except Exception as e:
            logger.exception("failed on %s", video_id)
            stats["failed"] += 1
            stats["errors"][video_id] = repr(e)
            # drop what the failed video left in the engine (pending ASR,
            # cached waveform/transcript, partial STMs, failed-attempt marker)
            mem.discard_pending(video_id)
            # ...and an unread vision stream
            vs = frames.get("vision_stream") if isinstance(frames, dict) else None
            if vs is not None and hasattr(vs, "close"):
                try:
                    vs.close()
                except Exception:  # noqa: BLE001 — already on the error path
                    pass
        # cadence over the videos actually processed (pos), not the
        # pre-filter index
        if checkpoint_every and (pos + 1) % checkpoint_every == 0:
            _save_driver_checkpoint(mem, memory_store_dir, stats)
    lookahead_pool.shutdown(wait=False)
    throughput.stop()
    stats["wall_seconds"] = throughput.wall_seconds
    stats["realtime_multiple"] = throughput.realtime_multiple
    stats["engine"] = mem.get_stats()
    _save_driver_checkpoint(mem, memory_store_dir, stats)
    logger.info("batch complete: %s", json.dumps({k: v for k, v in stats.items() if k != "engine"}))
    return stats


def _save_driver_checkpoint(mem, store_dir: str, stats: Dict, keep_last: int = 3) -> None:
    """Driver checkpoints with keep-last-N rotation (reference :598-627)."""
    ckpt_dir = os.path.join(store_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    tag = f"driver_{int(time.time() * 1000)}"
    mem.save_short_term_buffer(tag)
    with open(os.path.join(ckpt_dir, f"{tag}_stats.json"), "w") as f:
        json.dump({k: v for k, v in stats.items() if k != "engine"}, f)
    drivers = sorted(
        fn for fn in os.listdir(ckpt_dir) if fn.startswith("driver_") and fn.endswith("_stats.json")
    )
    for old in drivers[:-keep_last]:
        base = old[: -len("_stats.json")]
        for suffix in ("_stats.json", ".json"):
            p = os.path.join(ckpt_dir, base + suffix)
            if os.path.exists(p):
                os.remove(p)


# ---------------------------------------------------------------------------
# Streaming consumer (the working process_memory_sync)
# ---------------------------------------------------------------------------


def process_memory_sync(
    memory_system,
    frame_queue: "queue.Queue",
    checkpoint_every: int = 64,
) -> Dict:
    """Queue-driven streaming ingest (reference: batch_process.py:666-747,
    which calls a nonexistent consolidate_video_memories and drops
    video_id). Items are
      {"type": "frame", "video_id", "path", "time"}
      {"type": "complete", "video_id"}   → flush + consolidate + replay
      {"type": "error", "video_id", "message"}
      {"type": "stop"}                    → drain and return stats
    """
    stats = {"frames": 0, "completed": [], "errors": {}}
    n_since_ckpt = 0
    while True:
        item = frame_queue.get()
        if item is None or item.get("type") == "stop":
            break
        kind = item.get("type")
        vid = item.get("video_id", "stream")
        if kind == "frame":
            memory_system.add_single_frame(vid, item["path"], item.get("time", 0.0))
            stats["frames"] += 1
            n_since_ckpt += 1
            if checkpoint_every and n_since_ckpt >= checkpoint_every:
                memory_system.save_short_term_buffer("stream")
                n_since_ckpt = 0
        elif kind == "complete":
            memory_system.flush_frame_buffer(vid)
            memory_system.consolidate(vid)
            memory_system.replay(vid)
            stats["completed"].append(vid)
        elif kind == "error":
            stats["errors"][vid] = item.get("message", "")
            logger.error("stream error for %s: %s", vid, item.get("message"))
    memory_system.save_short_term_buffer("stream")
    return stats


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def ingest_single_file(
    path: str,
    memory_store_dir: str,
    config: Optional[Config] = None,
    memory_system=None,
    skip_existing: bool = True,
    device=None,
) -> Dict:
    """Single-video ingest (reference :784-804): the CLI's single-file mode.
    Builds an engine from `config` on `device` unless a memory_system is
    given."""
    from hippomm_tpu_torch.memory.engine import HippocampalMemory

    config = config or load_config(None)
    config.storage.base_dir = memory_store_dir
    mem = memory_system or HippocampalMemory(config=config, device=device)
    video_id = os.path.splitext(os.path.basename(path))[0]
    if (
        skip_existing
        and mem.store.has_video(video_id)
        and mem.store.events_for_video(video_id)
    ):
        logger.info("skipping %s (already ingested)", video_id)
        return {
            "total": 1, "processed": 0, "skipped": 1, "failed": 0, "errors": {},
            "video_id": video_id, "wall_seconds": 0.0, "media_seconds": 0.0,
            "engine": mem.get_stats(),
        }
    t0 = time.perf_counter()
    try:
        extracted = process_single_video(
            path, memory_store_dir, video_id, timers=mem.timers, memory_system=mem
        )
        mem.add_video(video_id, path)
        frames, audio = extracted["frames"], extracted["audio"]
        fssim = frames.get("frame_ssim")
        mem.process_sequence(
            video_id,
            frame_paths=frames.get("frame_paths", []),
            frame_times=frames.get("frame_times", []),
            frames_rgb=frames.get("frames_rgb"),
            audio_data=audio.get("audio"),
            video_duration=frames.get("duration"),
            auto_consolidate=True,
            frame_ssim=np.asarray(fssim, np.float32) if fssim is not None else None,
            vision_stream=frames.get("vision_stream"),
        )
    except Exception:
        # the same per-video purge as process_video_folder's: a long-lived engine
        # must not keep a failed attempt's pending ASR or partial state
        mem.discard_pending(video_id)
        raise
    wall = time.perf_counter() - t0
    return {
        "total": 1, "processed": 1, "skipped": 0, "failed": 0, "errors": {},
        "video_id": video_id,
        "wall_seconds": wall,
        "media_seconds": float(frames.get("duration") or 0.0),
        "engine": mem.get_stats(),
    }


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    """(reference: batch_process.py:749-826 — same flags: --path takes a
    single video file or a folder; --skip-existing / --checkpoint-interval /
    --sort-by accepted verbatim). The engine runs on `device` (None: CUDA)."""
    parser = argparse.ArgumentParser(description="hippomm batch video ingest (PyTorch)")
    parser.add_argument(
        "--path", required=True,
        help="video file or folder of videos (.mp4/.mov/.mkv/.avi/.y4m/.webm)",
    )
    parser.add_argument("--memory_store", "--memory-store", default="memory_store")
    parser.add_argument("--config", default=None)
    parser.add_argument(
        "--sort", "--sort-by", dest="sort", choices=("name", "time", "size"), default="name"
    )
    parser.add_argument(
        "--checkpoint-every", "--checkpoint-interval", dest="checkpoint_every",
        type=int, default=5,
    )
    parser.add_argument("--limit", type=int, default=None)
    # reference flag (batch_process.py:758); skipping already-ingested videos
    # is the default, --no-skip-existing forces reprocessing
    parser.add_argument("--skip-existing", dest="skip_existing", action="store_true", default=True)
    parser.add_argument("--no-skip-existing", dest="skip_existing", action="store_false")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    config = load_config(args.config)
    config.storage.base_dir = args.memory_store

    if os.path.isfile(args.path):
        return ingest_single_file(
            args.path, args.memory_store, config=config,
            skip_existing=args.skip_existing, device=device,
        )

    return process_video_folder(
        args.path,
        args.memory_store,
        config=config,
        sort_by=args.sort,
        checkpoint_every=args.checkpoint_every,
        limit=args.limit,
        skip_existing=args.skip_existing,
        device=device,
    )


def cli() -> int:
    """Console-script entry: exit 0 when every video ingested, 1 otherwise."""
    stats = main()
    return 1 if stats.get("failed") else 0


if __name__ == "__main__":
    raise SystemExit(cli())
