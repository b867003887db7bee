"""Memory consolidation (reference: hippocampal_memory.py:540-967).

The port's counterpart of hippomm_tpu/memory/consolidation.py.

Merges a video's ShortTermMemories into one consolidated record: vision
features stacked with their times and deduplicated to key frames via the
greedy cosine scan (ops/similarity.select_keyframes: host numpy up to
256 rows, the device above — the reference
builds the N×N similarity matrix in numpy and greedy-loops in Python,
:944-967); audio features stacked with segment start times; transcriptions
concatenated in temporal order. No mp.Pool theatrics (the reference opens a
Pool(4) it never uses, :791-802).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from hippomm_tpu_torch.memory.schema import ShortTermMemory
from hippomm_tpu_torch.ops.similarity import select_keyframes
from hippomm_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def consolidate_short_term_memory(
    stms: List[ShortTermMemory],
    keyframe_threshold: float = 0.9,
    device=None,
) -> Optional[Dict]:
    """All STMs of one video -> consolidated dict (pre-ThetaEvent). The
    key-frame dedup runs on `device` (None: resolve_device, CUDA).

    Returns {features, feature_times, frames, frame_times, audio_times,
    audio_transcription, modalities, start_time, end_time, keyframe_indices}.
    """
    device = resolve_device(device)
    if not stms:
        return None
    stms = sorted(stms, key=lambda m: m.segment_info.get("start_time", m.source_time))

    modalities: List[str] = []
    for stm in stms:
        for m in stm.modalities:
            if m not in modalities:
                modalities.append(m)

    out: Dict = {
        "features": {},
        "feature_times": {},
        "frames": [],
        "frame_times": [],
        "audio_times": [],
        "audio_transcription": [],
        "modalities": modalities,
        # fallback mirrors the sort key: an STM missing segment_info (e.g.
        # loaded from a reference-written checkpoint) must not drag the event
        # span to 0 while sorting by its real source_time
        "start_time": min(
            s.segment_info.get("start_time", s.source_time) for s in stms
        ),
        "end_time": max(
            s.segment_info.get("end_time", s.source_time) for s in stms
        ),
    }

    # ---- vision: stack, then on-device key-frame dedup ----
    vis_feats, vis_times, vis_frames = [], [], []
    for stm in stms:
        f = stm.features.get("vision")
        if f is None or f.shape[0] == 0:
            continue
        times = stm.segment_info.get("frame_times", [])
        frames = stm.segment_info.get("frames", [])
        for i in range(f.shape[0]):
            vis_feats.append(f[i])
            vis_times.append(times[i] if i < len(times) else stm.source_time)
            vis_frames.append(frames[i] if i < len(frames) else "")
    if vis_feats:
        feats = np.stack(vis_feats).astype(np.float32)
        keep = select_keyframes(feats, threshold=keyframe_threshold, device=device)
        out["features"]["vision"] = feats[keep]
        out["feature_times"]["vision"] = [vis_times[i] for i in keep]
        out["frames"] = [vis_frames[i] for i in keep]
        out["frame_times"] = [vis_times[i] for i in keep]
        out["keyframe_indices"] = [int(i) for i in keep]

    # ---- audio: stack features + start times, concat transcriptions ----
    # audio_times parallels the audio FEATURE rows exactly (reference
    # :869-927). A transcription-only STM (full-track ASR assigns entries by
    # midpoint even to segments whose audio was too short/silent to embed)
    # contributes its transcripts but must NOT inject a time row — that
    # shifted every later feature's timestamp in the search index.
    # Transcription entries carry their own start/end.
    aud_feats, aud_times, transcripts = [], [], []
    for stm in stms:
        f = stm.features.get("audio")
        if f is not None and f.shape[0] > 0:
            for i in range(f.shape[0]):
                aud_feats.append(f[i])
                aud_times.append(stm.segment_info.get("start_time", stm.source_time))
        if stm.transcription:
            # per-ASR-segment entries carry their own timestamps; the merged
            # event keeps them flat (reference extends, hippocampal_memory.py:893)
            transcripts.extend(stm.transcription)
    if aud_feats:
        out["features"]["audio"] = np.stack(aud_feats).astype(np.float32)
        out["feature_times"]["audio"] = list(aud_times)
    out["audio_times"] = aud_times
    out["audio_transcription"] = transcripts

    return out
