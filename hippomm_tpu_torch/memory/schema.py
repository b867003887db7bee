"""Memory data schema — field-for-field parity with the reference dataclasses
(reference: hippocampal_memory.py:35-148) and their persisted JSON layout
(save_theta_event, hippocampal_memory.py:320-353), so memory stores written by
either implementation interoperate.

All feature vectors are EMBED_DIM=1024-d (the ImageBind joint space); the same
dimension checks the reference scatters through load/merge paths
(hippocampal_memory.py:418-426, 483-487, 826-831) are centralized here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

EMBED_DIM = 1024


def _validate_features(feats: Optional[np.ndarray], name: str) -> Optional[np.ndarray]:
    if feats is None:
        return None
    arr = np.asarray(feats, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.shape[-1] != EMBED_DIM:
        # reference transpose-fix: old stores saved (1024, N)
        if arr.ndim == 2 and arr.shape[0] == EMBED_DIM:
            arr = arr.T
        else:
            raise ValueError(f"{name} features must be (*, {EMBED_DIM}), got {arr.shape}")
    return arr


def _normalize_transcript_list(
    x, fallback_start: float = 0.0, per_item_starts=None
) -> List[Dict[str, Any]]:
    """Coerce a transcription field to the reference's list-of-entries form:
    strings (legacy events/checkpoints) wrap as single entries; entry dicts
    pass through. per_item_starts supplies each legacy string's own start
    time (events stored audio_times aligned 1:1 with the string list —
    collapsing them to one fallback would break speech localization on old
    stores)."""
    if isinstance(x, str):
        x = [x] if x.strip() else []
    starts = list(per_item_starts or [])
    out: List[Dict[str, Any]] = []
    for i, item in enumerate(x or []):
        if isinstance(item, dict):
            out.append(item)
        else:
            txt = str(item).strip()
            if txt:
                st = float(starts[i]) if i < len(starts) else float(fallback_start)
                out.append({"text": txt, "start": st})
    return out


@dataclasses.dataclass
class SequenceSegment:
    """One temporal segment produced by pattern separation
    (reference: hippocampal_memory.py:35-42)."""

    start_time: float
    end_time: float
    frames: List[str] = dataclasses.field(default_factory=list)  # frame file paths
    audio_data: Optional[np.ndarray] = None  # 16 kHz mono float32
    frame_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time


@dataclasses.dataclass
class ShortTermMemory:
    """Per-segment perceptual encoding (reference: hippocampal_memory.py:45-92)."""

    features: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    content: str = ""
    timestamp: float = 0.0
    source_time: float = 0.0
    modalities: List[str] = dataclasses.field(default_factory=list)
    segment_info: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # timestamped ASR entries {"text","start","end"} (reference field type,
    # hippocampal_memory.py:54); a plain string normalizes to one entry
    transcription: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        for k in list(self.features):
            self.features[k] = _validate_features(self.features[k], k)
        self.transcription = _normalize_transcript_list(
            self.transcription, self.source_time
        )

    def transcription_text(self) -> str:
        return " ".join(t.get("text", "") for t in self.transcription).strip()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "features": {
                k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in self.features.items()
            },
            "content": self.content,
            "timestamp": self.timestamp,
            "source_time": self.source_time,
            "modalities": list(self.modalities),
            "segment_info": self.segment_info,
            "transcription": self.transcription,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ShortTermMemory":
        feats = {
            k: np.asarray(v, dtype=np.float32) for k, v in (d.get("features") or {}).items()
        }
        return cls(
            features=feats,
            content=d.get("content", ""),
            timestamp=d.get("timestamp", 0.0),
            source_time=d.get("source_time", 0.0),
            modalities=list(d.get("modalities", [])),
            segment_info=d.get("segment_info", {}),
            transcription=d.get("transcription", []),
        )


@dataclasses.dataclass
class ThetaEvent:
    """Consolidated long-term memory event (reference: hippocampal_memory.py:95-133).

    Persisted as events/<video_id>/<event_id>.json with features as nested lists
    (save_theta_event, :320-353); event_id = f"{video_id}_{int(start_time*1000)}".
    """

    event_id: str = ""
    video_id: str = ""
    features: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    feature_times: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    frames: List[str] = dataclasses.field(default_factory=list)  # key-frame paths
    frame_times: List[float] = dataclasses.field(default_factory=list)
    frame_captions: List[str] = dataclasses.field(default_factory=list)
    audio_times: List[float] = dataclasses.field(default_factory=list)
    # per-ASR-segment timestamped entries {"text","start","end"} (reference
    # field type, hippocampal_memory.py:104 — consolidation extends the STMs'
    # entry lists, :893); legacy strings normalize to entries
    audio_transcription: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # whole-track transcription as TIMESTAMPED entries {"text","start","end"}
    # (reference field type, hippocampal_memory.py:105 — its speech
    # localization iterates these with trans["start"], :2333-2345)
    holistic_audio_transcription: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    summary: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    modalities: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        for k in list(self.features):
            self.features[k] = _validate_features(self.features[k], k)
        if not self.event_id and self.video_id:
            self.event_id = f"{self.video_id}_{int(self.start_time * 1000)}"
        self.audio_transcription = _normalize_transcript_list(
            self.audio_transcription, self.start_time, per_item_starts=self.audio_times
        )
        if isinstance(self.holistic_audio_transcription, str):
            # legacy/convenience: a flat string becomes one whole-span entry
            txt = self.holistic_audio_transcription.strip()
            self.holistic_audio_transcription = (
                [{"text": txt, "start": float(self.start_time), "end": float(self.end_time)}]
                if txt
                else []
            )

    def transcript_texts(self) -> List[str]:
        """Per-segment transcription texts (prompt assembly)."""
        return [t.get("text", "") for t in self.audio_transcription if t.get("text")]

    def holistic_text(self) -> str:
        """The whole-track transcription as one string (prompt assembly)."""
        return " ".join(
            t.get("text", "") for t in self.holistic_audio_transcription
        ).strip()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "event_id": self.event_id,
            "video_id": self.video_id,
            "features": {
                k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in self.features.items()
            },
            "feature_times": {k: list(map(float, v)) for k, v in self.feature_times.items()},
            "frames": list(self.frames),
            "frame_times": list(map(float, self.frame_times)),
            "frame_captions": list(self.frame_captions),
            "audio_times": list(map(float, self.audio_times)),
            "audio_transcription": list(self.audio_transcription),
            "holistic_audio_transcription": list(self.holistic_audio_transcription),
            "summary": self.summary,
            "start_time": float(self.start_time),
            "end_time": float(self.end_time),
            "modalities": list(self.modalities),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ThetaEvent":
        feats = {}
        for k, v in (d.get("features") or {}).items():
            if v is None:
                continue
            feats[k] = _validate_features(np.asarray(v, dtype=np.float32), k)
        return cls(
            event_id=d.get("event_id", ""),
            video_id=d.get("video_id", ""),
            features=feats,
            feature_times={k: list(v) for k, v in (d.get("feature_times") or {}).items()},
            frames=list(d.get("frames", [])),
            frame_times=list(d.get("frame_times", [])),
            frame_captions=list(d.get("frame_captions", [])),
            audio_times=list(d.get("audio_times", [])),
            audio_transcription=list(d.get("audio_transcription", [])),
            holistic_audio_transcription=d.get("holistic_audio_transcription", []),
            summary=d.get("summary", ""),
            start_time=d.get("start_time", 0.0),
            end_time=d.get("end_time", 0.0),
            modalities=list(d.get("modalities", [])),
        )


@dataclasses.dataclass
class QARecallResult:
    """Answer + introspection flags (reference: hippocampal_memory.py:136-148)."""

    answer: str = ""
    confidence: float = 0.0
    reasoning: str = ""
    retrieved_segments: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    question_type: str = ""
    used_direct_answer: bool = False
    used_corner_case: bool = False
    primary_modality: str = ""
    segments_analyzed: int = 0
    used_reflection: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
