"""Persistence: memory_store/ tree, indices, theta-event JSON, STM checkpoints.

Disk layout is byte-compatible with the reference so stores interoperate
(SURVEY.md layer map, hippocampal_memory.py:272-288):

    memory_store/
      frames/<video_id>/t_<sec>/frame_<n>.jpg   (+ metadata.yaml)
      audio/<video_id>/audio.npy                (+ metadata.yaml)
      events/<video_id>/<event_id>.json         (features as nested lists)
      checkpoints/<video_id>_stm.json           (features base64-encoded)
      video_index.json / event_index.json
"""

from __future__ import annotations

import base64
import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

from hippomm_tpu_torch.memory.schema import ShortTermMemory, ThetaEvent

logger = logging.getLogger(__name__)


def numpy_to_base64(arr: np.ndarray) -> Dict:
    """Feature encoding used by STM checkpoints (reference:
    hippocampal_memory.py:308-313)."""
    arr = np.asarray(arr, dtype=np.float32)
    return {
        "b64": base64.b64encode(arr.tobytes()).decode("ascii"),
        "shape": list(arr.shape),
        "dtype": "float32",
    }


def base64_to_numpy(obj: Dict) -> np.ndarray:
    data = base64.b64decode(obj["b64"])
    return np.frombuffer(data, dtype=obj.get("dtype", "float32")).reshape(obj["shape"]).copy()


class MemoryStore:
    """Owns the on-disk layout + JSON indices."""

    def __init__(self, base_dir: str, features_format: str = "json"):
        self.base_dir = base_dir
        self.features_format = features_format
        self.frames_dir = os.path.join(base_dir, "frames")
        self.audio_dir = os.path.join(base_dir, "audio")
        self.events_dir = os.path.join(base_dir, "events")
        self.checkpoints_dir = os.path.join(base_dir, "checkpoints")
        for d in (self.frames_dir, self.audio_dir, self.events_dir, self.checkpoints_dir):
            os.makedirs(d, exist_ok=True)
        self.video_index_path = os.path.join(base_dir, "video_index.json")
        self.event_index_path = os.path.join(base_dir, "event_index.json")
        self.video_index: Dict[str, Dict] = self._load_index(self.video_index_path)
        self.event_index: Dict[str, Dict] = self._load_index(self.event_index_path)

    # -- indices ------------------------------------------------------------

    @staticmethod
    def _load_index(path: str) -> Dict:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)
            except Exception:
                logger.exception("corrupt index %s; starting fresh", path)
        return {}

    def save_indices(self) -> None:
        for path, idx in (
            (self.video_index_path, self.video_index),
            (self.event_index_path, self.event_index),
        ):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(idx, f, indent=2)
            os.replace(tmp, path)

    def add_video(self, video_id: str, video_path: str) -> None:
        self.video_index[video_id] = {"path": video_path}
        self.save_indices()

    def has_video(self, video_id: str) -> bool:
        return video_id in self.video_index

    def video_path(self, video_id: str) -> Optional[str]:
        entry = self.video_index.get(video_id)
        return entry.get("path") if entry else None

    # -- theta events ---------------------------------------------------------

    def save_theta_event(self, event: ThetaEvent) -> str:
        """events/<video_id>/<event_id>.json, features as nested lists
        (reference: hippocampal_memory.py:320-353) — or, with
        features_format="npz", as an .npz sidecar referenced from the JSON
        (hour-scale stores: ~10× smaller, no float parsing on load)."""
        d = os.path.join(self.events_dir, event.video_id)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{event.event_id}.json")
        if self.features_format == "npz" and event.features:
            import numpy as np

            # skip to_dict's feature tolist() entirely — boxing a (10k, 1024)
            # block into Python floats costs seconds per save and is thrown
            # away here anyway
            feats, event.features = event.features, {}
            try:
                payload = event.to_dict()
            finally:
                event.features = feats
            npz_path = os.path.join(d, f"{event.event_id}_features.npz")
            # atomic like every other write here: a crash mid-rewrite must
            # not leave the (already-atomic) JSON pointing at a truncated npz
            npz_tmp = npz_path + ".tmp.npz"
            np.savez_compressed(
                npz_tmp,
                **{k: np.asarray(v, np.float32) for k, v in feats.items()},
            )
            os.replace(npz_tmp, npz_path)
            payload["features"] = {"__npz__": os.path.basename(npz_path)}
        else:
            payload = event.to_dict()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        self.event_index[event.event_id] = {
            "video_id": event.video_id,
            "path": path,
            "start_time": event.start_time,
            "end_time": event.end_time,
            "summary": event.summary,
        }
        self.save_indices()
        return path

    def load_theta_event(self, event_id: str) -> ThetaEvent:
        entry = self.event_index.get(event_id)
        if entry is not None and not os.path.exists(entry.get("path", "")):
            entry = None  # stale index row (file moved/deleted): scan instead
        if entry is None:
            # fall back to a filesystem scan (index may be stale)
            for vid in os.listdir(self.events_dir):
                cand = os.path.join(self.events_dir, vid, f"{event_id}.json")
                if os.path.exists(cand):
                    entry = {"path": cand}
                    break
        if entry is None:
            raise KeyError(f"unknown event: {event_id}")
        with open(entry["path"]) as f:
            data = json.load(f)
        feats = data.get("features")
        if isinstance(feats, dict) and "__npz__" in feats:
            import numpy as np

            npz_path = os.path.join(os.path.dirname(entry["path"]), feats["__npz__"])
            with np.load(npz_path) as z:
                data["features"] = {k: z[k] for k in z.files}
        return ThetaEvent.from_dict(data)

    def list_events(self) -> List[str]:
        return sorted(self.event_index)

    def events_for_video(self, video_id: str) -> List[str]:
        return sorted(
            eid for eid, e in self.event_index.items() if e.get("video_id") == video_id
        )

    def load_all_events(self) -> List[ThetaEvent]:
        return [self.load_theta_event(eid) for eid in self.list_events()]

    # -- STM checkpoints ------------------------------------------------------

    def _ckpt_path(self, video_id: str) -> str:
        return os.path.join(self.checkpoints_dir, f"{video_id}_stm.json")

    @staticmethod
    def _encode_stm(stm: ShortTermMemory) -> Dict:
        """STM -> JSON payload with base64 features — WITHOUT paying
        to_dict()'s feature tolist() (boxed floats are discarded here; same
        fix as the npz event save)."""
        feats, stm.features = stm.features, {}
        try:
            d = stm.to_dict()
        finally:
            stm.features = feats
        d["features"] = {k: numpy_to_base64(v) for k, v in feats.items()}
        return d

    @staticmethod
    def _decode_stm(d: Dict) -> ShortTermMemory:
        feats = {k: base64_to_numpy(v) for k, v in (d.get("features") or {}).items()}
        return ShortTermMemory.from_dict(dict(d, features=feats))

    def save_checkpoint(self, video_id: str, stms: List[ShortTermMemory]) -> str:
        """Per-video STM checkpoint, features base64-encoded
        (reference: hippocampal_memory.py:1486-1524)."""
        payload = [self._encode_stm(stm) for stm in stms]
        path = self._ckpt_path(video_id)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"video_id": video_id, "memories": payload}, f)
        os.replace(tmp, path)
        return path

    def has_checkpoint(self, video_id: str) -> bool:
        return os.path.exists(self._ckpt_path(video_id))

    def delete_checkpoint(self, video_id: str) -> None:
        try:
            os.remove(self._ckpt_path(video_id))
        except FileNotFoundError:
            pass

    def load_checkpoint(self, video_id: str) -> Optional[List[ShortTermMemory]]:
        path = self._ckpt_path(video_id)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                data = json.load(f)
            return [self._decode_stm(d) for d in data.get("memories", [])]
        except Exception:
            logger.exception("corrupt checkpoint for %s", video_id)
            return None

    # -- whole-buffer checkpoints (batch driver) -----------------------------

    def save_short_term_buffer(self, buffer: Dict[str, List[ShortTermMemory]], tag: str = "buffer") -> str:
        path = os.path.join(self.checkpoints_dir, f"{tag}.json")
        payload = {vid: [self._encode_stm(s) for s in stms] for vid, stms in buffer.items()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path

    def load_short_term_buffer(self, tag: str = "buffer") -> Dict[str, List[ShortTermMemory]]:
        path = os.path.join(self.checkpoints_dir, f"{tag}.json")
        if not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                data = json.load(f)
            return {
                vid: [self._decode_stm(d) for d in items]
                for vid, items in data.items()
            }
        except Exception:
            # same contract as load_checkpoint: a corrupt driver checkpoint
            # must not crash the resume path
            logger.exception("corrupt short-term buffer checkpoint %s", path)
            return {}
