"""Config system (the PyTorch port's own copy of hippomm_tpu/config.py).

Same YAML schema as the reference (reference: config/default_config.yaml:1-50),
loaded into typed dataclasses with the reference's defaults. The reference reads the
YAML with ``yaml.safe_load`` and then sprinkles ``config.get(..., default)`` calls
through the engine (hippocampal_memory.py:253-266); here the schema is explicit and
validated once.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

DEFAULT_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "config",
    "default_config.yaml",
)


@dataclasses.dataclass
class SystemConfig:
    # kept for the YAML schema only: it has no effect (nothing reads it, as
    # in the JAX package); the entry points' `device=` argument decides
    device: str = "tpu"
    # mesh axis sizes over the engine's local devices (parallel/mesh.py);
    # mesh_data None = every device left after model x replicas
    mesh_data: Optional[int] = None
    mesh_model: int = 1
    # a leading "replica" axis: the batch splits over replica x data
    mesh_replicas: int = 1
    # when set, each call of the ingest CLI (a folder or a single file) runs
    # under torch.profiler and writes one Chrome trace into this directory,
    # the program's hippomm.* spans beside the kernels (stage timers are
    # always on; this is the trace half)
    profile_dir: Optional[str] = None


@dataclasses.dataclass
class ModelsConfig:
    imagebind_path: str = "pretrained/imagebind"
    whisper_model: str = "distil-large-v3"
    # checkpoint file or dir (pytorch_model.bin / whisper.pth); empty = the
    # variant's random-init / stub towers
    whisper_path: str = ""
    qwen_path: str = "pretrained/Qwen/Qwen2.5-VL-7B-Instruct"
    # hippomm_tpu extensions: tiny configs for hermetic runs without checkpoints
    imagebind_variant: str = "huge"  # "huge" | "tiny" (tests)
    whisper_variant: str = "distil-large-v3"  # or "tiny" (tests)
    whisper_random_init: bool = False  # full-scale random weights (benchmarks)
    # DEVIATION from the reference's beam_size=5 (foundation_models.py:190):
    # that is faster-whisper's generic default, not a distil-tuned choice —
    # the distil-whisper release evaluates distil-large-v3 with greedy decode
    # (negligible WER delta on distilled models), while beam-5 costs ~2x ASR
    # throughput on TPU (SCALING.md: greedy ~150x vs beam-5 ~75x realtime).
    # Greedy is therefore the shipped default; set 5 for reference behavior
    # (beam decode shards across the mesh either way).
    whisper_beam_size: int = 1
    compute_dtype: str = "bfloat16"
    # port extension: "" (the default) sends frame captions and event
    # summaries to the api endpoints; a Kimi-VL variant
    # ("kimi-vl-a3b-instruct", or "tiny" in tests) runs that model in
    # process on the engine's device, in compute_dtype (bfloat16 on CUDA),
    # as both the frame-captioning client and the summariser (models/kimi_vl)
    vlm_variant: str = ""


@dataclasses.dataclass
class MemoryConfig:
    max_short_term: int = 10
    max_long_term: int = 100
    # drop a video's in-memory STMs once its ThetaEvent is persisted (the
    # per-video checkpoint on disk keeps them resumable); keeps folder-ingest
    # RSS flat instead of growing ~2-5 MB per video forever
    evict_after_replay: bool = True


@dataclasses.dataclass
class StorageConfig:
    base_dir: str = "memory_store"
    # "json": features as nested lists inside the event JSON (reference-
    # byte-compatible, hippocampal_memory.py:320-353). "npz": features in an
    # .npz sidecar with a marker in the JSON — ~10× smaller and much faster
    # to load for hour-scale stores. Loading understands BOTH, always.
    features_format: str = "json"


@dataclasses.dataclass
class ProcessingConfig:
    max_segment_duration: float = 30.0
    min_segment_duration: float = 10.0
    frame_similarity_threshold: float = 0.95
    audio_silence_threshold: float = -40.0
    frame_buffer_size: int = 32
    # knobs the reference hard-codes (batch_process.py:193-199, 303;
    # hippocampal_memory.py:945, 3153, 3156, 1673)
    keyframe_diff_threshold: float = 0.3
    ingest_silence_db: float = -50.0
    keyframe_dedup_threshold: float = 0.9
    retrieval_top_k: int = 5
    low_similarity_gate: float = 0.4
    # detailed-recall window re-decode keeps a frame only when its SSIM vs the
    # last KEPT frame is <= this (reference discards similarity > 0.3,
    # hippocampal_memory.py:2236-2239)
    recall_dedup_threshold: float = 0.3
    fast_path_confidence: float = 0.7
    whisper_chunk_seconds: float = 600.0
    token_budget: int = 120_000


@dataclasses.dataclass
class EndpointConfig:
    base_url: str = "http://localhost:8000/v1"
    api_key: str = "your_api_key"
    model_name: str = ""


@dataclasses.dataclass
class FrameProcessingConfig:
    base_urls: List[str] = dataclasses.field(
        default_factory=lambda: ["http://localhost:8000/v1"]
    )
    api_key: str = "your_api_key"


@dataclasses.dataclass
class ApiConfig:
    qwen: EndpointConfig = dataclasses.field(
        default_factory=lambda: EndpointConfig(model_name="Qwen/Qwen2.5-VL-7B-Instruct")
    )
    reasoning: EndpointConfig = dataclasses.field(
        default_factory=lambda: EndpointConfig(base_url="", model_name="gpt-4o")
    )
    frame_processing: FrameProcessingConfig = dataclasses.field(
        default_factory=FrameProcessingConfig
    )
    # hippomm_tpu extension: "stub" makes all VLM/LLM clients deterministic local
    # stubs so the whole pipeline runs hermetically (the reference requires live
    # vLLM/OpenAI endpoints even for `--list`, hippocampal_memory.py:228-231).
    mode: str = "auto"  # "auto" | "http" | "stub"


@dataclasses.dataclass
class Config:
    system: SystemConfig = dataclasses.field(default_factory=SystemConfig)
    models: ModelsConfig = dataclasses.field(default_factory=ModelsConfig)
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    processing: ProcessingConfig = dataclasses.field(default_factory=ProcessingConfig)
    api: ApiConfig = dataclasses.field(default_factory=ApiConfig)

    # Mapping-style access for reference-compatible call sites:
    # config.get("processing", {}).get("frame_buffer_size", 32)
    def get(self, key: str, default: Any = None) -> Any:
        if not hasattr(self, key):
            return default
        val = getattr(self, key)
        if dataclasses.is_dataclass(val):
            return _AsMapping(val)
        return val

    def __getitem__(self, key: str) -> Any:
        val = self.get(key, _MISSING)
        if val is _MISSING:
            raise KeyError(key)
        return val

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_MISSING = object()


class _AsMapping:
    """Read-only mapping view over a dataclass (nested .get support)."""

    def __init__(self, obj):
        self._obj = obj

    def get(self, key, default=None):
        if not hasattr(self._obj, key):
            return default
        val = getattr(self._obj, key)
        if dataclasses.is_dataclass(val):
            return _AsMapping(val)
        return val

    def __getitem__(self, key):
        val = self.get(key, _MISSING)
        if val is _MISSING:
            raise KeyError(key)
        return val

    def __getattr__(self, key):
        return getattr(self._obj, key)


def _update_dataclass(dc, data: Dict[str, Any]):
    for f in dataclasses.fields(dc):
        if f.name not in data:
            continue
        val = data[f.name]
        cur = getattr(dc, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _update_dataclass(cur, val)
        else:
            setattr(dc, f.name, val)
    return dc


def load_config(path: Optional[str] = None) -> Config:
    """Load YAML config (reference schema) into a Config, applying defaults."""
    cfg = Config()
    if path is None and os.path.exists(DEFAULT_CONFIG_PATH):
        path = DEFAULT_CONFIG_PATH
    if path is not None and os.path.exists(path):
        # PyYAML only when there is a file to read: Config() needs nothing
        # beyond the standard library
        import yaml

        with open(path, "r") as f:
            data = yaml.safe_load(f) or {}
        _update_dataclass(cfg, data)
    return cfg
