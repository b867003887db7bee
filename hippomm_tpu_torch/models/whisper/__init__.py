"""Whisper: the encoder and the KV-cached greedy / beam decoders
(model.py), long-form transcription (transcribe.py), checkpoint conversion
(convert.py) and the JAX parameter carry (carry.py). The names below are
the JAX package's `hippomm_tpu.models.whisper` exports."""

from hippomm_tpu_torch.models.whisper.model import (  # noqa: F401
    WhisperConfig,
    encoder_forward,
    greedy_decode,
    init_whisper,
)
from hippomm_tpu_torch.models.whisper.transcribe import WhisperTranscriber  # noqa: F401
