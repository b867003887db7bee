"""Whisper transcription surface of the port: the timestamped `Segment`.

The JAX Whisper tower and its batched decoder are a later slice of the port;
the engine's stub transcriber already speaks in these segments.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Segment:
    start: float
    end: float
    text: str
