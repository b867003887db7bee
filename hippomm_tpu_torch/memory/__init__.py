"""The memory: schemas (schema.py), the event store (store.py),
segmentation, consolidation and the HippocampalMemory engine (engine.py).
The names below are the JAX package's `hippomm_tpu.memory` exports."""

from hippomm_tpu_torch.memory.schema import (  # noqa: F401
    QARecallResult,
    SequenceSegment,
    ShortTermMemory,
    ThetaEvent,
)
