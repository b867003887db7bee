"""hippomm_tpu_torch — the PyTorch/CUDA port of hippomm_tpu for NVIDIA Hopper.

The JAX package `hippomm_tpu` stays the reference; this package imports
nothing of it (and never `jax`). Subpackages mirror the JAX layout so each
module's counterpart is found under the same name:

  ops/      hand-written Hopper kernels (csrc/) behind wrappers with plain
            PyTorch versions, plus the tensor ops of the ingest path
  models/   transformer layers, ImageBind towers, foundation wrappers
  memory/   segmentation, consolidation, the HippocampalMemory engine
  retrieval/ feature search, token budgets, dual-pathway QA
  core/     the query CLI (ask_question)
  train/    contrastive training (fp32 masters, optax-AdamW) on one
            device or a mesh (tensor parallel, ZeRO-1, the GPipe pipeline,
            the Switch-MoE adapter), and its parameter checkpoints
  parallel/ device meshes and sharding rules, the sharded feature store,
            the collectives, Megatron TP+SP and GPipe, expert parallelism
  media/    synthetic clips, the JPEG and thumbnail helpers of recall
  benchmarks/ the QA-accuracy harness (bench.py config #5) and its CLI
  utils/    device resolution, stage timers, token counting

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from hippomm_tpu_torch.memory.schema import (  # noqa: F401
    QARecallResult,
    SequenceSegment,
    ShortTermMemory,
    ThetaEvent,
)


def load_config(path=None):
    from hippomm_tpu_torch.config import load_config as _lc

    return _lc(path)
