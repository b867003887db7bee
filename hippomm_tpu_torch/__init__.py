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
  train/    contrastive training (fp32 masters, optax-AdamW) and its
            parameter checkpoints
  media/    synthetic clips, the JPEG and thumbnail helpers of recall
  utils/    device resolution, stage timers, token counting

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
