"""Kernel layer: the Hopper kernels' wrappers (flash_attention, fused_mlp,
topk) and the tensor ops of the ingest and retrieval paths. The names below
are the JAX package's `hippomm_tpu.ops` exports."""

from hippomm_tpu_torch.ops.resize import (  # noqa: F401
    normalize_nchw,
    resize_crop_u8,
    resize_normalize,
)
from hippomm_tpu_torch.ops.silence import detect_silence_regions, window_rms_db  # noqa: F401
from hippomm_tpu_torch.ops.similarity import (  # noqa: F401
    cosine_sim_matrix,
    l2_normalize,
    select_keyframes_mask,
    top_k_cosine,
)
from hippomm_tpu_torch.ops.ssim import batched_ssim, ssim_pairs  # noqa: F401
