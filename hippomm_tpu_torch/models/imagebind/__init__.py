"""The ImageBind towers (model.py), their input preprocessing and
tokenizers (preprocess.py), checkpoint conversion (convert.py, manifest.py)
and the JAX parameter carry (carry.py). The names below are the JAX
package's `hippomm_tpu.models.imagebind` exports."""

from hippomm_tpu_torch.models.imagebind.model import (  # noqa: F401
    ImageBindConfig,
    TowerConfig,
    audio_forward,
    extract_features,
    init_imagebind,
    text_forward,
    vision_forward,
)
