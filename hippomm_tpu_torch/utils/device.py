"""Device resolution and device→host reads for the port.

Every entry point takes an explicit `device`. None means CUDA: the port is
written for the card, and a host without CUDA raises instead of quietly
running the plain CPU path — the CPU is for callers (tests) that ask for it.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Turn a caller's `device` into a torch.device; None means CUDA.

    Raises RuntimeError when CUDA is asked for (explicitly or by default) and
    this host has none. On CUDA it pins fp32 numerics: TF32 off for both
    cuBLAS matmuls and cuDNN convolutions (cuDNN's default is TF32, about
    three decimal digits — enough to fake SSIM scene cuts)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hippomm_tpu_torch runs on CUDA by default and this host has "
                "no CUDA device; pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def as_tensors(*xs, device: DeviceLike = None) -> List[torch.Tensor]:
    """The inputs of a tensor op as tensors on one device, each keeping its
    dtype: the first tensor's device among `xs`, else `device` (None: CUDA).
    A tensor input thus stays on its own device (a later one joins the
    first's), and an array (or list) follows it. The JAX package's ops take
    arrays and run on the default device; so do these, and a CPU-only host
    raises unless the caller asks for the CPU."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    if dev is None:
        dev = resolve_device(device)
    return [x.to(dev) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=dev) for x in xs]


def fetch(x, dtype=None) -> np.ndarray:
    """Tensor (any device) -> numpy float32 (or `dtype`). Synchronous: a
    device fault surfaces here, at the read, rather than being retried."""
    if isinstance(x, np.ndarray):
        return x if dtype is None else np.asarray(x, dtype)
    out = x.detach().float().cpu().numpy()
    return out if dtype is None else out.astype(dtype, copy=False)

