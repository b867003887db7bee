"""ImageBind contrastive fine-tuning on one device.

Counterpart of the single-device path of hippomm_tpu/train/contrastive.py
(`contrastive_loss`, `init_train_state`, `make_train_step`): symmetric
InfoNCE between the vision and text towers, fp32 master parameters, bf16
compute, and AdamW with optax.adamw's semantics.

The towers run through the kernels as the forward does (models/layers: K1
and K2, or K3 and K4 under HIPPOMM_FUSED_BLOCK=1 / HIPPOMM_FLASH_BTHD=1);
the kernel wrappers are differentiable, their backward the JAX package's
custom_vjp recompute in plain PyTorch. The audio tower is in the parameter
tree but not in the loss: its gradient is zero, and weight decay still
moves it every step, as optax's does.

The JAX module's pipeline (`init_train_state_pp`, `make_train_step_pp`),
Switch-MoE adapter (`init_moe_adapter_state`, `make_train_step_moe`) and
ZeRO-1 paths need the training half of the parallel layer (tensor and
sequence parallelism, the pipeline, the MoE adapter, ZeRO-1), which the port
does not have yet (ROADMAP.md, queue 1 item 7): a mesh or zero1=True raises.
The serving half (parallel/mesh.py, parallel/sharded_store.py) does not
train.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hippomm_tpu_torch.models.imagebind.model import (
    ImageBindConfig,
    init_imagebind,
    text_forward,
    vision_forward,
)
from hippomm_tpu_torch.train.checkpoint import flatten_params
from hippomm_tpu_torch.utils.device import DeviceLike, resolve_device

_NO_PARALLEL = ("needs the training half of the port's parallel layer, which is not ported yet "
                "(ROADMAP.md, queue 1 item 7)")


def contrastive_loss(params: Dict, images: torch.Tensor, tokens: torch.Tensor, cfg: ImageBindConfig,
                     dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE between vision and text embeddings: images
    (B, 3, S, S), tokens (B, T). The towers' embeddings are L2-normalized
    (text scaled by the learnable logit scale), so v·tᵀ are the logits, in
    fp32. Returns (loss, {"loss", "accuracy"})."""
    v = vision_forward(params, images, cfg, dtype)  # (B, D), unit norm
    t = text_forward(params, tokens, cfg, dtype)  # (B, D), scaled
    logits = v.float() @ t.float().t()  # (B, B)
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels))
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


class AdamW:
    """optax.adamw as plain tensor functions: optax's b1 0.9, b2 0.999, eps
    1e-8 and eps_root 0, bias correction, and decoupled weight decay on
    every leaf — also on a leaf whose gradient is None (the audio tower's),
    which torch.optim.AdamW would skip. Its moments are fp32, keyed by the
    parameter tree's dotted paths (train/checkpoint.flatten_params)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict, learning_rate: float, weight_decay: float = 1e-4):
        self.lr, self.weight_decay = learning_rate, weight_decay
        leaves = flatten_params(params)
        self.mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in leaves.items()}
        self.nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in leaves.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """One update of `params`' leaves in place; `grads` by dotted path,
        None for a leaf outside the loss (a zero gradient)."""
        leaves = flatten_params(params)
        if list(leaves) != list(self.mu):
            raise ValueError("AdamW.step: the parameter tree is not the one the optimizer was made for")
        p = list(leaves.values())
        g = [torch.zeros_like(x) if grads.get(k) is None else grads[k] for k, x in leaves.items()]
        mu, nu = list(self.mu.values()), list(self.nu.values())
        self.count += 1
        b1, b2 = self.B1, self.B2
        # optax's order: (1 - b)·g^order + b·moment; bias corrections
        # 1 - b**count in fp32, as optax computes them from an int32 count
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        del g
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.lr)


def _master(params: Dict) -> Dict:
    """Check that every leaf is an fp32 master and make it a grad leaf."""
    for key, p in flatten_params(params).items():
        if p.dtype != torch.float32:
            raise ValueError(f"training keeps fp32 master parameters; {key} is {p.dtype} "
                             "(init_imagebind / params_from_jax with dtype=torch.float32)")
        p.requires_grad_(True)
    return params


def init_train_state(cfg: ImageBindConfig, device: DeviceLike = None, learning_rate: float = 1e-5,
                     weight_decay: float = 0.01, seed: int = 0, params: Optional[Dict] = None,
                     mesh=None, zero1: bool = False) -> Tuple[Dict, AdamW]:
    """(params, optimizer): fp32 master parameters on `device` (CUDA unless
    the caller asks for the CPU) from init_imagebind's seeded
    torch.Generator, or the caller's `params` (fp32 leaves, such as
    params_from_jax(..., dtype=torch.float32) gives) made grad leaves in
    place; and AdamW with optax.adamw's semantics."""
    if mesh is not None or zero1:
        raise NotImplementedError(f"a mesh and ZeRO-1 {_NO_PARALLEL}")
    dev = resolve_device(device)
    if params is None:
        params = init_imagebind(cfg, dev, dtype=torch.float32, seed=seed)
    params = _master(params)
    return params, AdamW(params, learning_rate, weight_decay=weight_decay)


def make_train_step(cfg: ImageBindConfig, optimizer: AdamW, dtype=torch.bfloat16, mesh=None):
    """step(params, images, tokens) -> metrics: forward, backward and one
    optimizer update of `params` in place. images (B, 3, S, S) float and
    tokens (B, T) int, tensors or arrays, go to the parameters' device."""
    if mesh is not None:
        raise NotImplementedError(f"a mesh {_NO_PARALLEL}")

    def step(params: Dict, images, tokens) -> Dict[str, torch.Tensor]:
        dev = next(iter(flatten_params(params).values())).device
        metrics, grads = loss_and_grads(params, torch.as_tensor(images, device=dev),
                                        torch.as_tensor(tokens, device=dev), cfg, dtype)
        optimizer.step(params, grads)
        return metrics

    return step


def loss_and_grads(params: Dict, images: torch.Tensor, tokens: torch.Tensor, cfg: ImageBindConfig,
                   dtype=torch.bfloat16) -> Tuple[Dict[str, torch.Tensor], Dict[str, Optional[torch.Tensor]]]:
    """(detached metrics of `contrastive_loss`, {dotted path: gradient})
    over the leaves that require grad; None marks a leaf outside the loss
    (the audio tower)."""
    leaves = {k: p for k, p in flatten_params(params).items() if p.requires_grad}
    _, metrics = contrastive_loss(params, images, tokens, cfg, dtype)
    grads = torch.autograd.grad(metrics["loss"], list(leaves.values()), allow_unused=True)
    return {k: v.detach() for k, v in metrics.items()}, dict(zip(leaves, grads))
