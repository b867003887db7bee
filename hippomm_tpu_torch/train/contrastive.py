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

On a mesh (parallel/mesh.make_mesh over a list of devices, which may
repeat) the step is JAX's GSPMD step: `init_train_state(mesh=)` places the
parameters by param_shardings, the batch splits over replica × data, and
the towers run tensor-parallel over "model" (parallel/tensor_parallel);
gradients sum over every copy of a block. With zero1=True the AdamW moments
are split over "data" as well (zero1_shardings): each moment block's
gradient is the sum of its slice over the parameter's copies (a
reduce-scatter) and its update goes to every copy (an all-gather).
`init_train_state_pp` / `make_train_step_pp` run the vision tower as the
GPipe pipeline of parallel/megatron.py, and `init_moe_adapter_state` /
`make_train_step_moe` train the Switch-MoE adapter of parallel/moe.py over
the frozen towers.
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
from hippomm_tpu_torch.parallel import megatron
from hippomm_tpu_torch.parallel import moe as pmoe
# data_sharding and replicated are importable from here, as from the JAX module
from hippomm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Sharded,
    batch_devices,
    data_sharding,
    gather,
    param_shardings,
    replicate,
    replicated,
    shard_batch,
    shard_tree,
    tree_leaves,
    unshard_tree,
    zero1_shardings,
)
from hippomm_tpu_torch.parallel.tensor_parallel import text_forward_mesh, vision_forward_mesh
from hippomm_tpu_torch.train.checkpoint import flatten_params, unflatten_params
from hippomm_tpu_torch.utils.device import DeviceLike, resolve_device


def contrastive_loss(params: Dict, images: torch.Tensor, tokens: torch.Tensor, cfg: ImageBindConfig,
                     dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE between vision and text embeddings: images
    (B, 3, S, S), tokens (B, T). The towers' embeddings are L2-normalized
    (text scaled by the learnable logit scale), so v·tᵀ are the logits, in
    fp32. Returns (loss, {"loss", "accuracy"})."""
    v = vision_forward(params, images, cfg, dtype)  # (B, D), unit norm
    t = text_forward(params, tokens, cfg, dtype)  # (B, D), scaled
    return info_nce(v, t)


def info_nce(v: torch.Tensor, t: torch.Tensor, extra: Optional[torch.Tensor] = None):
    """(loss, {"loss", "accuracy"}) of the symmetric InfoNCE of fp32 logits
    v·tᵀ; `extra` is added to the loss."""
    logits = v.float() @ t.float().t()  # (B, B)
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels))
    if extra is not None:
        loss = loss + extra
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def contrastive_loss_mesh(params: Dict, images, tokens, cfg: ImageBindConfig, mesh: Mesh,
                          dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """contrastive_loss over a mesh, as JAX's GSPMD step computes it: params
    a tree of Sharded leaves placed by param_shardings; the batch split over
    replica × data, each shard's towers tensor-parallel over its model ranks
    (parallel/tensor_parallel); the embeddings gathered on the mesh's first
    device for the loss over the whole batch."""
    v = vision_forward_mesh(params, images, cfg, mesh, dtype)
    t = text_forward_mesh(params, tokens, cfg, mesh, dtype)
    return info_nce(v, t)


class AdamW:
    """optax.adamw as plain tensor functions: optax's b1 0.9, b2 0.999, eps
    1e-8 and eps_root 0, bias correction, and decoupled weight decay on
    every leaf — also on a leaf whose gradient is None (the audio tower's),
    which torch.optim.AdamW would skip. Its moments are fp32, keyed by the
    parameter tree's dotted paths (train/checkpoint.flatten_params).

    Over a tree of Sharded leaves the moments are Sharded too, by
    `moment_specs` (a tree of specs; default each parameter's own, JAX's
    replicated moments; zero1_shardings for ZeRO-1). Each moment block
    takes the sum of its slice of the gradient over every copy of the
    parameter block that holds it, in the copies' order (a psum over the
    data axes; with ZeRO-1 a reduce-scatter), and its update goes to the
    copy on its own device, and to every copy on a device that holds no
    block of that region (an all-gather)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict, learning_rate: float, weight_decay: float = 1e-4,
                 moment_specs=None):
        self.lr, self.weight_decay = learning_rate, weight_decay
        leaves = flatten_params(params)
        self.sharded = any(isinstance(p, Sharded) for p in leaves.values())
        if self.sharded:
            specs = dict(tree_leaves(moment_specs)) if moment_specs is not None else {}
            self.mu = {k: Sharded.zeros(p.shape, specs.get(k, p.spec), p.mesh) for k, p in leaves.items()}
            self.nu = {k: Sharded.zeros(p.shape, specs.get(k, p.spec), p.mesh) for k, p in leaves.items()}
        else:
            self.mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in leaves.items()}
            self.nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in leaves.items()}
        self.count = 0

    def state_tree(self) -> Dict:
        """{"mu", "nu": the moments as parameter-shaped trees, "count"}."""
        return {"mu": unflatten_params(self.mu), "nu": unflatten_params(self.nu),
                "count": torch.tensor(self.count, dtype=torch.int32)}

    def place_moments(self, opt_shardings) -> None:
        """Re-place the moments by the specs of a state-shaped tree (as
        parallel/mesh.zero1_opt_shardings gives), values kept."""
        flat = dict(tree_leaves(opt_shardings))
        for name, moments in (("mu", self.mu), ("nu", self.nu)):
            for k, m in moments.items():
                spec = flat[f"{name}.{k}"]
                if tuple(spec) + (None,) * (len(m.shape) - len(spec)) != m.spec:
                    dev = next(iter(m.blocks))[0]
                    moments[k] = Sharded.place(m.full(dev), spec, m.mesh)

    def _update(self, mu, nu, g, p) -> list:
        """The moment updates in place and the (decayed) updates, over lists."""
        b1, b2 = self.B1, self.B2
        # optax's order: (1 - b)·g^order + b·moment; bias corrections
        # 1 - b**count in fp32, as optax computes them from an int32 count
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        return upd

    @torch.no_grad()
    def step(self, params: Dict, grads: Dict) -> None:
        """One update of `params`' leaves in place; `grads` by dotted path,
        None for a leaf outside the loss (a zero gradient). Over Sharded
        leaves, `grads[path]` maps each block's (device, block index) to its
        gradient (mesh_loss_and_grads)."""
        leaves = flatten_params(params)
        if list(leaves) != list(self.mu):
            raise ValueError("AdamW.step: the parameter tree is not the one the optimizer was made for")
        self.count += 1
        if self.sharded:
            self._step_sharded(leaves, grads)
            return
        p = list(leaves.values())
        g = [torch.zeros_like(x) if grads.get(k) is None else grads[k] for k, x in leaves.items()]
        upd = self._update(list(self.mu.values()), list(self.nu.values()), g, p)
        del g
        torch._foreach_add_(p, upd, alpha=-self.lr)

    def _step_sharded(self, leaves: Dict[str, Sharded], grads: Dict) -> None:
        mu, nu, g, p_own, targets = [], [], [], [], []
        for path, param in leaves.items():
            gp = grads.get(path) or {}
            copies = {}  # param block -> [(device, tensor)], in mesh order
            for (dev, bidx), t in param.blocks.items():
                copies.setdefault(bidx, []).append((dev, t))
            m_mu, m_nu = self.mu[path], self.nu[path]
            holders = {}  # moment block -> its devices
            for dev, mb in m_mu.blocks:
                holders.setdefault(mb, []).append(dev)
            for (dev, mb), mu_t in m_mu.blocks.items():
                pb, sub = _param_region(param, m_mu, mb)
                parts = [gp.get((d, pb)) for d, _ in copies[pb]]
                parts = [x[sub].to(dev) for x in parts if x is not None]
                grad = parts[0] if parts else torch.zeros_like(mu_t)
                for x in parts[1:]:
                    grad = grad + x
                own = dict(copies[pb])[dev]
                mu.append(mu_t)
                nu.append(m_nu.blocks[(dev, mb)])
                g.append(grad)
                p_own.append(own[sub])
                # the copies this block updates: its own device's, and those
                # on devices that hold no block of this region
                targets.append([(d, t[sub]) for d, t in copies[pb]
                                if d == dev or (d not in holders[mb] and holders[mb][0] == dev)])
        upd = self._update(mu, nu, g, p_own)
        del g
        views, moved = [], []
        for u, tg in zip(upd, targets):
            for d, view in tg:
                views.append(view)
                moved.append(u.to(d))
        torch._foreach_add_(views, moved, alpha=-self.lr)


def _param_region(param: Sharded, moment: Sharded, mb):
    """The parameter block that holds moment block `mb`, and `mb`'s slices
    within it."""
    pb, sub = [], []
    for i, sl in enumerate(moment.block_slices(mb)):
        size = param.shape[i] // param.chunks(i)
        b = sl.start // size
        pb.append(b)
        sub.append(slice(sl.start - b * size, sl.stop - b * size))
    return tuple(pb), tuple(sub)


def _detached(tree):
    return unflatten_params({k: v.detach() for k, v in flatten_params(tree).items()})


def _check_fp32(params: Dict) -> None:
    for key, p in flatten_params(params).items():
        if p.dtype != torch.float32:
            raise ValueError(f"training keeps fp32 master parameters; {key} is {p.dtype} "
                             "(init_imagebind / params_from_jax with dtype=torch.float32)")


def _master(params: Dict) -> Dict:
    """Check that every leaf is an fp32 master and make it a grad leaf."""
    _check_fp32(params)
    for p in flatten_params(params).values():
        p.requires_grad_(True)
    return params


def init_train_state(cfg: ImageBindConfig, device: DeviceLike = None, learning_rate: float = 1e-5,
                     weight_decay: float = 0.01, seed: int = 0, params: Optional[Dict] = None,
                     mesh: Optional[Mesh] = None, zero1: bool = False) -> Tuple[Dict, AdamW]:
    """(params, optimizer): fp32 master parameters on `device` (CUDA unless
    the caller asks for the CPU) from init_imagebind's seeded
    torch.Generator, or the caller's `params` (fp32 leaves, such as
    params_from_jax(..., dtype=torch.float32) gives) made grad leaves in
    place; and AdamW with optax.adamw's semantics.

    With a `mesh` the parameters are made on its first device and placed by
    param_shardings as Sharded grad leaves (the caller's `params` are
    copied); zero1=True splits the moments over "data" as well
    (zero1_shardings), which needs a mesh."""
    if mesh is None:
        if zero1:
            raise ValueError("ZeRO-1 splits the moments over a mesh's data axis: pass mesh=")
        dev = resolve_device(device)
        if params is None:
            params = init_imagebind(cfg, dev, dtype=torch.float32, seed=seed)
        params = _master(params)
        return params, AdamW(params, learning_rate, weight_decay=weight_decay)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    dev = resolve_device(mesh.devices.flat[0])
    if params is None:
        params = init_imagebind(cfg, dev, dtype=torch.float32, seed=seed)
    _check_fp32(params)
    sharded = shard_tree(params, param_shardings(params, mesh), mesh, requires_grad=True)
    specs = zero1_shardings(params, mesh) if zero1 else None
    return sharded, AdamW(sharded, learning_rate, weight_decay=weight_decay, moment_specs=specs)


def make_train_step(cfg: ImageBindConfig, optimizer: AdamW, dtype=torch.bfloat16, mesh: Optional[Mesh] = None,
                    opt_shardings=None):
    """step(params, images, tokens) -> metrics: forward, backward and one
    optimizer update of `params` in place. images (B, 3, S, S) float and
    tokens (B, T) int, tensors or arrays, go to the parameters' device — or
    with a `mesh`, split over its batch shards (B must divide). On a mesh,
    `opt_shardings` (parallel/mesh.zero1_opt_shardings of the optimizer's
    state_tree) re-places the moments there first, as JAX pins them."""
    if mesh is None:
        if opt_shardings is not None:
            raise ValueError("opt_shardings places the moments on a mesh: pass mesh=")

        def step(params: Dict, images, tokens) -> Dict[str, torch.Tensor]:
            dev = next(iter(flatten_params(params).values())).device
            metrics, grads = loss_and_grads(params, torch.as_tensor(images, device=dev),
                                            torch.as_tensor(tokens, device=dev), cfg, dtype)
            optimizer.step(params, grads)
            return metrics

        return step
    if not optimizer.sharded:
        raise ValueError("a mesh step needs the state of init_train_state(mesh=...)")
    if opt_shardings is not None:
        optimizer.place_moments(opt_shardings)

    def mesh_step(params: Dict, images, tokens) -> Dict[str, torch.Tensor]:
        metrics, grads = mesh_loss_and_grads(params, images, tokens, cfg, mesh, dtype)
        optimizer.step(params, grads)
        return metrics

    return mesh_step


def loss_and_grads(params: Dict, images: torch.Tensor, tokens: torch.Tensor, cfg: ImageBindConfig,
                   dtype=torch.bfloat16) -> Tuple[Dict[str, torch.Tensor], Dict[str, Optional[torch.Tensor]]]:
    """(detached metrics of `contrastive_loss`, {dotted path: gradient})
    over the leaves that require grad; None marks a leaf outside the loss
    (the audio tower)."""
    leaves = {k: p for k, p in flatten_params(params).items() if p.requires_grad}
    _, metrics = contrastive_loss(params, images, tokens, cfg, dtype)
    grads = torch.autograd.grad(metrics["loss"], list(leaves.values()), allow_unused=True)
    return {k: v.detach() for k, v in metrics.items()}, dict(zip(leaves, grads))


def mesh_loss_and_grads(params: Dict, images, tokens, cfg: ImageBindConfig, mesh: Mesh, dtype=torch.bfloat16,
                        loss_fn=None):
    """(detached metrics, {path: {(device, block index): gradient}}) of
    `loss_fn(params, images, tokens, cfg, mesh, dtype)` (default
    contrastive_loss_mesh) over every block of a tree of Sharded leaves; a
    block outside the loss has None."""
    _, metrics = (loss_fn or contrastive_loss_mesh)(params, images, tokens, cfg, mesh, dtype)
    return {k: v.detach() for k, v in metrics.items()}, sharded_grads(metrics["loss"], params)


def sharded_grads(loss: torch.Tensor, params) -> Dict[str, Dict]:
    """{path: {(device, block index): d loss / d block}} over the Sharded
    leaves of `params`."""
    keys, blocks = [], []
    for path, leaf in flatten_params(params).items():
        for key, t in leaf.blocks.items():
            if t.requires_grad:
                keys.append((path, key))
                blocks.append(t)
    grads = torch.autograd.grad(loss, blocks, allow_unused=True)
    out: Dict[str, Dict] = {}
    for (path, key), g in zip(keys, grads):
        out.setdefault(path, {})[key] = g
    return out


# ---------------------------------------------------------------------------
# dp × pp × tp × sp: the vision tower as a GPipe pipeline
# ---------------------------------------------------------------------------


def _mesh_params(cfg: ImageBindConfig, mesh: Mesh, seed: int, params: Optional[Dict]) -> Dict:
    """fp32 parameters on the mesh's first device (CUDA unless the mesh is
    of CPU devices)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    dev = resolve_device(mesh.devices.flat[0])
    if params is None:
        params = init_imagebind(cfg, dev, dtype=torch.float32, seed=seed)
    _check_fp32(params)
    return params


def init_train_state_pp(cfg: ImageBindConfig, mesh: Mesh, learning_rate: float = 1e-5, weight_decay: float = 0.01,
                        seed: int = 0, params: Optional[Dict] = None) -> Tuple[Dict, AdamW]:
    """Train state for the dp×pp×tp×sp step on a ("data", "pipe", "model")
    mesh: (state_params, optimizer), state_params = {"base": the parameters
    without the vision blocks, placed by param_shardings; "blocks": the
    vision blocks in the pipeline layout (parallel/megatron: (S, L/S, ...)
    leaves, qkv split for head sharding), stage-sharded over "pipe" and
    head-sharded over "model"}; all Sharded grad leaves."""
    params = _mesh_params(cfg, mesh, seed, params)
    staged = megatron.add_stage_axis(megatron.tp_block_layout(params["vision"]["blocks"]), mesh.shape["pipe"])
    staged = megatron.place_tp_params(staged, mesh, staged=True, requires_grad=True)
    base = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
    del base["vision"]["blocks"]
    base = shard_tree(base, param_shardings(base, mesh), mesh, requires_grad=True)
    state = {"base": base, "blocks": staged}
    return state, AdamW(state, learning_rate, weight_decay=weight_decay)


def contrastive_loss_pp(state: Dict, images, tokens, cfg: ImageBindConfig, mesh: Mesh, dtype=torch.bfloat16,
                        n_micro: int = 2, remat: bool = False):
    """contrastive_loss with the vision tower as the GPipe pipeline
    (megatron.vision_forward_pp) and the text tower tensor-parallel, as
    JAX's make_train_step_pp computes it."""
    v = megatron.vision_forward_pp(state["base"], state["blocks"], images, cfg, mesh, n_micro=n_micro,
                                   dtype=dtype, remat=remat)
    t = text_forward_mesh(state["base"], tokens, cfg, mesh, dtype)
    return info_nce(v, t.to(v.device))


def make_train_step_pp(cfg: ImageBindConfig, mesh: Mesh, optimizer: AdamW, n_micro: int = 2, dtype=torch.bfloat16,
                       remat: bool = False):
    """step(state, images, tokens) -> metrics of the contrastive step whose
    vision tower runs as the GPipe pipeline (dp × pp × tp × sp) and text
    tower tensor-parallel; autograd runs the mirrored pipeline backward."""

    def loss_fn(state, images, tokens, cfg_, mesh_, dtype_):
        return contrastive_loss_pp(state, images, tokens, cfg_, mesh_, dtype_, n_micro=n_micro, remat=remat)

    def step(state: Dict, images, tokens) -> Dict[str, torch.Tensor]:
        metrics, grads = mesh_loss_and_grads(state, images, tokens, cfg, mesh, dtype, loss_fn=loss_fn)
        optimizer.step(state, grads)
        return metrics

    return step


# ---------------------------------------------------------------------------
# dp × ep: the Switch-MoE adapter over the frozen towers
# ---------------------------------------------------------------------------


def init_moe_adapter_state(cfg: ImageBindConfig, mesh: Mesh, n_experts: int, hidden: Optional[int] = None,
                           learning_rate: float = 1e-4, seed: int = 0,
                           params: Optional[Dict] = None) -> Tuple[Dict, AdamW]:
    """(moe_params, optimizer) for the expert-parallel adapter
    (parallel/moe): a residual Switch-MoE FFN over the frozen towers'
    embeddings, its experts split over "model"; made on the mesh's first
    device from a torch.Generator seeded with `seed`, or the caller's fp32
    `params` (init_moe_params' tree). AdamW as optax.adamw(learning_rate)."""
    dev = resolve_device(mesh.devices.flat[0])
    d = cfg.embed_dim
    if params is None:
        g = torch.Generator(device=dev).manual_seed(seed)
        params = pmoe.init_moe_params(d, hidden or 2 * d, n_experts, generator=g)
    moe = pmoe.place_moe_params(params, mesh, requires_grad=True)
    return moe, AdamW(moe, learning_rate)


def make_train_step_moe(frozen_params: Dict, cfg: ImageBindConfig, mesh: Mesh, optimizer: AdamW,
                        balance_coef: float = 0.01, dtype=torch.bfloat16):
    """step(moe_params, images, tokens) -> metrics of the contrastive step
    for the MoE adapter: the towers run frozen (no gradient, torch.no_grad)
    through the kernels, data-parallel over the batch shards with the
    frozen weights copied once to each device; the vision embeddings pass
    through the residual expert-parallel FFN and only the adapter trains.

    Each embedding is one routing token: the (B, D) batch reshapes to
    (B/mp, mp, D), so tokens split over the whole mesh (batch over "data",
    the mp-token axis over "model"). Needs B % (dp·mp) == 0. The Switch
    load-balance aux joins the loss; metrics also carry "balance" and
    "dropped" (tokens past capacity)."""
    mp = mesh.shape["model"]
    first = batch_devices(mesh)[0]
    if any(isinstance(v, Sharded) for v in flatten_params(frozen_params).values()):
        frozen_params = unshard_tree(frozen_params, first)
    frozen = replicate(_detached(frozen_params), mesh)

    @torch.no_grad()
    def towers(images, tokens):
        ims, toks = shard_batch(images, mesh), shard_batch(tokens, mesh)
        if ims is None or toks is None:
            raise ValueError(f"batch {images.shape[0]} does not split over the mesh's batch shards")
        v = [vision_forward(frozen[x.device], x, cfg, dtype) for x in ims]
        t = [text_forward(frozen[x.device], x, cfg, dtype) for x in toks]
        return gather(v, first).float(), gather(t, first).float()

    def loss_fn(moe_params, images, tokens, cfg_, mesh_, dtype_):
        v, t = towers(images, tokens)
        b, d = v.shape
        stats = {}
        y, aux = pmoe.moe_block(moe_params, v.reshape(b // mp, mp, d), mesh, dtype=dtype, stats=stats)
        v2 = v + y.reshape(b, d)
        v2 = v2 / torch.clamp(torch.linalg.vector_norm(v2, dim=-1, keepdim=True), min=1e-8)
        loss, metrics = info_nce(v2, t, extra=balance_coef * aux)
        return loss, dict(metrics, balance=aux, dropped=stats["dropped"])

    def step(moe_params: Dict, images, tokens) -> Dict[str, torch.Tensor]:
        metrics, grads = mesh_loss_and_grads(moe_params, images, tokens, cfg, mesh, dtype, loss_fn=loss_fn)
        optimizer.step(moe_params, grads)
        return metrics

    return step
