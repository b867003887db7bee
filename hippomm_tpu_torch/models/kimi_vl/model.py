"""Kimi-VL-A3B-Instruct on the port: MoonViT and its projector, the MLA +
MoE language model, and batched greedy generation through a latent cache.

Compute: matmul weights and activations in the compute dtype (bf16 on the
card), norms, the router, RoPE angles and softmax in fp32, logits in fp32.
  * MoonViT: pre-LN blocks with 2-D RoPE; attention within each image
    through K1 (`ops/flash_attention.flash_mha`); the GELU-tanh MLP
    through K2's tanh instance (`ops/fused_mlp.fused_mlp`), its width
    padded with zero rows to a multiple of 128 once at load (GELU(0) = 0,
    so the result is the same), or K2's plain version where its gate does
    not admit the shape. On the CPU both run their plain versions.
  * Prefill: the unabsorbed MLA through torch's fused causal attention
    (the value heads padded to the query width), several rows of one length
    bucket a forward; it writes each token's 576 latent values (the normed
    512-wide kv latent and the 64 rotated k-rope) into the cache.
  * Decode: the absorbed MLA: W_UK folded into q, the scores and the
    weighted sum taken over the latent cache, W_UV applied after.
  * Routed experts: σ router, top-k of σ + correction bias, the chosen σ
    normalised and scaled; the rows sorted by expert and each expert's
    SwiGLU as one grouped product over all experts (`torch._grouped_mm`,
    per-expert row ends on the device), so the step has no host sync and
    is captured. The CPU path loops over the experts.
Greedy generation: rows in buckets of a power of two up to `max_rows`, and
positions a row in powers of two from 512 up to the row's share,
`cache_slots // rows`, of one latent cache pool that all buckets view, so
the cache's bytes are fixed; a step reads its bucket's positions only.
Each bucket's decode step is a CUDA graph replayed through
`whisper.model.StepGraph`, as Whisper's step. Counts for the tracing ring
are accumulated on the device and read once a loop.
"""

from __future__ import annotations

import contextlib
import math
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hippomm_tpu_torch.models.kimi_vl.config import KimiVLConfig, get_config
from hippomm_tpu_torch.models.kimi_vl.tokenizer import StandInTokenizer
from hippomm_tpu_torch.models.whisper.model import StepGraph
from hippomm_tpu_torch.ops.flash_attention import flash_mha
from hippomm_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_ref, fused_mlp_supported
from hippomm_tpu_torch.ops.matmul import bmm_f32, matmul_f32
from hippomm_tpu_torch.parallel import mesh as pmesh
from hippomm_tpu_torch.utils import timers as tracing
from hippomm_tpu_torch.utils.device import resolve_device

Params = Dict


def hf_config(cfg: KimiVLConfig) -> Dict:
    """The sizes under the published config.json's names (the reference's
    and the benchmark's configuration files' layout)."""
    t, v = cfg.text, cfg.vision
    return {
        "vocab_size": t.vocab_size, "hidden_size": t.hidden, "intermediate_size": t.intermediate,
        "moe_intermediate_size": t.moe_intermediate, "num_hidden_layers": t.layers,
        "num_attention_heads": t.heads, "n_shared_experts": t.n_shared, "n_routed_experts": t.n_routed,
        "num_experts_per_tok": t.topk, "routed_scaling_factor": t.routed_scale,
        "kv_lora_rank": t.kv_lora, "qk_rope_head_dim": t.rope_dim, "qk_nope_head_dim": t.nope_dim,
        "v_head_dim": t.v_dim, "first_k_dense_replace": t.first_dense, "norm_topk_prob": True,
        "rms_norm_eps": t.eps, "rope_theta": t.rope_theta, "max_position_embeddings": t.max_positions,
        "vision_config": {
            "patch_size": v.patch, "hidden_size": v.width, "num_hidden_layers": v.depth,
            "num_attention_heads": v.heads, "intermediate_size": v.mlp,
            "init_pos_emb_height": v.pos_grid, "init_pos_emb_width": v.pos_grid,
            "rope_theta": v.rope_theta, "merge_kernel_size": [v.merge, v.merge],
            "projector_hidden_size": v.projector, "layer_norm_eps": v.eps,
        },
    }


# ------------------------------------------------------------------ weights


def param_shapes(cfg: KimiVLConfig) -> List[Tuple[Tuple, Tuple[int, ...], str]]:
    """(path, shape, kind) of every leaf, kind one of "matmul" (compute
    dtype), "norm" (fp32, near 1), "vector" (fp32 bias or table),
    "router" (fp32) and "score_bias" (fp32, the correction bias)."""
    t, v = cfg.text, cfg.vision
    d, h = t.hidden, t.heads
    out = [(("vision", "patch", "weight"), (v.width, 3 * v.patch * v.patch), "matmul"),
           (("vision", "patch", "bias"), (v.width,), "vector"),
           (("vision", "pos_emb"), (v.pos_grid, v.pos_grid, v.width), "vector")]

    def ln(path, n):
        return [(path + ("weight",), (n,), "norm"), (path + ("bias",), (n,), "vector")]

    def lin(path, n_in, n_out):
        return [(path + ("weight",), (n_out, n_in), "matmul"), (path + ("bias",), (n_out,), "vector")]

    for i in range(v.depth):
        b = ("vision", "blocks", i)
        out += [*ln(b + ("norm0",), v.width), *lin(b + ("qkv",), v.width, 3 * v.width),
                *lin(b + ("proj",), v.width, v.width), *ln(b + ("norm1",), v.width),
                *lin(b + ("fc0",), v.width, v.mlp), *lin(b + ("fc1",), v.mlp, v.width)]
    out += [*ln(("vision", "final_norm"), v.width), *ln(("projector", "pre_norm"), v.width),
            *lin(("projector", "linear_1"), v.projector, v.projector),
            *lin(("projector", "linear_2"), v.projector, d),
            (("embed",), (t.vocab_size, d), "matmul")]
    for i in range(t.layers):
        b = ("layers", i)
        out += [(b + ("input_norm",), (d,), "norm"), (b + ("q_proj",), (h * t.qk_dim, d), "matmul"),
                (b + ("kv_a",), (t.kv_lora + t.rope_dim, d), "matmul"), (b + ("kv_norm",), (t.kv_lora,), "norm"),
                (b + ("kv_b",), (h * (t.nope_dim + t.v_dim), t.kv_lora), "matmul"),
                (b + ("o_proj",), (d, h * t.v_dim), "matmul"), (b + ("post_norm",), (d,), "norm")]
        if i < t.first_dense:
            out += [(b + ("mlp", "gate_up"), (2 * t.intermediate, d), "matmul"),
                    (b + ("mlp", "down"), (d, t.intermediate), "matmul")]
        else:
            e, f, fs = t.n_routed, t.moe_intermediate, t.n_shared * t.moe_intermediate
            out += [(b + ("moe", "router"), (e, d), "router"), (b + ("moe", "bias"), (e,), "score_bias"),
                    (b + ("moe", "gate_up"), (e, 2 * f, d), "matmul"), (b + ("moe", "down"), (e, d, f), "matmul"),
                    (b + ("moe", "shared", "gate_up"), (2 * fs, d), "matmul"),
                    (b + ("moe", "shared", "down"), (d, fs), "matmul")]
    out += [(("norm",), (d,), "norm"), (("lm_head",), (t.vocab_size, d), "matmul")]
    return out


def set_leaf(tree: Dict, path: Tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _listify(tree):
    """Dicts keyed 0..n-1 (blocks, layers) become lists."""
    if isinstance(tree, dict):
        keys = list(tree)
        if keys and all(isinstance(k, int) for k in keys):
            return [_listify(tree[i]) for i in range(len(keys))]
        return {k: _listify(v) for k, v in tree.items()}
    return tree


def init_params(cfg: KimiVLConfig, seed: int = 0, device="cpu", dtype=torch.float32, std: float = 0.02,
                bias_std: float = 0.1) -> Params:
    """Random weights in the published layout, drawn on `device`: matmul
    weights and the token table N(0, std²) in `dtype`; norms 1 + N(0,
    0.05²), biases and the position table N(0, std²), the router N(0, std²)
    and the correction bias N(0, bias_std²), in fp32."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    tree: Dict = {}
    for path, shape, kind in param_shapes(cfg):
        x = torch.randn(shape, generator=g, device=device, dtype=dtype if kind == "matmul" else torch.float32)
        if kind == "norm":
            x.mul_(0.05).add_(1.0)
        else:
            x.mul_(bias_std if kind == "score_bias" else std)
        set_leaf(tree, path, x)
    return _listify(tree)


# ------------------------------------------------------------- small pieces


def _rms(x, w, eps: float, dt):
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w).to(dt)


def _ln(x, p, eps: float, dt):
    return F.layer_norm(x.float(), (x.shape[-1],), p["weight"], p["bias"], eps).to(dt)


def _rotate_pairs(x, cis):
    """Rotate pairs (x[2i], x[2i+1]) by the unit complex cis[..., i], in fp32."""
    xc = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
    return torch.view_as_real(xc * cis).flatten(-2).to(x.dtype)


def _cis(angles: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(angles), angles)


def _pad_rows(w: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    extra = n - w.shape[dim]
    if extra == 0:
        return w.contiguous()
    pad = [0, 0] * (w.dim() - 1 - dim) + [0, extra]
    return F.pad(w, pad).contiguous()


def route(cfg: KimiVLConfig, m: Params, h: torch.Tensor):
    """The router over rows h (N, D): (chosen experts (N, k), their fp32
    weights (N, k)). σ of the fp32 logits; the top k of σ + the correction
    bias are chosen; the weights are σ of the chosen, normalised to sum 1,
    times the routed scale."""
    t = cfg.text
    scores = torch.sigmoid(matmul_f32(h.float(), m["router"]))
    idx = torch.topk(scores + m["bias"], t.topk, dim=-1).indices
    wts = scores.gather(1, idx)
    return idx, wts / wts.sum(dim=-1, keepdim=True) * t.routed_scale


MIN_POSITIONS = 512  # a decode bucket's fewest positions a row


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class KimiVL:
    """Kimi-VL-A3B-Instruct in one process: `caption` and `complete` take
    RGB images and text and return text, through `encode_images` and
    `generate_ids`. `params` in the layout of `init_params` (random from
    `seed` when none are given); the model keeps a compute copy of what
    it reshapes (the ViT's padded MLP, the absorbed MLA's W_UK/W_UV)."""

    def __init__(self, variant: str = "kimi-vl-a3b-instruct", params: Optional[Params] = None,
                 dtype=torch.bfloat16, device=None, seed: int = 0):
        self.variant = variant
        self.cfg: KimiVLConfig = get_config(variant)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"Kimi-VL on CUDA computes in bfloat16 (its grouped expert products), not {dtype}")
        self.dtype = dtype
        if params is None:
            params = init_params(self.cfg, seed, self.device, dtype)
        self.params = params
        self.tok = StandInTokenizer(self.cfg.text.vocab_size, self.cfg.n_special)
        self._w = self._prepare(params)
        t = self.cfg.text
        self._inv_freq = 1.0 / t.rope_theta ** (
            torch.arange(0, t.rope_dim, 2, device=self.device).float() / t.rope_dim)
        self._pool: Optional[torch.Tensor] = None
        self._graphs: Dict[int, StepGraph] = {}
        self._lock = threading.Lock()
        # one entry per decode loop (rows launched, real rows, their prompt
        # lengths and tokens decoded, positions a row, steps, experts hit),
        # for the benchmark's operation and byte counts
        self.loops: deque = deque(maxlen=4096)

    # ---------------------------------------------------------- weights

    def _prepare(self, p: Params) -> Params:
        dt, t, v = self.dtype, self.cfg.text, self.cfg.vision
        fpad = -(-v.mlp // 128) * 128

        def cast(x):
            return x.to(device=self.device, dtype=dt)

        def f32(x):
            return x.to(device=self.device, dtype=torch.float32)

        pv = p["vision"]
        blocks = []
        for b in pv["blocks"]:
            blocks.append({
                "norm0": {k: f32(x) for k, x in b["norm0"].items()},
                "norm1": {k: f32(x) for k, x in b["norm1"].items()},
                "qkv_w": cast(b["qkv"]["weight"]), "qkv_b": cast(b["qkv"]["bias"]),
                "proj_w": cast(b["proj"]["weight"]), "proj_b": cast(b["proj"]["bias"]),
                "fc0_w": _pad_rows(cast(b["fc0"]["weight"]), fpad, 0),
                "fc0_b": _pad_rows(f32(b["fc0"]["bias"]), fpad, 0),
                "fc1_w": _pad_rows(cast(b["fc1"]["weight"]), fpad, 1), "fc1_b": f32(b["fc1"]["bias"]),
            })
        pj = p["projector"]
        vision = {
            "patch_w": cast(pv["patch"]["weight"]), "patch_b": cast(pv["patch"]["bias"]),
            "pos_emb": f32(pv["pos_emb"]), "blocks": blocks,
            "final_norm": {k: f32(x) for k, x in pv["final_norm"].items()},
            "pre_norm": {k: f32(x) for k, x in pj["pre_norm"].items()},
            "l1_w": cast(pj["linear_1"]["weight"]), "l1_b": cast(pj["linear_1"]["bias"]),
            "l2_w": cast(pj["linear_2"]["weight"]), "l2_b": cast(pj["linear_2"]["bias"]),
        }
        layers = []
        for i, lp in enumerate(p["layers"]):
            kvb = cast(lp["kv_b"]).reshape(t.heads, t.nope_dim + t.v_dim, t.kv_lora)
            w = {"input_norm": f32(lp["input_norm"]), "post_norm": f32(lp["post_norm"]),
                 "q_proj": cast(lp["q_proj"]), "kv_a": cast(lp["kv_a"]), "kv_norm": f32(lp["kv_norm"]),
                 "kv_b": cast(lp["kv_b"]), "o_proj": cast(lp["o_proj"]),
                 "w_uk": kvb[:, : t.nope_dim].contiguous(),  # (H, nope, lora)
                 "w_uv_t": kvb[:, t.nope_dim:].transpose(1, 2).contiguous()}  # (H, lora, v)
            if i < t.first_dense:
                w["mlp"] = {"gate_up": cast(lp["mlp"]["gate_up"]), "down": cast(lp["mlp"]["down"])}
            else:
                m = lp["moe"]
                w["moe"] = {"router": f32(m["router"]), "bias": f32(m["bias"]),
                            "gate_up": cast(m["gate_up"]), "down": cast(m["down"]),
                            "shared": {"gate_up": cast(m["shared"]["gate_up"]),
                                       "down": cast(m["shared"]["down"])}}
            layers.append(w)
        return {"vision": vision, "layers": layers, "embed": cast(p["embed"]),
                "norm": f32(p["norm"]), "lm_head": cast(p["lm_head"])}

    # ----------------------------------------------------------- MoonViT

    def _vit(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) normalised, padded pixels -> (B, M, hidden) image tokens."""
        v, dt, w = self.cfg.vision, self.dtype, self._w["vision"]
        bsz, _, hh, ww = pixels.shape
        gh, gw, ps = hh // v.patch, ww // v.patch, v.patch
        n, hd = gh * gw, v.width // v.heads
        cols = pixels.reshape(bsz, 3, gh, ps, gw, ps).permute(0, 2, 4, 1, 3, 5).reshape(bsz, n, -1)
        table = w["pos_emb"]
        if table.shape[:2] != (gh, gw):
            table = F.interpolate(table.permute(2, 0, 1)[None], size=(gh, gw), mode="bicubic",
                                  align_corners=False)[0].permute(1, 2, 0)
        x = (F.linear(cols.to(dt), w["patch_w"], w["patch_b"]).float() + table.reshape(n, v.width)).to(dt)
        freqs = 1.0 / v.rope_theta ** (torch.arange(0, hd, 4, device=x.device)[: hd // 4].float() / hd)
        idx = torch.arange(n, device=x.device)
        angles = torch.stack([torch.outer((idx % gw).float(), freqs), torch.outer((idx // gw).float(), freqs)],
                             dim=-1).flatten(-2)
        cis = _cis(angles)
        scale = 1.0 / math.sqrt(hd)
        for b in w["blocks"]:
            h = _ln(x, b["norm0"], v.eps, dt)
            qkv = F.linear(h, b["qkv_w"], b["qkv_b"]).reshape(bsz, n, 3, v.heads, hd)
            q, k, vv = (t.transpose(1, 2) for t in qkv.unbind(2))
            q = _rotate_pairs(q, cis).contiguous()
            k = _rotate_pairs(k, cis).contiguous()
            o = flash_mha(q, k, vv.contiguous(), scale).transpose(1, 2).reshape(bsz, n, v.width)
            x = x + F.linear(o, b["proj_w"], b["proj_b"])
            h = _ln(x, b["norm1"], v.eps, dt).reshape(bsz * n, v.width)
            mlp = fused_mlp if fused_mlp_supported(*h.shape, b["fc0_w"].shape[0]) else fused_mlp_ref
            x = x + mlp(h, b["fc0_w"], b["fc0_b"], b["fc1_w"], b["fc1_b"], approximate="tanh").reshape(bsz, n, v.width)
        x = _ln(x, w["final_norm"], v.eps, dt)
        m = v.merge
        x = x.reshape(bsz, gh // m, m, gw // m, m, v.width).permute(0, 1, 3, 2, 4, 5).reshape(bsz, -1, m * m, v.width)
        x = _ln(x, w["pre_norm"], v.eps, dt).reshape(bsz, -1, m * m * v.width)
        x = F.gelu(F.linear(x, w["l1_w"], w["l1_b"]).float()).to(dt)
        return F.linear(x, w["l2_w"], w["l2_b"])

    def pixels(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """(H, W, 3) uint8 images of one size -> (B, 3, H', W') on the
        device: scaled to [-1, 1] (mean and std 0.5), zero-padded at the
        right and bottom to a multiple of patch × merge."""
        x = torch.from_numpy(np.stack(images)).to(self.device, non_blocking=True)
        x = x.permute(0, 3, 1, 2).float().div_(127.5).sub_(1.0)
        m = self.cfg.vision.pad_to
        h, w = x.shape[2:]
        return F.pad(x, (0, -w % m, 0, -h % m))

    @torch.no_grad()
    def encode_images(self, images: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """RGB (H, W, 3) uint8 images -> each one's (tokens, hidden) rows in
        the compute dtype, on the device; images of one size go through
        the ViT together, `vision_chunk` a forward (a `vlm.vision` span)."""
        out: List[Optional[torch.Tensor]] = [None] * len(images)
        by_size: Dict[Tuple[int, int], List[int]] = {}
        for i, im in enumerate(images):
            by_size.setdefault(tuple(im.shape[:2]), []).append(i)
        step = self.cfg.vision_chunk
        for idx in by_size.values():
            for lo in range(0, len(idx), step):
                part = idx[lo:lo + step]
                with tracing.span("vlm.vision"):
                    rows = self._vit(self.pixels([images[i] for i in part]))
                for i, r in zip(part, rows):
                    out[i] = r
        return out

    # ------------------------------------------------- the language model

    def _rope(self, pos: torch.Tensor):
        return _cis(pos.float()[..., None] * self._inv_freq)

    def _mlp(self, lw: Params, h: torch.Tensor, stats: Optional[torch.Tensor],
             live: Optional[torch.Tensor] = None) -> torch.Tensor:
        if "mlp" in lw:
            return _swiglu(lw["mlp"], h, self.dtype)
        return self._moe(lw["moe"], h, stats, live) + _swiglu(lw["moe"]["shared"], h, self.dtype).float()

    def _moe(self, m: Params, h: torch.Tensor, stats: Optional[torch.Tensor],
             live: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The routed experts' weighted sum for rows h (N, D), fp32. `stats`
        (3,) int64 on the device gains the experts that got a row, the rows
        routed and the busiest expert's rows, over the rows `live` (N,) bool
        marks (None: every row): a bucket's padding and finished rows are
        computed but counted nowhere."""
        t = self.cfg.text
        k, e, dt = t.topk, t.n_routed, self.dtype
        n = h.shape[0]
        idx, wts = route(self.cfg, m, h)
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        ranked = flat[order]
        xs = h[order // k]
        ends = torch.searchsorted(ranked, torch.arange(1, e + 1, device=h.device))  # each expert's last row + 1
        if h.is_cuda:
            offs = ends.to(torch.int32)
            gu = torch._grouped_mm(xs, m["gate_up"].transpose(1, 2), offs=offs)
            a = (F.silu(gu[:, : t.moe_intermediate].float()) * gu[:, t.moe_intermediate:].float()).to(dt)
            y = torch._grouped_mm(a, m["down"].transpose(1, 2), offs=offs)
        else:
            y = torch.empty((n * k, h.shape[1]), dtype=dt, device=h.device)
            lo = 0
            for j, hi in enumerate(ends.tolist()):
                if hi > lo:
                    y[lo:hi] = _swiglu({"gate_up": m["gate_up"][j], "down": m["down"][j]}, xs[lo:hi], dt)
                lo = hi
        if stats is not None:
            ones = torch.ones_like(flat) if live is None else live[:, None].expand(n, k).reshape(-1).long()
            counts = torch.zeros((e,), dtype=torch.long, device=h.device).index_add_(0, flat, ones)
            stats += torch.stack([(counts > 0).sum(), counts.sum(), counts.max()])
        back = torch.empty_like(y)
        back[order] = y
        return (back.reshape(n, k, -1).float() * wts[..., None]).sum(dim=1)

    def _attn_prefill(self, lw: Params, h: torch.Tensor, cache: torch.Tensor, cis) -> torch.Tensor:
        """Causal MLA over rows h (R, L, D), unabsorbed; writes the rows'
        latents into cache (R, >= L, lora + rope)."""
        t, dt = self.cfg.text, self.dtype
        r, n = h.shape[:2]
        q = F.linear(h, lw["q_proj"]).reshape(r, n, t.heads, t.qk_dim)
        kva = F.linear(h, lw["kv_a"])
        c = _rms(kva[..., : t.kv_lora], lw["kv_norm"], t.eps, dt)
        kpe = _rotate_pairs(kva[..., t.kv_lora:], cis)
        cache[:, :n, : t.kv_lora] = c
        cache[:, :n, t.kv_lora:] = kpe
        kv = F.linear(c, lw["kv_b"]).reshape(r, n, t.heads, t.nope_dim + t.v_dim)
        qpe = _rotate_pairs(q[..., t.nope_dim:], cis[:, None])
        qq = torch.cat([q[..., : t.nope_dim], qpe], dim=-1).transpose(1, 2)
        kk = torch.cat([kv[..., : t.nope_dim], kpe[:, :, None].expand(r, n, t.heads, t.rope_dim)],
                       dim=-1).transpose(1, 2)
        vv = F.pad(kv[..., t.nope_dim:], (0, t.qk_dim - t.v_dim)).transpose(1, 2)
        with _fused_sdpa(h.is_cuda):
            o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, scale=1.0 / math.sqrt(t.qk_dim))
        o = o[..., : t.v_dim].transpose(1, 2).reshape(r, n, t.heads * t.v_dim)
        return F.linear(o, lw["o_proj"])

    def _attn_decode(self, lw: Params, h: torch.Tensor, cache: torch.Tensor, pos: torch.Tensor, cis,
                     past: torch.Tensor) -> torch.Tensor:
        """Absorbed MLA for one token a row: h (R, D) at positions pos (R,)
        over cache (R, P, lora + rope), into which it writes the token's
        latent; `past` (R, 1, P) marks the positions after each row's."""
        t, dt = self.cfg.text, self.dtype
        r = h.shape[0]
        q = F.linear(h, lw["q_proj"]).reshape(r, t.heads, t.qk_dim)
        kva = F.linear(h, lw["kv_a"])
        c = _rms(kva[:, : t.kv_lora], lw["kv_norm"], t.eps, dt)
        kpe = _rotate_pairs(kva[:, t.kv_lora:], cis)
        rows = torch.arange(r, device=h.device)
        cache[rows, pos] = torch.cat([c, kpe], dim=-1)
        q_abs = bmm_f32(q[..., : t.nope_dim].transpose(0, 1), lw["w_uk"]).to(dt)  # (H, R, lora)
        qpe = _rotate_pairs(q[..., t.nope_dim:], cis[:, None])
        qc = torch.cat([q_abs.transpose(0, 1), qpe], dim=-1)  # (R, H, lora + rope)
        scores = bmm_f32(qc, cache.transpose(1, 2)) * (1.0 / math.sqrt(t.qk_dim))  # (R, H, P)
        p = torch.softmax(scores.masked_fill(past, float("-inf")), dim=-1).to(dt)
        o_lat = bmm_f32(p, cache[..., : t.kv_lora]).to(dt)  # (R, H, lora)
        o = bmm_f32(o_lat.transpose(0, 1), lw["w_uv_t"]).to(dt)  # (H, R, v)
        return F.linear(o.transpose(0, 1).reshape(r, t.heads * t.v_dim), lw["o_proj"])

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return matmul_f32(_rms(x, self._w["norm"], self.cfg.text.eps, self.dtype), self._w["lm_head"])

    def prefill(self, embeds: torch.Tensor, lengths: torch.Tensor, cache: torch.Tensor,
                stats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rows of embeddings (R, L, D), right-padded, of `lengths` (R,) ->
        the logits (R, vocab) at each row's last token; writes the rows'
        latents into cache (layers, R, >= L, lora + rope). `stats` counts
        the routes of each row's first `lengths` tokens."""
        t, dt = self.cfg.text, self.dtype
        r, n, d = embeds.shape
        cis = self._rope(torch.arange(n, device=embeds.device))
        live = (torch.arange(n, device=embeds.device)[None] < lengths[:, None]).reshape(-1)
        x = embeds.to(dt)
        for i, lw in enumerate(self._w["layers"]):
            x = x + self._attn_prefill(lw, _rms(x, lw["input_norm"], t.eps, dt), cache[i], cis)
            h = _rms(x, lw["post_norm"], t.eps, dt).reshape(r * n, d)
            x = (x.float() + self._mlp(lw, h, stats, live).reshape(r, n, d)).to(dt)
        last = x[torch.arange(r, device=x.device), lengths - 1]
        return self._logits(last)

    def decode_logits(self, tokens: torch.Tensor, pos: torch.Tensor, cache: torch.Tensor,
                      stats: Optional[torch.Tensor] = None, live: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token a row (R,) at positions pos (R,) through the latent
        cache (layers, R, P, lora + rope) -> logits (R, vocab) for the next.
        `stats` counts the routes of the rows `live` (R,) marks."""
        t, dt = self.cfg.text, self.dtype
        x = self._w["embed"][tokens].to(dt)
        cis = self._rope(pos)
        past = torch.arange(cache.shape[2], device=x.device)[None, None] > pos[:, None, None]
        for i, lw in enumerate(self._w["layers"]):
            x = x + self._attn_decode(lw, _rms(x, lw["input_norm"], t.eps, dt), cache[i], pos, cis, past)
            h = _rms(x, lw["post_norm"], t.eps, dt)
            x = (x.float() + self._mlp(lw, h, stats, live)).to(dt)
        return self._logits(x)

    def embed(self, ids: Sequence[int], image_rows: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        """One row's (L, D) embeddings: the token table's rows, the first
        <|media_pad|> positions replaced by the image rows in order."""
        ids = list(ids)
        x = self._w["embed"][torch.as_tensor(ids, dtype=torch.long).to(self.device, non_blocking=True)]
        if len(image_rows):
            rows = torch.cat(list(image_rows)).to(x.dtype)
            at = [i for i, t in enumerate(ids) if t == self.tok.media_pad][: len(rows)]
            x[torch.as_tensor(at, device=x.device)] = rows
        return x

    # --------------------------------------------------------- generation

    def _cache_pool(self) -> torch.Tensor:
        """The latent cache of every bucket: (layers, cache_slots, lora + rope)."""
        if self._pool is None:
            t = self.cfg.text
            self._pool = torch.zeros((t.layers, self.cfg.cache_slots, t.kv_lora + t.rope_dim),
                                     dtype=self.dtype, device=self.device)
        return self._pool

    def bucket(self, rows: int, positions: int) -> Tuple[int, int]:
        """(rows launched, positions a row) of the bucket that takes `rows`
        rows of up to `positions` positions: powers of two, the positions at
        least MIN_POSITIONS and at most the pool's share of a row."""
        r = min(_next_pow2(rows), self.cfg.max_rows)
        return r, min(max(_next_pow2(positions), MIN_POSITIONS), self.cfg.cache_slots // r)

    def graph_bytes(self) -> int:
        """What the decode holds on the device beyond the weights: the cache
        pool and each bucket's buffers (its graph's pool not included)."""
        held = 0 if self._pool is None else self._pool.numel() * self._pool.element_size()
        for g in self._graphs.values():
            held += g.state.buffer_bytes()
        return held

    def _step_graph(self, rows: int, positions: int) -> StepGraph:
        g = self._graphs.get((rows, positions))
        if g is None:
            weights = tuple(t.data_ptr() for _, t in pmesh.tree_leaves(self._w["layers"]))
            g = self._graphs[rows, positions] = StepGraph(_DecodeState(self, rows, positions), self.device,
                                                          weights, counter="vlm.graph_captures")
        return g

    @torch.no_grad()
    def generate_ids(self, prompts: Sequence[Sequence[int]], images: Sequence[Sequence[torch.Tensor]],
                     max_tokens: int) -> List[List[int]]:
        """Greedy completions of rows of prompt ids, each with its image rows
        for its <|media_pad|> positions: each row's new ids up to
        <|im_end|> (left out) or `max_tokens`. Rows go in groups of one
        bucket, in order of length."""
        out: List[List[int]] = [[] for _ in prompts]
        if max_tokens < 1 or not prompts:
            return out
        order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
        with self._lock:
            lo = 0
            while lo < len(order):
                n = min(self.cfg.max_rows, len(order) - lo)
                while n > 1 and len(prompts[order[lo + n - 1]]) + max_tokens > self.cfg.cache_slots // _next_pow2(n):
                    n = max(1, n // 2)
                part = order[lo:lo + n]
                for i, ids in zip(part, self._generate_group([prompts[i] for i in part],
                                                             [images[i] for i in part], max_tokens)):
                    out[i] = ids
                lo += n
        return out

    def _generate_group(self, prompts, images, max_tokens: int) -> List[List[int]]:
        n = len(prompts)
        r, cap = self.bucket(n, max(len(p) for p in prompts) + max_tokens)
        keep = cap - max_tokens
        if keep < 1:
            raise ValueError(f"max_tokens {max_tokens} leaves no room in {cap} positions")
        prompts = [list(p) for p in prompts]
        for j, p in enumerate(prompts):
            if len(p) > keep:  # the start of a prompt too long for the context is cut off
                if images[j] and self.tok.media_pad in p[: len(p) - keep]:
                    raise ValueError("an image's tokens do not fit the context")
                prompts[j] = p[len(p) - keep:]
        g = self._step_graph(r, cap)
        steps = 0
        with g.held():
            with tracing.span("vlm.prefill"):
                g.start(prompts, images)
            st = g.state
            with tracing.span("vlm.decode"):
                finished = bool(g.done)
                while not finished and steps < max_tokens - 1:
                    with tracing.span("vlm.decode_step"):
                        g.step()
                        steps += 1
                        finished = bool(g.done)
                toks = st.out[:n, :steps + 1].cpu().numpy()
                stats = st.stats.tolist()
        lengths = [len(p) for p in prompts]
        tracing.count("vlm.rows_launched", r * steps)
        tracing.count("vlm.rows_real", n * steps)
        tracing.count("vlm.tokens_prefilled", sum(lengths))
        tracing.count("vlm.tokens_decoded", n * steps)
        if g.graph is not None:
            tracing.count("vlm.graph_steps", steps)
        tracing.count("vlm.experts_hit", stats[0])
        tracing.count("moe.rows_routed", stats[1] + st.prefill_stats[1])
        tracing.count("moe.rows_busiest", stats[2] + st.prefill_stats[2])
        res = []
        for row in toks:
            row = row.tolist()
            res.append(row[: row.index(self.tok.im_end)] if self.tok.im_end in row else row)
        self.loops.append({"rows": r, "real": n, "lengths": lengths, "positions": cap, "steps": steps,
                           "decoded": [len(x) for x in res], "experts_hit": stats[0]})
        return res

    # -------------------------------------------------------------- text

    def _rows(self, text_images: Sequence[Tuple[str, Sequence[np.ndarray]]]):
        """Prompt ids and image rows of each (prompt, images) row, the
        images of all rows through the ViT together."""
        flat = [im for _, ims in text_images for im in ims]
        enc = self.encode_images(flat) if flat else []
        prompts, images, at = [], [], 0
        for text, ims in text_images:
            rows = enc[at:at + len(ims)]
            at += len(ims)
            prompts.append(self.tok.chat_ids(text, [r.shape[0] for r in rows]))
            images.append(rows)
        return prompts, images

    def caption(self, images: Sequence[Optional[np.ndarray]], prompt: str, max_tokens: int = 128) -> List[str]:
        """One caption a key frame, every frame a row of one batched
        generate; a frame that is None gets the reference's placeholder."""
        live = [i for i, im in enumerate(images) if im is not None]
        prompts, rows = self._rows([(prompt, [images[i]]) for i in live])
        ids = self.generate_ids(prompts, rows, max_tokens)
        out = ["[Error processing image]"] * len(images)
        for i, row in zip(live, ids):
            out[i] = self.tok.decode(row)
        return out

    def complete(self, prompt: str, images: Sequence[np.ndarray] = (), max_tokens: int = 512) -> str:
        prompts, rows = self._rows([(prompt, list(images))])
        return self.tok.decode(self.generate_ids(prompts, rows, max_tokens)[0])


def _swiglu(p: Params, h: torch.Tensor, dt) -> torch.Tensor:
    gu = F.linear(h, p["gate_up"])
    f = gu.shape[-1] // 2
    return F.linear((F.silu(gu[..., :f].float()) * gu[..., f:].float()).to(dt), p["down"])


@contextlib.contextmanager
def _fused_sdpa(cuda: bool):
    """On CUDA, torch's fused causal attention only: a long prompt's scores
    must never be materialised."""
    if not cuda:
        yield
        return
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        yield


class _DecodeState:
    """One bucket's greedy decode buffers: `rows` rows over the model's
    cache pool viewed as (layers, rows, positions, lora + rope). `start`
    prefills the prompts into the cache and sets the first tokens; `step`
    changes the buffers in place only (a CUDA graph replays it)."""

    def __init__(self, model: KimiVL, rows: int, positions: int):
        self.model, self.rows, self.positions = model, rows, positions
        dev = model.device
        pool = model._cache_pool()
        self.cache = pool[:, : rows * self.positions].view(pool.shape[0], rows, self.positions, pool.shape[2])
        self.tokens = torch.zeros((rows,), dtype=torch.long, device=dev)
        self.pos = torch.zeros((rows,), dtype=torch.long, device=dev)
        self.at = torch.zeros((1,), dtype=torch.long, device=dev)  # the out column the next step writes
        self.out = torch.zeros((rows, self.positions), dtype=torch.int32, device=dev)
        self.finished = torch.ones((rows,), dtype=torch.bool, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.stats = torch.zeros((3,), dtype=torch.long, device=dev)
        self.prefill_stats = [0, 0, 0]

    def buffer_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.tokens, self.pos, self.at, self.out,
                                                         self.finished, self.done, self.stats))

    def start(self, prompts: Sequence[Sequence[int]], images) -> None:
        m, n = self.model, len(prompts)
        dev = m.device
        lengths = torch.tensor([len(p) for p in prompts], dtype=torch.long)
        first = torch.empty((n,), dtype=torch.long, device=dev)
        pstats = torch.zeros((3,), dtype=torch.long, device=dev)
        per = max(1, m.cfg.prefill_tokens // max(1, int(lengths.max())))
        for lo in range(0, n, per):
            hi = min(n, lo + per)
            width = int(lengths[lo:hi].max())
            emb = torch.zeros((hi - lo, width, m.cfg.text.hidden), dtype=m.dtype, device=dev)
            for j in range(lo, hi):
                emb[j - lo, : len(prompts[j])] = m.embed(prompts[j], images[j])
            ln = lengths[lo:hi].to(dev)
            logits = m.prefill(emb, ln, self.cache[:, lo:hi], pstats)
            first[lo:hi] = logits.argmax(dim=-1)
        self.prefill_stats = pstats.tolist()
        self.tokens.zero_()
        self.tokens[:n] = first
        self.pos.zero_()
        self.pos[:n] = lengths.to(dev)
        self.out.zero_()
        self.out[:, 0] = self.tokens.to(torch.int32)
        self.at.fill_(1)
        self.finished.fill_(True)
        self.finished[:n] = first == m.tok.im_end
        self.done.copy_(self.finished.all())
        self.stats.zero_()

    def step(self) -> torch.Tensor:
        m = self.model
        logits = m.decode_logits(self.tokens, self.pos, self.cache, self.stats, ~self.finished)
        nxt = torch.where(self.finished, m.tok.im_end, logits.argmax(dim=-1))
        self.out.index_copy_(1, self.at, nxt[:, None].to(torch.int32))
        self.finished |= nxt == m.tok.im_end
        self.tokens.copy_(nxt)
        self.pos += 1
        self.at += 1
        torch.all(self.finished, out=self.done)
        return logits
