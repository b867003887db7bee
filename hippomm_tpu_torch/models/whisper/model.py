"""Whisper encoder/decoder in PyTorch with KV-cached greedy and beam decode.

Counterpart of hippomm_tpu/models/whisper/model.py, same architecture and
parameter tree (blocks as a per-layer list instead of depth-stacked leaves):
log-mel input (ops/mel.WhisperMel), two convolutions and a pre-LN encoder
stack, and a decoder whose autoregressive loop runs over static-shape KV
caches. The JAX `lax.scan` over layers is a Python loop; its device
`while_loop` is a host loop that stops once every row has emitted
<|endoftext|> (one device→host read per token). On a mesh the chunk batch's
shards step in lockstep (`greedy_decode_shards`, `beam_decode_shards`), with
one read per token for all of them.

Routing on the card: every encoder block's self-attention goes to K1 (H = 20
fails the K4 gate) and its MLP to K2 (`mlp(cast_out=True)`); the decoder's
causal and cached attention and its fp32-output MLP stay plain PyTorch, as
they stay XLA in the JAX package.

The KV caches are updated in place (the JAX arrays are functional copies);
beam reordering gathers new caches, as JAX's `take` does. The position is
a device tensor that the greedy step advances in place, so on CUDA each
greedy position is one replay of a CUDA graph of the step (`DecodeGraphs`)
instead of ~200 launches from the host; beam search and the CPU step
eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hippomm_tpu_torch.models import layers as L
from hippomm_tpu_torch.models.decode import GraphCache, StepGraph
from hippomm_tpu_torch.utils import timers as tracing


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 2
    heads: int = 20
    ffn: int = 5120
    vocab_size: int = 51866
    max_source_positions: int = 1500  # 30 s of mel frames / 2
    max_target_positions: int = 448
    eps: float = 1e-5
    # special tokens (large-v3 vocab layout)
    bos_token: int = 50258  # <|startoftranscript|>
    eot_token: int = 50257  # <|endoftext|>
    lang_en_token: int = 50259
    task_transcribe_token: int = 50360
    no_timestamps_token: int = 50364


def distil_large_v3_config() -> WhisperConfig:
    return WhisperConfig()


def large_v3_config() -> WhisperConfig:
    """openai/whisper-large-v3: same encoder, full 32-layer decoder."""
    return WhisperConfig(decoder_layers=32)


def tiny_config() -> WhisperConfig:
    """Hermetic tiny variant (matches a tiny-random transformers WhisperModel)."""
    return WhisperConfig(
        n_mels=80,
        d_model=64,
        encoder_layers=2,
        decoder_layers=2,
        heads=4,
        ffn=128,
        vocab_size=256,
        max_source_positions=100,
        max_target_positions=32,
        bos_token=250,
        eot_token=251,
        lang_en_token=252,
        task_transcribe_token=253,
        no_timestamps_token=254,
    )


def get_config(variant: str) -> WhisperConfig:
    if variant == "distil-large-v3":
        return distil_large_v3_config()
    if variant == "large-v3":
        return large_v3_config()
    if variant == "tiny":
        return tiny_config()
    raise ValueError(f"unknown whisper variant: {variant}")


# ---------------------------------------------------------------------------
# Init (random weights from a seed)
# ---------------------------------------------------------------------------


def _init_whisper_block(g, d: int, ffn: int, cross: bool, device, dtype) -> Dict:
    def attn():
        p = {name: L.init_linear(g, d, d, device, dtype)
             for name in ("q_proj", "k_proj", "v_proj", "out_proj")}
        p["k_proj"].pop("bias")  # whisper: k_proj has no bias
        return p

    p = {
        "self_attn": attn(),
        "self_ln": L.init_layer_norm(d, device),
        "mlp": {"fc1": L.init_linear(g, d, ffn, device, dtype),
                "fc2": L.init_linear(g, ffn, d, device, dtype)},
        "final_ln": L.init_layer_norm(d, device),
    }
    if cross:
        p["cross_attn"] = attn()
        p["cross_ln"] = L.init_layer_norm(d, device)
    return p


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper encoder positional embedding (sinusoidal)."""
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_whisper(cfg: WhisperConfig, device, dtype=torch.bfloat16, seed: int = 0,
                 generator: torch.Generator = None) -> Dict:
    """Random init on `device` from `generator` (or one seeded with `seed`),
    with the JAX package's distributions. Linear weights are stored in
    `dtype` (the forward casts them to it anyway); norms, biases,
    embeddings and convolution kernels stay fp32."""
    device = torch.device(device)
    g = generator if generator is not None else torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model

    def normal(shape, std):
        return std * torch.randn(shape, generator=g, device=device)

    return {
        "encoder": {
            "conv1": {"weight": normal((d, cfg.n_mels, 3), 0.02),
                      "bias": torch.zeros((d,), device=device)},
            "conv2": {"weight": normal((d, d, 3), 0.02), "bias": torch.zeros((d,), device=device)},
            "pos_embed": torch.from_numpy(_sinusoids(cfg.max_source_positions, d)).to(device),
            "blocks": [_init_whisper_block(g, d, cfg.ffn, False, device, dtype)
                       for _ in range(cfg.encoder_layers)],
            "ln": L.init_layer_norm(d, device),
        },
        "decoder": {
            "token_embedding": normal((cfg.vocab_size, d), 0.02),
            "pos_embed": normal((cfg.max_target_positions, d), 0.01),
            "blocks": [_init_whisper_block(g, d, cfg.ffn, True, device, dtype)
                       for _ in range(cfg.decoder_layers)],
            "ln": L.init_layer_norm(d, device),
        },
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _whisper_block(p, x, heads, eps, mask=None, dtype=torch.bfloat16, cross_kv=None):
    # residual stream kept in `dtype`; LN statistics stay fp32
    x = x.to(dtype)
    x = x + L.attention(
        p["self_attn"], L.layer_norm(p["self_ln"], x, eps, out_dtype=dtype),
        num_heads=heads, mask=mask, dtype=dtype,
    ).to(dtype)
    if cross_kv is not None:
        x = x + L.attention(
            p["cross_attn"],
            L.layer_norm(p["cross_ln"], x, eps, out_dtype=dtype),
            x_kv=cross_kv,
            num_heads=heads,
            dtype=dtype,
        ).to(dtype)
    x = x + L.mlp(
        p["mlp"], L.layer_norm(p["final_ln"], x, eps, out_dtype=dtype), dtype=dtype,
        cast_out=True,
    ).to(dtype)
    return x


def _conv1d_f32(x: torch.Tensor, p: Dict, stride: int, dtype) -> torch.Tensor:
    """Kernel-3, pad-1 convolution of x (B, T, C) as unfold + one matmul that
    returns fp32 from `dtype` operands (JAX's conv with
    preferred_element_type=float32) → (B, T_out, C_out), bias added."""
    w = p["weight"]  # (C_out, C_in, 3)
    xp = torch.nn.functional.pad(x.to(dtype), (0, 0, 1, 1))
    cols = xp.unfold(1, 3, stride)  # (B, T_out, C_in, 3): flattens as w's (C_in, 3)
    y = L.matmul_f32(cols.reshape(*cols.shape[:2], -1), w.reshape(w.shape[0], -1).to(dtype))
    return y + p["bias"].float()


@torch.no_grad()
def encoder_forward(params: Dict, mel: torch.Tensor, cfg: WhisperConfig, dtype=torch.bfloat16):
    """mel (B, n_mels, T) -> (B, T//2, d) fp32. T must be
    2·max_source_positions for checkpoint-positional parity (pad/trim in the
    caller)."""
    p = params["encoder"]
    x = mel.transpose(1, 2)  # (B, T, n_mels)
    x = L.gelu(_conv1d_f32(x, p["conv1"], 1, dtype))  # kernel 3, stride 1, pad 1
    x = L.gelu(_conv1d_f32(x, p["conv2"], 2, dtype))  # kernel 3, stride 2, pad 1
    x = x + p["pos_embed"][None, : x.shape[1]].float()
    x = x.to(dtype)
    for pb in p["blocks"]:
        x = _whisper_block(pb, x, cfg.heads, cfg.eps, dtype=dtype)
    return L.layer_norm(p["ln"], x, cfg.eps)


# ---------------------------------------------------------------------------
# Decoder with KV cache
# ---------------------------------------------------------------------------


def _proj_heads(p, x, heads, dtype):
    """(B, T, D) -> (B, H, T, hd) through a linear proj (fp32)."""
    y = L.linear(p, x, dtype)
    b, t, d = y.shape
    return y.reshape(b, t, heads, d // heads).transpose(1, 2)


def _logits(p: Dict, x: torch.Tensor, dtype) -> torch.Tensor:
    """Tied output projection: x (..., d) → (..., vocab) fp32."""
    return L.matmul_f32(x.to(dtype), p["token_embedding"].to(dtype))


@torch.no_grad()
def decoder_forward(params: Dict, tokens: torch.Tensor, enc_out: torch.Tensor, cfg: WhisperConfig,
                    dtype=torch.bfloat16):
    """Teacher-forced decoder: tokens (B, T) -> logits (B, T, vocab) fp32."""
    p = params["decoder"]
    t = tokens.shape[1]
    x = p["token_embedding"][tokens.long()].float() + p["pos_embed"][None, :t].float()
    causal = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
    x = x.to(dtype)
    for pb in p["blocks"]:
        x = _whisper_block(pb, x, cfg.heads, cfg.eps, mask=causal, dtype=dtype, cross_kv=enc_out)
    x = L.layer_norm(p["ln"], x, cfg.eps)
    return _logits(p, x, dtype)


def _cross_kv_buffers(cfg: WhisperConfig, b: int, s: int, d: int,
                      device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Buffers for `_cross_kv`: [(kᵀ (b, H, hd, s), v (b, H, s, hd))] fp32,
    one pair per decoder layer."""
    hd = d // cfg.heads
    return [(torch.zeros((b, cfg.heads, hd, s), device=device),
             torch.zeros((b, cfg.heads, s, hd), device=device)) for _ in range(cfg.decoder_layers)]


def _cross_kv(params: Dict, enc_out: torch.Tensor, heads: int, dtype,
              out: List[Tuple[torch.Tensor, torch.Tensor]]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Cross-attention K/V once per layer, written into `out`
    (`_cross_kv_buffers`'): the fp32 upcast of the `dtype` projections,
    contiguous, in the layouts every step's fp32 products take them.
    Returns `out`."""
    for li, pb in enumerate(params["decoder"]["blocks"]):
        k, v = (_proj_heads(pb["cross_attn"][name], enc_out, heads, dtype).to(dtype)
                for name in ("k_proj", "v_proj"))
        out[li][0].copy_(k.transpose(-1, -2))
        out[li][1].copy_(v)
    return out


def _step_layers(params, cfg, x, pos: torch.Tensor, self_k, self_v, xkv, dtype, beam: int = 1):
    """One token (x: (rows, 1, d) fp32) at position `pos` (a 0-d int64
    tensor on x's device) through all decoder layers; writes the new K/V at
    `pos` of the caches self_k/self_v ((L, rows, H, max_len, hd), in
    place). The host never reads `pos`, so one CUDA graph of a step serves
    every position.

    `beam` > 1 declares that rows = B·beam hypothesis rows whose cross K/V
    are per chunk (`_cross_kv`'s, not beam-repeated): the cross
    attention groups a chunk's beam queries against the chunk's single K/V."""
    d = x.shape[-1]
    heads, hd = cfg.heads, d // cfg.heads
    scale = 1.0 / math.sqrt(hd)
    max_len = self_k.shape[3]
    at = pos.reshape(1)
    key_mask = (torch.arange(max_len, device=x.device) <= pos)[None, None, None, :]
    h = x
    for li, pb in enumerate(params["decoder"]["blocks"]):
        hn = L.layer_norm(pb["self_ln"], h, cfg.eps)
        q = _proj_heads(pb["self_attn"]["q_proj"], hn, heads, dtype)
        self_k[li].index_copy_(2, at, _proj_heads(pb["self_attn"]["k_proj"], hn, heads, dtype).to(dtype))
        self_v[li].index_copy_(2, at, _proj_heads(pb["self_attn"]["v_proj"], hn, heads, dtype).to(dtype))
        logits = torch.matmul(q.to(dtype).float(), self_k[li].float().transpose(-1, -2)) * scale
        logits = logits.masked_fill(~key_mask, float("-inf"))
        w = torch.softmax(logits, dim=-1)
        attn = torch.matmul(w.to(dtype).float(), self_v[li].float())
        attn = attn.transpose(1, 2).reshape(h.shape[0], 1, d)
        h = h + L.linear(pb["self_attn"]["out_proj"], attn, dtype)
        # cross-attention against the precomputed fp32 encoder K/V, beam-grouped
        xkt, xv = xkv[li]
        q = _proj_heads(pb["cross_attn"]["q_proj"], L.layer_norm(pb["cross_ln"], h, cfg.eps), heads, dtype)
        rows = q.shape[0]
        qg = q.reshape(rows // beam, beam, heads, 1, hd)
        logits = torch.matmul(qg.to(dtype).float(), xkt[:, None]) * scale
        w = torch.softmax(logits, dim=-1)
        attn = torch.matmul(w.to(dtype).float(), xv[:, None])
        attn = attn.reshape(rows, heads, 1, hd).transpose(1, 2).reshape(rows, 1, d)
        h = h + L.linear(pb["cross_attn"]["out_proj"], attn, dtype)
        h = h + L.mlp(pb["mlp"], L.layer_norm(pb["final_ln"], h, cfg.eps), dtype=dtype)
    return h


def _embed_at(p, tokens, pos: torch.Tensor) -> torch.Tensor:
    at = pos.reshape(1)
    return (p["token_embedding"][tokens.index_select(1, at).long()].float()
            + p["pos_embed"].index_select(0, at)[None].float())


def _next_logits(params, cfg, tokens, pos: torch.Tensor, self_k, self_v, xkv, dtype, beam: int = 1):
    """Process the token at `pos` and return vocab logits for position pos+1."""
    p = params["decoder"]
    x = _step_layers(params, cfg, _embed_at(p, tokens, pos), pos, self_k, self_v, xkv, dtype, beam)
    x = L.layer_norm(p["ln"], x, cfg.eps)
    return _logits(p, x[:, 0], dtype)


def _caches(cfg: WhisperConfig, rows: int, d: int, max_len: int, dtype, device):
    """Self-attention K/V caches, in the compute dtype (every read casts to it)."""
    shape = (cfg.decoder_layers, rows, cfg.heads, max_len, d // cfg.heads)
    return torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device)


def _prefill(params, cfg, tokens, plen: int, pos, self_k, self_v, xkv, dtype, beam: int = 1) -> None:
    """Run the prompt's first plen - 1 tokens through the caches, one at a
    time, from pos 0 on; leaves pos at the prompt's last token."""
    pos.zero_()
    for _ in range(plen - 1):
        _step_layers(params, cfg, _embed_at(params["decoder"], tokens, pos), pos, self_k, self_v, xkv,
                     dtype, beam)
        pos += 1


class _GreedyShard:
    """One shard's greedy decode state on its device, for (B, S, d) encoder
    outputs: the fp32 cross K/V, the self K/V caches, the tokens, which rows
    have finished, their lengths and whether all have (`done`), and `pos`,
    the position of the token the next step reads (a 0-d int64 tensor).
    `start` fills it for one chunk batch and prefills the prompt; `step`
    changes it in place only, so a CUDA graph of one step replays every
    position over the same buffers."""

    def __init__(self, params, cfg: WhisperConfig, enc_shape, max_len: int, dtype, device):
        self.params, self.cfg, self.max_len, self.dtype = params, cfg, max_len, dtype
        b, s, d = enc_shape
        self.xkv = _cross_kv_buffers(cfg, b, s, d, device)
        self.tokens = torch.zeros((b, max_len), dtype=torch.int32, device=device)
        self.self_k, self.self_v = _caches(cfg, b, d, max_len, dtype, device)
        self.finished = torch.zeros((b,), dtype=torch.bool, device=device)
        self.lengths = torch.full((b,), max_len, dtype=torch.int32, device=device)
        self.done = torch.zeros((), dtype=torch.bool, device=device)  # every row finished
        self.pos = torch.zeros((), dtype=torch.int64, device=device)

    def start(self, enc_out: torch.Tensor, prompt: torch.Tensor) -> None:
        plen = prompt.shape[1]
        _cross_kv(self.params, enc_out, self.cfg.heads, self.dtype, self.xkv)
        self.tokens.zero_()
        self.tokens[:, :plen] = prompt.to(device=self.tokens.device, dtype=torch.int32)
        self.self_k.zero_()
        self.self_v.zero_()
        self.finished.zero_()
        self.done.zero_()
        self.lengths.fill_(self.max_len)
        _prefill(self.params, self.cfg, self.tokens, plen, self.pos, self.self_k, self.self_v, self.xkv,
                 self.dtype)

    def step(self) -> torch.Tensor:
        """Write the token at pos + 1 and advance pos; returns the logits
        the token was chosen from."""
        cfg = self.cfg
        logits = _next_logits(self.params, cfg, self.tokens, self.pos, self.self_k, self.self_v,
                              self.xkv, self.dtype)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(self.finished, cfg.eot_token, nxt)
        self.pos += 1
        self.tokens.index_copy_(1, self.pos.reshape(1), nxt[:, None])
        now_done = nxt == cfg.eot_token
        self.lengths.copy_(torch.where(now_done & ~self.finished, self.pos.to(torch.int32), self.lengths))
        self.finished |= now_done
        torch.all(self.finished, out=self.done)
        return logits


class DecodeGraphs:
    """The greedy decode's buffers and, on CUDA, its step's graphs, kept
    across decodes in `_graphs` (models/decode.GraphCache): one entry per
    (shard, device, rows, source length, max_len, dtype), which holds the
    fp32 cross K/V and the self K/V caches, rebuilt when the decoder's
    weights move."""

    def __init__(self):
        self._graphs = GraphCache("asr.graph_captures")

    def get(self, shard: int, params, cfg: WhisperConfig, enc_out: torch.Tensor, max_len: int,
            dtype) -> StepGraph:
        key = (shard, enc_out.device, *enc_out.shape[:2], max_len, dtype)
        return self._graphs.entry(key, enc_out.device, params["decoder"], functools.partial(
            _GreedyShard, params, cfg, enc_out.shape, max_len, dtype, enc_out.device))

    @torch.no_grad()
    def decode(self, shards: Sequence[Tuple[Dict, torch.Tensor, torch.Tensor]], cfg: WhisperConfig,
               max_len: int = 224, dtype=torch.bfloat16) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """`greedy_decode_shards` over this object's entries. A loop that
        replayed graphs counts its positions once as `asr.graph_steps`."""
        plen = shards[0][2].shape[1]
        steps = [self.get(i, p, cfg, e, max_len, dtype) for i, (p, e, _) in enumerate(shards)]
        with contextlib.ExitStack() as held:
            for g, (_, e, pr) in zip(steps, shards):
                held.enter_context(g.held())
                g.start(e, pr)
            stepped = _lockstep(steps, plen, max_len)
            if steps[0].graph is not None:
                tracing.count("asr.graph_steps", stepped)
            # the buffers are the entries': the caller gets copies
            return [(g.state.tokens.clone(), g.state.lengths.clone()) for g in steps]


def _all_finished(shards) -> bool:
    """Every row of every shard finished (each shard's step leaves `done`):
    one device→host read for all shards, on the first shard's device."""
    home = shards[0].done.device
    flag = shards[0].done if len(shards) == 1 else torch.stack([s.done.to(home) for s in shards]).all()
    with tracing.span("asr.read_wait"):
        return bool(flag)


def _lockstep(shards, plen: int, max_len: int) -> int:
    """Step every shard at each position, then read once whether all have
    finished: the exit rule of one decode loop over the whole sharded batch
    (a shard that finished early keeps emitting <|endoftext|>). Each
    position is an `asr.decode_step` span, its read an `asr.read_wait`.
    Returns the number of positions stepped."""
    stepped = 0
    for _ in range(plen, max_len):
        with tracing.span("asr.decode_step"):
            for s in shards:
                s.step()
            finished = _all_finished(shards)
        stepped += 1
        if finished:
            break
    return stepped


def greedy_decode_shards(
    shards: Sequence[Tuple[Dict, torch.Tensor, torch.Tensor]],
    cfg: WhisperConfig,
    max_len: int = 224,
    dtype=torch.bfloat16,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Greedy decode of several shards in lockstep: `shards` holds (params,
    enc_out, prompt) on each shard's device. Returns each shard's (tokens,
    lengths) as greedy_decode does, the loop exiting once every row of
    every shard has emitted <|endoftext|>.

    On CUDA every position replays each shard's CUDA graph of the step,
    captured for this call alone (a synchronise, a warm-up step and a
    capture); a caller that decodes repeatedly keeps a `DecodeGraphs` and
    calls its `decode`, as the transcriber does. Elsewhere the steps run
    eagerly."""
    return DecodeGraphs().decode(shards, cfg, max_len, dtype)


def greedy_decode(
    params: Dict,
    enc_out: torch.Tensor,
    prompt: torch.Tensor,
    cfg: WhisperConfig,
    max_len: int = 224,
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy autoregressive decode. enc_out (B, S, d); prompt (B, P) forced
    decoder ids. Returns (tokens (B, max_len) int32, lengths (B,) int32);
    the loop exits once every row has emitted <|endoftext|>."""
    return greedy_decode_shards([(params, enc_out, prompt)], cfg, max_len, dtype)[0]


class _BeamShard:
    """One shard's beam search state: B chunks × `beam` hypotheses on the
    batch axis of the cached step. It runs eagerly on every device: each
    step gathers the caches by hypothesis into new tensors, which a graph
    over fixed buffers cannot take."""

    def __init__(self, params, enc_out, prompt, cfg: WhisperConfig, max_len: int, beam: int, dtype):
        self.params, self.cfg, self.beam, self.dtype = params, cfg, beam, dtype
        p = params["decoder"]
        bsz, src_len, d = enc_out.shape
        dev = enc_out.device
        self.plen = plen = prompt.shape[1]
        self.bsz, self.rows = bsz, bsz * beam
        neg = -1e30
        self.vocab = p["token_embedding"].shape[0]

        # per chunk, not beam-repeated
        self.xkv = _cross_kv(params, enc_out, cfg.heads, dtype, _cross_kv_buffers(cfg, bsz, src_len, d, dev))
        self.tokens = torch.zeros((self.rows, max_len), dtype=torch.int32, device=dev)
        self.tokens[:, :plen] = prompt.to(device=dev, dtype=torch.int32).repeat_interleave(beam, dim=0)
        self.self_k, self.self_v = _caches(cfg, self.rows, d, max_len, dtype, dev)
        # per chunk: hypothesis 0 starts live, the others at -1e30 so the
        # first expansion fans out
        self.scores = torch.full((bsz, beam), neg, device=dev)
        self.scores[:, 0] = 0.0
        self.finished = torch.zeros((self.rows,), dtype=torch.bool, device=dev)
        self.lengths = torch.full((self.rows,), max_len, dtype=torch.int32, device=dev)

        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        _prefill(params, cfg, self.tokens, plen, self.pos, self.self_k, self.self_v, self.xkv, dtype, beam)

        self.row_base = (torch.arange(bsz, device=dev) * beam)[:, None]
        self.frozen = torch.full((self.vocab,), neg, device=dev)
        self.frozen[cfg.eot_token] = 0.0

    def step(self) -> None:
        cfg, beam, vocab = self.cfg, self.beam, self.vocab
        logits = _next_logits(self.params, cfg, self.tokens, self.pos, self.self_k, self.self_v,
                              self.xkv, self.dtype, beam)
        logprobs = torch.log_softmax(logits, dim=-1)
        logprobs = torch.where(self.finished[:, None], self.frozen[None], logprobs)
        cand = self.scores.reshape(self.rows, 1) + logprobs
        top_s, flat = torch.sort(cand.reshape(self.bsz, beam * vocab), dim=1, descending=True,
                                 stable=True)
        top_s, flat = top_s[:, :beam], flat[:, :beam]
        src = (self.row_base + flat // vocab).reshape(-1)
        tok = (flat % vocab).to(torch.int32).reshape(-1)

        self.tokens = self.tokens[src]
        self.self_k = self.self_k[:, src]
        self.self_v = self.self_v[:, src]
        lengths = self.lengths[src]
        was_done = self.finished[src]
        tok = torch.where(was_done, cfg.eot_token, tok)
        self.pos += 1
        self.tokens.index_copy_(1, self.pos.reshape(1), tok[:, None])
        now_done = tok == cfg.eot_token
        self.lengths = torch.where(now_done & ~was_done, self.pos.to(torch.int32), lengths)
        self.scores = top_s
        self.finished = was_done | now_done
        self.done = self.finished.all()

    def result(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        bsz, beam = self.bsz, self.beam
        tokens = self.tokens.reshape(bsz, beam, -1)
        lengths = self.lengths.reshape(bsz, beam)
        # normalise per generated token including EOT (whose log-prob is in
        # the cumulative score), as faster-whisper ranks
        gen_len = torch.clamp(lengths - self.plen + 1, min=1).float()
        norm = self.scores / gen_len
        order = torch.argsort(-norm, dim=1, stable=True)
        tokens = torch.take_along_dim(tokens, order[:, :, None], dim=1)
        lengths = torch.take_along_dim(lengths, order, dim=1)
        norm = torch.take_along_dim(norm, order, dim=1)
        return tokens, lengths, norm


@torch.no_grad()
def beam_decode_shards(
    shards: Sequence[Tuple[Dict, torch.Tensor, torch.Tensor]],
    cfg: WhisperConfig,
    max_len: int = 224,
    beam: int = 5,
    dtype=torch.bfloat16,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Beam search over several shards in lockstep, as greedy_decode_shards:
    each shard's chunks keep their beams to themselves (no exchange between
    shards), and one read per step says whether every hypothesis of every
    shard has finished. Returns each shard's beam_decode_batch result."""
    states = [_BeamShard(p, e, pr, cfg, max_len, beam, dtype) for p, e, pr in shards]
    _lockstep(states, shards[0][2].shape[1], max_len)
    return [s.result() for s in states]


def beam_decode_batch(
    params: Dict,
    enc_out: torch.Tensor,
    prompt: torch.Tensor,
    cfg: WhisperConfig,
    max_len: int = 224,
    beam: int = 5,
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched beam search: B independent chunks, each with `beam`
    hypotheses, all B·beam rows on the batch axis of the cached step.
    Per-chunk re-ranking is a row-local top-k over beam·V candidates (ties
    to the lower index, as lax.top_k); finished hypotheses only propose EOT
    at zero added score. Stops once every hypothesis has finished.

    Returns (tokens (B, beam, max_len), lengths (B, beam), scores (B, beam))
    sorted per chunk by length-normalised log-prob, best first."""
    return beam_decode_shards([(params, enc_out, prompt)], cfg, max_len, beam, dtype)[0]


def beam_decode(
    params: Dict,
    enc_out: torch.Tensor,
    prompt: torch.Tensor,
    cfg: WhisperConfig,
    max_len: int = 224,
    beam: int = 5,
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-chunk wrapper over beam_decode_batch: enc_out (1, S, d) →
    (tokens (beam, max_len), lengths (beam,), scores (beam,)), best first."""
    tokens, lengths, norm = beam_decode_batch(
        params, enc_out, prompt, cfg, max_len=max_len, beam=beam, dtype=dtype
    )
    return tokens[0], lengths[0], norm[0]
